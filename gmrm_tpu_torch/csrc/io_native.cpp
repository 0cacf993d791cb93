// Host I/O library of gmrm_tpu_torch: a multithreaded pread of a .bed
// byte range and a PLINK .phen parser, with a plain C interface bound by
// ctypes (gmrm_tpu_torch/io/native.py).  Host C++ only, no CUDA: it is
// built at first use with the host compiler (ops/_build.host_build), and
// read_bed and read_phen take it by default.
//
// The counterpart of the reference's MPI-IO genotype load
// (src/bayes.cpp:867-900, src/utilities.hpp:29-81) and .phen parser
// (src/phenotype.cpp:587-673).  The C ABI and return codes are those of
// gmrm_tpu's native reader.
//
// The .phen parser gives the NumPy route of io/phen.py (Python's text
// mode, str.split and float) its answer on every input: it parses only
// lines it can read exactly as that route does, and returns -3 for any
// other, which sends the caller to the NumPy route for the whole file.

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <locale.h>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// pread the whole range [off, off+len), looping over short reads.
bool pread_all(int fd, unsigned char* dst, long long off, long long len) {
    long long done = 0;
    while (done < len) {
        ssize_t got = ::pread(fd, dst + done, static_cast<size_t>(len - done),
                              static_cast<off_t>(off + done));
        if (got < 0 && errno == EINTR) continue;
        if (got <= 0) return false;
        done += got;
    }
    return true;
}

// A byte that the NumPy route reads as the native parser does: printable
// ASCII or a tab.  Python's text mode decodes bytes >= 0x80 by the
// locale's encoding and splits on more control bytes (\v, \f, \x1c-\x1f)
// than the parser does, and float() refuses NUL; such lines go back to it.
inline bool plain_byte(unsigned char c) {
    return (c >= 0x20 && c < 0x7f) || c == '\t';
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// Whether s[0, n) is [+-]?(d+(.d*)?|.d+)([eE][+-]?d+)?: a decimal that
// float() reads and strtod reads to the same double.  Hex floats, inf,
// nan and digit underscores are float()'s or strtod's alone.
bool plain_decimal(const char* s, size_t n) {
    size_t i = 0;
    if (i < n && (s[i] == '+' || s[i] == '-')) ++i;
    size_t digits = 0;
    while (i < n && is_digit(s[i])) ++i, ++digits;
    if (i < n && s[i] == '.') {
        ++i;
        while (i < n && is_digit(s[i])) ++i, ++digits;
    }
    if (digits == 0) return false;
    if (i < n && (s[i] == 'e' || s[i] == 'E')) {
        ++i;
        if (i < n && (s[i] == '+' || s[i] == '-')) ++i;
        size_t exp_digits = 0;
        while (i < n && is_digit(s[i])) ++i, ++exp_digits;
        if (exp_digits == 0) return false;
    }
    return i == n;
}

}  // namespace

extern "C" {

// Read nbytes at offset from path into buf using n_threads parallel
// preads (0 = auto: the hardware's threads, at most 16; at least 8 MiB a
// thread).  Returns bytes read, or -errno on failure.
long long gmrm_read_block(const char* path, long long offset,
                          long long nbytes, void* buf, int n_threads) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return -static_cast<long long>(errno);

    if (n_threads <= 0) {
        unsigned hw = std::thread::hardware_concurrency();
        n_threads = hw ? static_cast<int>(hw) : 4;
        if (n_threads > 16) n_threads = 16;
    }
    // Small reads: one thread avoids the spawns.
    const long long kMinPerThread = 8ll << 20;
    long long want = (nbytes + kMinPerThread - 1) / kMinPerThread;
    if (want < n_threads) n_threads = static_cast<int>(want ? want : 1);

    auto* dst = static_cast<unsigned char*>(buf);
    bool ok = true;
    if (n_threads <= 1) {
        ok = pread_all(fd, dst, offset, nbytes);
    } else {
        std::vector<std::thread> workers;
        std::vector<char> results(static_cast<size_t>(n_threads), 1);
        long long chunk = (nbytes + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; ++t) {
            long long begin = static_cast<long long>(t) * chunk;
            long long end = begin + chunk < nbytes ? begin + chunk : nbytes;
            if (begin >= end) continue;
            workers.emplace_back([=, &results] {
                results[t] = pread_all(fd, dst + begin, offset + begin,
                                       end - begin) ? 1 : 0;
            });
        }
        for (auto& w : workers) w.join();
        for (char r : results) ok = ok && (r != 0);
    }
    ::close(fd);
    return ok ? nbytes : -static_cast<long long>(EIO);
}

// Parse a PLINK .phen file ("FID IID value" a line, more columns ignored,
// value a decimal or NA).  Writes values[i] (0 at NA) and isna[i] in
// {0, 1}; returns the number of individuals parsed, or -1 on open
// failure, -2 when there are more than n_max, -3 on a line that is not
// plain: a byte other than printable ASCII or a tab, a '\r' not directly
// before '\n', fewer than three fields, or a value neither NA nor a plain
// decimal (plain_decimal).  Lines of spaces and tabs are skipped.
long long gmrm_parse_phen(const char* path, long long n_max,
                          double* values, unsigned char* isna) {
    static const locale_t c_locale = ::newlocale(LC_ALL_MASK, "C",
                                                 static_cast<locale_t>(0));
    if (!c_locale) return -1;
    FILE* fh = ::fopen(path, "rb");
    if (!fh) return -1;
    // Slurp the file; .phen files are small (tens of MB at biobank scale).
    ::fseek(fh, 0, SEEK_END);
    long size = ::ftell(fh);
    ::fseek(fh, 0, SEEK_SET);
    if (size < 0) {
        ::fclose(fh);
        return -1;
    }
    std::string data(static_cast<size_t>(size), '\0');
    if (size > 0 && ::fread(&data[0], 1, static_cast<size_t>(size), fh) !=
                        static_cast<size_t>(size)) {
        ::fclose(fh);
        return -1;
    }
    ::fclose(fh);

    long long n = 0;
    const char* p = data.c_str();
    const char* const end = p + data.size();
    while (p < end) {
        const char* eol = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!eol) eol = end;
        const char* stop = eol;
        if (eol < end && stop > p && stop[-1] == '\r') --stop;   // CRLF
        // The line's first three fields, split on runs of spaces and tabs.
        const char* field[3] = {nullptr, nullptr, nullptr};
        size_t width[3] = {0, 0, 0};
        int nf = 0;
        const char* q = p;
        while (q < stop) {
            if (*q == ' ' || *q == '\t') {
                ++q;
                continue;
            }
            const char* s = q;
            while (q < stop && *q != ' ' && *q != '\t') {
                if (!plain_byte(static_cast<unsigned char>(*q))) return -3;
                ++q;
            }
            if (nf < 3) {
                field[nf] = s;
                width[nf] = static_cast<size_t>(q - s);
            }
            ++nf;
        }
        p = eol < end ? eol + 1 : end;
        if (nf == 0) continue;
        if (nf < 3) return -3;
        if (n >= n_max) return -2;
        const char* v = field[2];
        if (width[2] == 2 && v[0] == 'N' && v[1] == 'A') {
            isna[n] = 1;
            values[n] = 0.0;
        } else {
            if (!plain_decimal(v, width[2])) return -3;
            // The token ends at a space, a tab, '\r', '\n' or the string's
            // terminating NUL, none of which strtod reads; it rounds
            // correctly, as float() does (overflow to inf, underflow to 0).
            char* conv_end = nullptr;
            values[n] = ::strtod_l(v, &conv_end, c_locale);
            if (conv_end != v + width[2]) return -3;
            isna[n] = 0;
        }
        ++n;
    }
    return n;
}

}  // extern "C"
