"""Output writers reproducing the reference's exact on-disk artifacts.

- ``.bet`` / ``.cpn`` history files ("h1" layout, reference
  ``src/xfiles.hpp:13-38``): ``uint32 Mtot`` once, then per thinned record
  ``uint32 iteration`` followed by ``Mtot`` values (float64 betas for .bet,
  int32 components for .cpn), each shard writing its marker slice at offset
  ``S * itemsize`` within the record.
- ``.csv`` chain file (reference ``src/xfiles.cpp:6-47``): fixed-width
  printf rows ``iter, G, sigmaG..., sigmaE, h2, m0_sum, G, K, pi[G*K]``.
- ``.mlma`` association output (reference ``src/bayes.cpp:223-254``): fixed
  123-byte lines ``%20s %8d %8d %20.15f %20.15f %20.15f %20.15f\n``.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_DTYPES = {"f8": np.float64, "i4": np.int32}


class HistoryWriter:
    """Append-style writer for the .bet/.cpn "h1" history layout."""

    def __init__(self, path: str, m_total: int, kind: str):
        if kind not in _DTYPES:
            raise ValueError(f"kind must be one of {list(_DTYPES)}")
        self.path = path
        self.m_total = m_total
        self.dtype = np.dtype(_DTYPES[kind])
        self.itemsize = self.dtype.itemsize
        self._rec = 0
        # Reference deletes then creates EXCL (phenotype.cpp:199-203,172-191).
        if os.path.exists(path):
            os.remove(path)
        with open(path, "wb") as fh:
            fh.write(struct.pack("<I", m_total))

    @classmethod
    def open_existing(cls, path: str, m_total: int, kind: str):
        """Attach to an existing history file without truncating (resume)."""
        w = cls.__new__(cls)
        w.path = path
        w.m_total = m_total
        w.dtype = np.dtype(_DTYPES[kind])
        w.itemsize = w.dtype.itemsize
        size = os.path.getsize(path)
        w._rec = max(0, (size - 4) // (4 + m_total * w.itemsize))
        return w

    def _rec_offset(self, rec: int) -> int:
        return 4 + rec * (4 + self.m_total * self.itemsize)

    def truncate_to(self, n_rec: int) -> None:
        """Drop records past ``n_rec`` (resume from a checkpoint older
        than the file: stale tail rows must not survive)."""
        size = self._rec_offset(n_rec)
        if os.path.exists(self.path) and os.path.getsize(self.path) > size:
            os.truncate(self.path, size)
        self._rec = min(self._rec, n_rec)

    def write_record(self, iteration: int, data: np.ndarray, start: int = 0,
                     rec: int | None = None) -> None:
        """Write one thinned record (or one shard's slice of it).

        ``start`` is the global marker offset of ``data`` (the reference's S).
        """
        if rec is None:
            rec = self._rec
            self._rec += 1
        data = np.ascontiguousarray(data, dtype=self.dtype)
        off = self._rec_offset(rec)
        with open(self.path, "r+b") as fh:
            fh.seek(off)
            fh.write(struct.pack("<I", iteration))
            fh.seek(off + 4 + start * self.itemsize)
            data.tofile(fh)


def read_history(path: str, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a .bet/.cpn file -> (iterations (R,), data (R, Mtot)).

    Mirrors the predict-mode reader (reference src/bayes.cpp:39-77): Mtot
    header, record count derived from the file size.
    """
    dtype = np.dtype(_DTYPES[kind])
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        (m_total,) = struct.unpack("<I", fh.read(4))
        rec_bytes = 4 + m_total * dtype.itemsize
        if (size - 4) % rec_bytes != 0:
            raise IOError(f"{path}: size {size} not consistent with Mtot={m_total}")
        n_rec = (size - 4) // rec_bytes
        iters = np.empty(n_rec, dtype=np.uint32)
        data = np.empty((n_rec, m_total), dtype=dtype)
        for r in range(n_rec):
            (iters[r],) = struct.unpack("<I", fh.read(4))
            data[r] = np.fromfile(fh, dtype=dtype, count=m_total)
    return iters, data


def history_mtot(path: str) -> int:
    with open(path, "rb") as fh:
        (m_total,) = struct.unpack("<I", fh.read(4))
    return m_total


def format_csv_record(
    iteration: int,
    sigma_g: np.ndarray,       # (G,)
    sigma_e: float,
    m0_sum: int,
    pi_est: np.ndarray,        # (G, K)
) -> str:
    """One .csv row with the reference's exact printf formats (xfiles.cpp:17-43)."""
    g, k = pi_est.shape
    parts = ["%5d, %4d" % (iteration, len(sigma_g))]
    for v in sigma_g:
        parts.append(", %20.15f" % v)
    sg_sum = float(np.sum(sigma_g))
    parts.append(
        ", %20.15f, %20.15f, %7d, %4d, %2d"
        % (sigma_e, sg_sum / (sigma_e + sg_sum), m0_sum, g, k)
    )
    for i in range(g):
        for j in range(k):
            parts.append(", %20.15f" % pi_est[i, j])
    parts.append("\n")
    return "".join(parts)


def truncate_csv_to(path: str, n_rec: int) -> None:
    """Truncate a .csv chain to its first ``n_rec`` rows by scanning
    newline offsets.  Rows WIDEN once iteration exceeds %5d or m0_sum
    exceeds %7d (faithful to the reference's variable-width positioned
    writes, xfiles.cpp:17-45), so ``n_rec * probed_width`` is not a safe
    truncation point — count actual line ends instead."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as fh:
        data = fh.read()
    pos, count = 0, 0
    while count < n_rec:
        nxt = data.find(b"\n", pos)
        if nxt < 0:
            return                       # fewer complete rows than n_rec
        pos = nxt + 1
        count += 1
    if pos < len(data):
        os.truncate(path, pos)


def write_csv_record(path: str, rec: int, text: str) -> None:
    """Positioned write at rec * len(row) — a FAITHFUL reproduction of
    the reference's `MPI_File_write_at(fh, n_thinned_saved * strlen(buff),
    ...)` (xfiles.cpp:45), including its limitation: rows are
    constant-width only while iteration fits %5d and m0_sum fits %7d
    (~100k recorded iterations); past that both implementations place
    rows at stale offsets.  truncate_csv_to deliberately does NOT share
    this assumption (it scans newlines) so resume stays correct even on
    files the positioned writer has already skewed."""
    mode = "r+b" if os.path.exists(path) else "wb"
    with open(path, mode) as fh:
        fh.seek(rec * len(text))
        fh.write(text.encode())


MLMA_LINE_LEN = 123  # snprintf LLEN-1 (reference src/bayes.cpp:223)


def format_mlma_line(rsid: str, mglo: int, rmglo: int, beta: float,
                     tdist: float, se: float, pval: float) -> str:
    line = "%20s %8d %8d %20.15f %20.15f %20.15f %20.15f\n" % (
        rsid, mglo, rmglo, beta, tdist, se, pval
    )
    # The reference asserts the formatted length fits in 123 chars; ids or
    # values wider than the field would have aborted there too.
    if len(line) != MLMA_LINE_LEN:
        raise ValueError(
            f"mlma line is {len(line)} chars, expected {MLMA_LINE_LEN}: {line!r}"
        )
    return line
