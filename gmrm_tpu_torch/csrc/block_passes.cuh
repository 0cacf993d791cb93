// The sweep's two per-block passes over the bed on one column-slice design:
// the residual update (kernel 4, eps_update.cu), the residual dot products
// (kernel 2, block_cdot.cu) and the two fused into one launch
// (update_cdot.cu): block b's update, then block b+1's dot products from the
// updated residual while it is still in shared memory.
//
//   update:  eps[t, k, n] += na[t, k, n] sum_i (d[t, i] a_i[k, n]
//                                               - mave[t, i] d[t, i] b_i[k, n])
//   c-dot:   c[t, i] = msig[t, i] (sum_n a_i[n] eps_t[n]
//                                  - mave[t, i] sum_n b_i[n] eps_t[n])
// over a block's B marker rows rows[i] = blk*B + win[i] (processing order;
// the bed is read in place, never permuted or copied).
//
// One template on the value type V: float for the float32 path, double for
// a --dtype float64 run (kernel B, the float64 side of kernels 2 and 4; the
// JAX package computes it with the XLA einsums of gmrm_tpu/ops/blockops.py:131
// and :141).  Both instantiations run the same plan; at double the slices of
// eps and na, the (d, mave*d) pairs, the reduction buffer and the scratch
// partials are twice the bytes, a 16-byte copy moves 2 values instead of 4,
// and a thread carries the traits MT_F64 at a time (the update's
// acc[MT][4] of doubles in registers), in as many passes over its rows as
// that takes.  The float instantiation carries all T at once up to MAX_T
// traits, as before, and more MAX_T at a time in the same way, so one
// launch takes any T whose slices fit in shared memory (pass_plan; a run
// with more traits than that is launched in trait chunks by the host,
// ops/trait_chunks.py).  A trait's sums are the same in every case: each
// thread adds its rows, or columns, in the same order for every trait.
//
// Bound on the H100: latency at the shapes of the sweep.  A block moves B*mb
// packed bytes (328 KB at the anchor) and one T x 4 x mb residual (164 KB
// in float32, 328 KB in float64); its arithmetic is ~10 M multiply-adds
// (0.31 us at 67 TFLOP/s: float32, or float64 on the FP64 tensor cores).
// Spread over the card that is well under a microsecond, so what a launch
// costs is its round trips to memory and its hand-offs.  So:
//   - CTA s owns the byte columns [s*S, (s+1)*S) across all T traits and 4
//     phase planes; S, a power of two from 16 to 256, is picked on the host
//     (pass_plan in ops/block_kernels.py) so that the grid fills the 132
//     SMs (160 CTAs of 16 columns at the anchor, mb = 2560; 392 of 64 at
//     mb = 25,088) and the fused pass's shared memory fits;
//   - once the block's row indices are in shared memory, everything else a
//     CTA reads is issued at once as cp.async copies into shared memory:
//     every bed row's slice in 32-bit words (16 individuals each), the
//     slice of eps and na in 16-byte pieces.  Each bed byte is read from
//     memory once and decoded in registers (decode.cuh's map, by selects,
//     to exact 0, 1, 2 values);
//   - the update: thread (column c, row part r) sums its rows' share for the
//     4 planes and T traits of column c; the parts are summed in part order
//     in shared memory and eps += na * deps is written once;
//   - the c-dot: thread (row i, column part h) sums a_i.eps and b_i.eps over
//     its columns; the parts are summed in order and each CTA writes its
//     slice's centred partial sa - mave sb (T x B values) to a scratch
//     buffer.  The partials go up a two-level tree in a fixed order, without
//     float atomics, so c is a function of the inputs alone and a chain is
//     reproducible from its seed: the last CTA of each group of GROUP slices
//     to arrive (an int ticket, atom.acq_rel.gpu) sums its group in slice
//     order, the last group to arrive sums the groups in group order and
//     writes c = msig * sum.  Each last arrival resets its counter for the
//     next launch; no CTA ever waits for another.
// With a stamp buffer, thread 0 of every CTA records %globaltimer at the
// events of PASS_STAMPS (ops/block_kernels.py), which split a launch's
// time by phase; without one the kernel records nothing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_T = 8;    // traits a float thread carries at once
constexpr int MT_F64 = 4;   // traits a float64 thread carries at once
constexpr int THREADS = 256;
constexpr int GROUP = 16;   // slices per group of the partials' tree
constexpr int LINE = 32;    // 32-bit words per counter (its own 128 B line)
constexpr int MAX_R = THREADS / 16;  // row parts of the update at most
constexpr int NST = 10;     // %globaltimer stamps per CTA
enum { UPDATE = 1, CDOT = 2 };  // mode bits; UPDATE | CDOT is the fused pass

template <typename V>
struct PassArgs {
  const uint8_t* bed;   // (m_pad, mb)
  const int* rows_u;    // (B,) bed rows of the updated block
  const int* rows_c;    // (B,) bed rows of the dotted block
  const V* d;           // (T, B) msig * dbeta of the updated block
  const V* mave_u;      // (T, B) of the updated block
  const V* mave_c;      // (T, B) of the dotted block
  const V* msig_c;      // (T, B) of the dotted block
  const V* na;          // (T, 4, mb)
  V* eps;               // (T, 4, mb), updated in place by UPDATE
  V* c;                 // (T, B) of the dotted block
  unsigned* scratch;    // counters, then the slices' and groups' partials
  unsigned long long* stamps;  // (grid, NST) or null
  int T, B, mb, S;
  int slog;  // log2(S)
  int vec;  // mb % 4 == 0 and aligned operands: word and 16-byte copies
};

// Shared memory offsets in bytes.
struct PassLayout {
  size_t row, bed_u, bed_c, eps, na, d, red, flag, total;
  int SP;  // bed row stride in bytes: an odd number of words, so the rows
           // that 32 threads read at once lie in 32 banks
  int R;   // row parts of the update (threads per byte column)
  int P;   // column parts of the c-dot (threads per marker row)
};

// es: bytes of a value (4 float, 8 double).
__host__ __device__ inline PassLayout pass_layout(int T, int B, int S,
                                                  int mode, int es) {
  PassLayout L;
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  };
  const bool upd = mode & UPDATE, dot = mode & CDOT;
  const size_t plane = (size_t)T * 4 * S * es;  // the slice of eps or na
  const size_t tb = (size_t)T * B * es;
  L.SP = ((S / 4) % 2 == 0) ? S + 4 : S;
  L.R = S < THREADS ? THREADS / S : 1;
  L.P = B < THREADS ? THREADS / B : 1;
  L.row = take((size_t)(upd + dot) * B * 4);
  L.bed_u = take(upd ? (size_t)B * L.SP : 0);
  L.bed_c = take(dot ? (size_t)B * L.SP : 0);
  L.eps = take(plane);
  L.na = take(upd ? plane : 0);
  L.d = take(upd ? 2 * tb : 0);
  const size_t red_u = upd ? (size_t)L.R * plane : 0;
  const size_t red_c = dot ? (size_t)L.P * 2 * tb : 0;
  L.red = take(red_u > red_c ? red_u : red_c);
  L.flag = take(4);
  L.total = off;
  return L;
}

// Scratch words: the top counter, one counter per group, the slices'
// partials (nslices, T, B), the groups' partials (ngroups, T, B), values
// of es bytes.
__host__ __device__ inline size_t pass_scratch_words(int nslices, int T,
                                                     int B, int es) {
  const int ngroups = (nslices + GROUP - 1) / GROUP;
  return (size_t)(1 + ngroups) * LINE +
         (size_t)(nslices + ngroups) * T * B * (es / 4);
}

template <typename V> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

__device__ __forceinline__ float2 pair_of(float x, float y) {
  return make_float2(x, y);
}
__device__ __forceinline__ double2 pair_of(double x, double y) {
  return make_double2(x, y);
}
__device__ __forceinline__ float vfma(float x, float y, float z) {
  return fmaf(x, y, z);
}
__device__ __forceinline__ double vfma(double x, double y, double z) {
  return fma(x, y, z);
}

// Four consecutive values from shared memory (16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float& x, float& y,
                                      float& z, float& w) {
  const float4 e = *(const float4*)p;
  x = e.x;
  y = e.y;
  z = e.z;
  w = e.w;
}
__device__ __forceinline__ void load4(const double* p, double& x, double& y,
                                      double& z, double& w) {
  const double2 e0 = *(const double2*)p, e1 = *(const double2*)(p + 2);
  x = e0.x;
  y = e0.y;
  z = e1.x;
  w = e1.y;
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The slice of a (T, 4, mb) operand into shared (T*4, S), zeros past mb.
// A 16-byte copy moves E values; with mb % 4 == 0 a piece lies wholly
// before mb or wholly past it.
template <typename V>
__device__ __forceinline__ void stage_planes(const PassArgs<V>& a,
                                             const V* src, V* dst,
                                             int col0) {
  constexpr int E = 16 / sizeof(V);
  constexpr int ELOG = E == 4 ? 2 : 1;
  const int S = a.S, mb = a.mb, np = a.T * 4, sl = a.slog;
  if (a.vec) {
#pragma unroll 1
    for (int y = threadIdx.x; y < np << (sl - ELOG); y += THREADS) {
      const int p = y >> (sl - ELOG), c = E * (y & ((S >> ELOG) - 1));
      V* s = dst + p * S + c;
      if (col0 + c < mb)
        cp_async16(s, src + (size_t)p * mb + col0 + c);
      else
        *(uint4*)s = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll 1
    for (int y = threadIdx.x; y < np << sl; y += THREADS) {
      const int p = y >> sl, c = y & (S - 1);
      dst[y] = col0 + c < mb ? src[(size_t)p * mb + col0 + c] : V(0);
    }
  }
}

// Every row's slice of one block (row indices in shared srow) into shared
// (B, SP) bytes; the pad byte 0x55 (a = b = 0) past mb.
template <typename V>
__device__ __forceinline__ void stage_bed(const PassArgs<V>& a,
                                          const int* srow, uint8_t* dst,
                                          int col0, const PassLayout& L) {
  const int S = a.S, mb = a.mb, B = a.B, sl = a.slog;
  if (a.vec) {
#pragma unroll 1
    for (int x = threadIdx.x; x < B << (sl - 2); x += THREADS) {
      const int i = x >> (sl - 2), c = 4 * (x & ((S >> 2) - 1));
      uint8_t* s = dst + (size_t)i * L.SP + c;
      if (col0 + c < mb)
        cp_async4(s, a.bed + (size_t)srow[i] * mb + col0 + c);
      else
        *(uint32_t*)s = 0x55555555u;
    }
  } else {
#pragma unroll 1
    for (int x = threadIdx.x; x < B << sl; x += THREADS) {
      const int i = x >> sl, c = x & (S - 1);
      dst[(size_t)i * L.SP + c] =
          col0 + c < mb ? a.bed[(size_t)srow[i] * mb + col0 + c] : 0x55;
    }
  }
}

// sum_{m < n} src[m * stride] in index order, GROUP loads in flight at a
// time (a loop of dependent loads would wait out each one's L2 latency).
// Plain, unpredicated loads (a load past n rereads the last partial and is
// not added), which the compiler issues together; __ldcg's strong loads,
// or loads under a predicate, it issued one after another, each waiting
// for the one before.  The partials were written by other CTAs of this
// launch and released to this one by the atomic that thread 0 acquired
// before the barrier, which also invalidated this SM's L1.
template <typename V>
__device__ __forceinline__ V sum_in_order(const V* src, int n,
                                          size_t stride) {
  V s = V(0);
#pragma unroll 1
  for (int m0 = 0; m0 < n; m0 += GROUP) {
    V v[GROUP];
#pragma unroll
    for (int m = 0; m < GROUP; ++m)
      v[m] = src[(size_t)min(m0 + m, n - 1) * stride];
#pragma unroll
    for (int m = 0; m < GROUP; ++m)
      if (m0 + m < n) s += v[m];
  }
  return s;
}

// decode.cuh's map with V results, by comparisons and selects: no
// int-to-float conversion, which issues at a quarter of the FMA rate.
template <typename V>
__device__ __forceinline__ void decode_f(uint32_t byte, int k, V& a, V& b) {
  const uint32_t c = (byte >> (2 * k)) & 3u;
  b = c != 1u ? V(1) : V(0);
  a = c == 0u ? V(2) : (c == 2u ? V(1) : V(0));
}

// MT: traits a thread carries at once.  MULTI false (float, T <= MT): one
// pass; MULTI (double: MT = MT_F64; float above MAX_T: MT = MAX_T):
// ceil(T / MT) passes over the thread's rows or columns.
template <typename V, int MT, int MODE, bool MULTI>
__global__ void __launch_bounds__(THREADS) block_passes_kernel(
    const PassArgs<V> a) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr bool UPD = MODE & UPDATE, DOT = MODE & CDOT;
  using V2 = typename Pair<V>::type;
  const int T = a.T, B = a.B, S = a.S, mb = a.mb;
  const PassLayout L = pass_layout(T, B, S, MODE, sizeof(V));
  const int nch = MULTI ? (T + MT - 1) / MT : 1;
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * S;
  const int ncol = min(S, mb - col0);
  int* srow = (int*)(sm + L.row);
  V* seps = (V*)(sm + L.eps);
  V* sna = (V*)(sm + L.na);
  V2* sdm = (V2*)(sm + L.d);   // (T, B) pairs (d, mave * d)
  V* sred = (V*)(sm + L.red);
  auto stamp = [&](int e) {
    if (a.stamps != nullptr && tid == 0)
      a.stamps[(size_t)blockIdx.x * NST + e] = global_ns();
  };
  stamp(0);

  // ---- staging: the row indices first (the bed copies need them), then
  // every other copy and load of the launch in flight at once.
#pragma unroll 1
  for (int x = tid; x < (UPD + DOT) * B; x += THREADS)
    srow[x] = (UPD && x < B) ? a.rows_u[x] : a.rows_c[x - (UPD ? B : 0)];
  if (UPD) stage_planes(a, a.na, sna, col0);
  __syncthreads();
  stamp(1);
  if (UPD) stage_bed(a, srow, sm + L.bed_u, col0, L);
  if (DOT) stage_bed(a, srow + (UPD ? B : 0), sm + L.bed_c, col0, L);
  stage_planes(a, a.eps, seps, col0);
  if (UPD) {
#pragma unroll 1
    for (int x = tid; x < T * B; x += THREADS) {
      const V dv = a.d[x];
      sdm[x] = pair_of(dv, a.mave_u[x] * dv);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  stamp(2);

  // ---- the update: thread (column c, row part r) -------------------------
  if (UPD) {
    const uint8_t* sbed = sm + L.bed_u;
    const int R = L.R;
    const int rw = (B + R - 1) / R;
#pragma unroll 1
    for (int x = tid; x < S * R; x += THREADS) {
      const int c = x & (S - 1), r = x >> a.slog;
      const int i1 = min(B, (r + 1) * rw);
#pragma unroll 1
      for (int ch = 0; ch < nch; ++ch) {
        const int t0 = ch * MT;
        V acc[MT][4];
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[t][k] = V(0);
#pragma unroll 2
        for (int i = r * rw; i < i1; ++i) {
          const uint32_t byte = sbed[(size_t)i * L.SP + c];
          V af[4], bf[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) decode_f(byte, k, af[k], bf[k]);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            if (t0 + t < T) {
              const V2 dm = sdm[(t0 + t) * B + i];
              const V dv = dm.x, mdv = dm.y;
#pragma unroll
              for (int k = 0; k < 4; ++k)
                acc[t][k] = vfma(-mdv, bf[k], vfma(dv, af[k], acc[t][k]));
            }
          }
        }
#pragma unroll
        for (int t = 0; t < MT; ++t)
          if (t0 + t < T)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              sred[((size_t)r * T * 4 + (t0 + t) * 4 + k) * S + c] =
                  acc[t][k];
      }
    }
    __syncthreads();
    stamp(3);
    // The parts in part order; eps written once (and kept for the c-dot).
#pragma unroll 1
    for (int y = tid; y < T * 4 * S; y += THREADS) {
      V v[MAX_R];
#pragma unroll
      for (int r = 0; r < MAX_R; ++r)
        v[r] = r < R ? sred[(size_t)r * T * 4 * S + y] : V(0);
      V s = v[0];
#pragma unroll
      for (int r = 1; r < MAX_R; ++r)
        if (r < R) s += v[r];
      const V e = seps[y] + sna[y] * s;
      const int p = y >> a.slog, c = y & (S - 1);
      if (DOT) seps[y] = e;
      if (c < ncol) a.eps[(size_t)p * mb + col0 + c] = e;
    }
    if (!DOT) {
      stamp(4);
      return;
    }
    __syncthreads();
    stamp(4);
  }

  // ---- the c-dot: thread (row i, column part h) --------------------------
  const uint8_t* sbed = sm + L.bed_c;
  const int P = L.P;
  const int cw = ((S + P - 1) / P + 3) & ~3;   // columns a part, words
#pragma unroll 1
  for (int x = tid; x < B * P; x += THREADS) {
    const int i = x % B, h = x / B;
    const int c1 = min(S, (h + 1) * cw);
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const int t0 = ch * MT;
      V sa[MT], sb[MT];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        sa[t] = V(0);
        sb[t] = V(0);
      }
#pragma unroll 1
      for (int c = h * cw; c < c1; c += 4) {
        const uint32_t word =
            *(const uint32_t*)(sbed + (size_t)i * L.SP + c);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          V af[4], bf[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            decode_f(word >> (8 * q), k, af[q], bf[q]);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            if (t0 + t < T) {
              V ex, ey, ez, ew;
              load4(seps + ((t0 + t) * 4 + k) * S + c, ex, ey, ez, ew);
              sa[t] = vfma(af[3], ew, vfma(af[2], ez, vfma(af[1], ey,
                           vfma(af[0], ex, sa[t]))));
              sb[t] = vfma(bf[3], ew, vfma(bf[2], ez, vfma(bf[1], ey,
                           vfma(bf[0], ex, sb[t]))));
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t0 + t < T) {
          sred[((size_t)h * 2 * T + 2 * (t0 + t)) * B + i] = sa[t];
          sred[((size_t)h * 2 * T + 2 * (t0 + t) + 1) * B + i] = sb[t];
        }
      }
    }
  }
  __syncthreads();
  stamp(5);

  // The slice's centred partial, then the tree.
  const int TB = T * B;
  const int nslices = gridDim.x;
  const int ngroups = (nslices + GROUP - 1) / GROUP;
  const int g = blockIdx.x / GROUP;
  const int gsize = min(GROUP, nslices - g * GROUP);
  unsigned* top = a.scratch;
  unsigned* gcount = a.scratch + (size_t)(1 + g) * LINE;
  V* part = (V*)(a.scratch + (size_t)(1 + ngroups) * LINE);
  V* gpart = part + (size_t)nslices * TB;
  int& last = *(int*)(sm + L.flag);
  V* mine = part + (size_t)blockIdx.x * TB;
#pragma unroll 1
  for (int o = tid; o < TB; o += THREADS) {
    const int t = o / B, i = o % B;
    V s_a = sred[(2 * t) * B + i], s_b = sred[(2 * t + 1) * B + i];
#pragma unroll 1
    for (int h = 1; h < P; ++h) {
      s_a += sred[((size_t)h * 2 * T + 2 * t) * B + i];
      s_b += sred[((size_t)h * 2 * T + 2 * t + 1) * B + i];
    }
    mine[o] = s_a - a.mave_c[o] * s_b;
  }
  __syncthreads();
  if (tid == 0) {
    const bool is_last = atom_add_acq_rel(gcount, 1) == (unsigned)gsize - 1;
    if (is_last) *gcount = 0;
    last = is_last;
  }
  __syncthreads();
  stamp(6);
  if (!last) return;
  const V* src = part + (size_t)g * GROUP * TB;
#pragma unroll 1
  for (int o = tid; o < TB; o += THREADS) {
    const V s = sum_in_order(src + o, gsize, TB);
    if (ngroups == 1)
      a.c[o] = a.msig_c[o] * s;
    else
      gpart[(size_t)g * TB + o] = s;
  }
  stamp(7);
  if (ngroups == 1) return;
  __syncthreads();
  if (tid == 0) {
    const bool is_last = atom_add_acq_rel(top, 1) == (unsigned)ngroups - 1;
    if (is_last) *top = 0;
    last = is_last;
  }
  __syncthreads();
  if (!last) return;
  stamp(8);
#pragma unroll 1
  for (int o = tid; o < TB; o += THREADS)
    a.c[o] = a.msig_c[o] * sum_in_order(gpart + o, ngroups, TB);
  stamp(9);
}

// One launch on ceil(mb / S) CTAs.  Refuses T < 1, an S that is not a power
// of two of at least 16, and a layout beyond the card's shared memory.
template <typename V, int MODE>
int launch_block_passes(PassArgs<V> a, cudaStream_t stream) {
  if (a.T < 1 || a.B < 1 || a.mb < 1 || a.S < 16 || (a.S & (a.S - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  a.slog = 0;
  while ((1 << a.slog) < a.S) ++a.slog;
  const uintptr_t al16 = (uintptr_t)a.eps | (uintptr_t)a.na;
  a.vec = a.mb % 4 == 0 && (uintptr_t)a.bed % 4 == 0 && al16 % 16 == 0;
  const PassLayout L = pass_layout(a.T, a.B, a.S, MODE, sizeof(V));
  void (*kernel)(const PassArgs<V>);
  if constexpr (sizeof(V) == 8)
    kernel = &block_passes_kernel<V, MT_F64, MODE, true>;
  else
    kernel = a.T <= 4       ? &block_passes_kernel<V, 4, MODE, false>
             : a.T <= MAX_T ? &block_passes_kernel<V, MAX_T, MODE, false>
                            : &block_passes_kernel<V, MAX_T, MODE, true>;
  if (L.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L.total);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (a.mb + a.S - 1) / a.S;
  kernel<<<grid, THREADS, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
