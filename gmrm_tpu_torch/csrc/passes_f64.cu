// Float64 residual passes of the exact serial (W=1) sweep on a
// --dtype float64 run (kernel B): for the marker rows rows[j] of one block,
//   c-dot:   c[t, j] = msig[t, j] * (sum_n a_j[n] eps_t[n]
//                                    - mave[t, j] * sum_n b_j[n] eps_t[n])
//   update:  target_t[n] += na_t[n] * sum_j (d[t, j] a_j[n]
//                                            - (mave[t, j] d[t, j]) b_j[n])
// with target the residual itself (one device) or a zeroed delta (a
// marker-sharded run), all in float64.
//
// Replaces the float64 side of TPU kernels 2 and 4: on a float64 run the
// JAX package takes neither Pallas kernel but the XLA einsums of
// _block_gram_wide (gmrm_tpu/ops/blockops.py:131, its craw) and
// block_eps_update (blockops.py:141-148).
//
// Bound on the H100: at the anchor (T=4, B=128, mb=2560) each pass reads
// B bed rows (328 KB) and the residual planes (328 KB, read and written by
// the update) and does 4 T B 4mb float64 operations (21 MFLOP): 0.63 us at
// 33.5 TFLOP/s, so operations bound it, and a launch is far from either.
// Design (simple and right first; a later PR makes it fast):
// - c-dot: one CTA per marker row; its threads stride over the row's byte
//   columns, decode the four codes of a byte and add a*eps and b*eps per
//   trait in registers; a fixed __shfl_xor tree over the warp, then the
//   warps in order, so two launches give the same bits.  Every CTA reads
//   the whole residual (from L2).
// - update: a CTA owns 32 byte columns and splits the block's rows over 8
//   row groups; each thread keeps T x 4 sums over its rows, the groups'
//   partials are added in group order through shared memory, and the
//   residual is read and written once.  No atomics.
// The decoded values 0, 1 and 2 are exact in float64, so a*eps and a*d
// are exact; the sums run in another order than the plain version's
// matrix products.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int MAX_T = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 32;                  // byte columns of an update CTA
constexpr int GROUPS = THREADS / COLS;    // row groups of an update CTA
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
cdot_f64_kernel(const uint8_t* __restrict__ bed, const int* __restrict__ rows,
                const double* __restrict__ eps,
                const double* __restrict__ mave,
                const double* __restrict__ msig, double* __restrict__ c,
                int T, int B, int mb) {
  __shared__ double red[WARPS][2 * MAX_T];
  const int j = blockIdx.x;
  const uint8_t* row = bed + (size_t)rows[j] * mb;
  double sa[MAX_T], sb[MAX_T];
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) sa[t] = sb[t] = 0.0;
  for (int m = threadIdx.x; m < mb; m += THREADS) {
    const uint32_t byte = row[m];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int a, b;
      gmrm_decode(byte, k, a, b);
      const double da = (double)a, db = (double)b;
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t < T) {
          const double e = __ldg(eps + ((size_t)t * 4 + k) * mb + m);
          sa[t] = __dadd_rn(sa[t], __dmul_rn(da, e));
          sb[t] = __dadd_rn(sb[t], __dmul_rn(db, e));
        }
      }
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t < T) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sa[t] = __dadd_rn(sa[t], __shfl_xor_sync(FULL, sa[t], o));
        sb[t] = __dadd_rn(sb[t], __shfl_xor_sync(FULL, sb[t], o));
      }
      if (lane == 0) {
        red[warp][t] = sa[t];
        red[warp][MAX_T + t] = sb[t];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < T) {
    const int t = threadIdx.x;
    double a = red[0][t], b = red[0][MAX_T + t];
    for (int w = 1; w < WARPS; ++w) {
      a = __dadd_rn(a, red[w][t]);
      b = __dadd_rn(b, red[w][MAX_T + t]);
    }
    const size_t x = (size_t)t * B + j;
    c[x] = __dmul_rn(msig[x], __dsub_rn(a, __dmul_rn(mave[x], b)));
  }
}

// Shared memory: d and mave*d (T, B) each, then the row groups' partials
// (GROUPS, T * 4, COLS).
__global__ void __launch_bounds__(THREADS)
update_f64_kernel(const uint8_t* __restrict__ bed,
                  const int* __restrict__ rows, const double* __restrict__ d,
                  const double* __restrict__ mave,
                  const double* __restrict__ na, double* __restrict__ target,
                  int T, int B, int mb) {
  extern __shared__ double sm[];
  double* dd = sm;
  double* md = sm + (size_t)T * B;
  double* part = sm + (size_t)2 * T * B;
  for (int x = threadIdx.x; x < T * B; x += THREADS) {
    dd[x] = d[x];
    md[x] = __dmul_rn(mave[x], d[x]);
  }
  __syncthreads();
  const int col = threadIdx.x % COLS, g = threadIdx.x / COLS;
  const int m = blockIdx.x * COLS + col;
  double acc[MAX_T][4];
#pragma unroll
  for (int t = 0; t < MAX_T; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.0;
  if (m < mb) {
    for (int j = g; j < B; j += GROUPS) {
      const uint32_t byte = bed[(size_t)rows[j] * mb + m];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int a, b;
        gmrm_decode(byte, k, a, b);
        const double da = (double)a, db = (double)b;
#pragma unroll
        for (int t = 0; t < MAX_T; ++t) {
          if (t < T) {
            const double x = __dsub_rn(__dmul_rn(da, dd[t * B + j]),
                                       __dmul_rn(db, md[t * B + j]));
            acc[t][k] = __dadd_rn(acc[t][k], x);
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < MAX_T; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t < T)
        part[((size_t)g * T * 4 + t * 4 + k) * COLS + col] = acc[t][k];
  __syncthreads();
  for (int o = threadIdx.x; o < T * 4 * COLS; o += THREADS) {
    const int tk = o / COLS, c2 = o % COLS;
    const int m2 = blockIdx.x * COLS + c2;
    if (m2 >= mb) continue;
    double s = part[(size_t)tk * COLS + c2];
    for (int g2 = 1; g2 < GROUPS; ++g2)
      s = __dadd_rn(s, part[((size_t)g2 * T * 4 + tk) * COLS + c2]);
    const size_t x = (size_t)tk * mb + m2;
    target[x] = __dadd_rn(target[x], __dmul_rn(na[x], s));
  }
}

}  // namespace

// The update kernel's dynamic shared memory at (T, B) (block_kernels.py
// f64_update_smem).
static int update_f64_smem(int T, int B) {
  return (int)(((size_t)2 * T * B + (size_t)GROUPS * T * 4 * COLS) *
               sizeof(double));
}

// bed (m_pad, mb) uint8; rows (B,) int32; eps (T, 4, mb), mave/msig (T, B)
// and c (T, B) float64.  T <= 8.
extern "C" int gmrm_block_cdot_f64(const void* bed, const void* rows,
                                   const void* eps, const void* mave,
                                   const void* msig, void* c, int T, int B,
                                   int mb, void* stream) {
  if (T < 1 || T > MAX_T || B < 1 || mb < 1)
    return (int)cudaErrorInvalidValue;
  cdot_f64_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bed, (const int*)rows, (const double*)eps,
      (const double*)mave, (const double*)msig, (double*)c, T, B, mb);
  return (int)cudaGetLastError();
}

// bed, rows as above; d = msig * dbeta and mave (T, B), na and target
// (T, 4, mb) float64; target += na * the block's update.  T <= 8.
extern "C" int gmrm_eps_update_f64(const void* bed, const void* rows,
                                   const void* d, const void* mave,
                                   const void* na, void* target, int T, int B,
                                   int mb, void* stream) {
  if (T < 1 || T > MAX_T || B < 1 || mb < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = update_f64_smem(T, B);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        update_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  update_f64_kernel<<<(mb + COLS - 1) / COLS, THREADS, smem,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)bed, (const int*)rows, (const double*)d,
      (const double*)mave, (const double*)na, (double*)target, T, B, mb);
  return (int)cudaGetLastError();
}
