// Residual dot products of one block, in processing order:
//   c[t, i] = msig[t, i] * (sum_n a_i[n] eps_t[n] - mave[t, i] * sum_n b_i[n] eps_t[n])
// for marker row rows[i] of the bed (rows = blk*B + win, so the bed is read
// in place and never permuted or copied).
//
// Replaces _cdot_kernel (gmrm_tpu/ops/pallas_kernels.py:275, built by
// _build_cdot_call :315, wrapper block_cdot_pallas :335).  The TPU kernel
// carries eps as a bf16 hi/lo pair through the MXU; here the sums are
// plain float32 FMAs.
//
// Bound on the H100: memory.  Each block reads B * mb packed bytes from
// the bed and, per marker, the T x 4 x mb float32 residual, which stays in
// the 50 MB L2 across the block's CTAs.  Design: one CTA per marker; its
// threads stride the row's bytes, decode four individuals per byte in
// registers and accumulate per-trait sums; a fixed shared-memory tree
// reduction (no atomics) keeps the result deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int MAX_T = 8;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
block_cdot_kernel(const uint8_t* __restrict__ bed,
                  const int* __restrict__ rows,
                  const float* __restrict__ eps,
                  const float* __restrict__ mave,
                  const float* __restrict__ msig, float* __restrict__ c,
                  int T, int B, int mb) {
  __shared__ float red[2 * MAX_T][THREADS];
  const int i = blockIdx.x;
  const uint8_t* row = bed + (size_t)rows[i] * mb;
  float sa[MAX_T], sb[MAX_T];
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    sa[t] = 0.0f;
    sb[t] = 0.0f;
  }
  for (int j = threadIdx.x; j < mb; j += THREADS) {
    const uint32_t byte = row[j];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int a, b;
      gmrm_decode(byte, k, a, b);
      const float af = (float)a, bf = (float)b;
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t < T) {
          const float e = eps[((size_t)t * 4 + k) * mb + j];
          sa[t] += af * e;
          sb[t] += bf * e;
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    red[2 * t][threadIdx.x] = sa[t];
    red[2 * t + 1][threadIdx.x] = sb[t];
  }
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      for (int q = 0; q < 2 * T; ++q)
        red[q][threadIdx.x] += red[q][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < T) {
    const int t = threadIdx.x;
    const int o = t * B + i;
    c[o] = msig[o] * (red[2 * t][0] - mave[o] * red[2 * t + 1][0]);
  }
}

}  // namespace

extern "C" int gmrm_block_cdot(const void* bed, const void* rows,
                               const void* eps, const void* mave,
                               const void* msig, void* c, int T, int B,
                               int mb, void* stream) {
  block_cdot_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bed, (const int*)rows, (const float*)eps,
      (const float*)mave, (const float*)msig, (float*)c, T, B, mb);
  return (int)cudaGetLastError();
}
