// Residual update of one block, in place:
//   eps[t, k, n] += na[t, k, n] * sum_i (d[t, i] a_i[k, n] - mave[t, i] d[t, i] b_i[k, n])
// over the block's B marker rows rows[i] = blk*B + win[i], with
// d = msig * dbeta from the wave scan.
//
// Replaces _eps_update_kernel (gmrm_tpu/ops/pallas_kernels.py:352, built by
// _build_eps_update_call :378, wrapper block_eps_update_pallas :396).  The
// TPU kernel returns deps and XLA adds it; this kernel also does the add,
// so the residual is read and written once.
//
// Bound on the H100: memory, B * mb packed bytes plus one read and one
// write of the T x 4 x mb residual per block.  Design: one thread per
// (phase plane k, byte column n): consecutive threads take consecutive
// columns, so bed rows, na and eps are read coalesced; d and mave*d sit in
// shared memory; the thread walks the B rows, decodes plane k of each
// byte in registers and keeps T partial sums.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int MAX_T = 8;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
eps_update_kernel(const uint8_t* __restrict__ bed,
                  const int* __restrict__ rows,
                  const float* __restrict__ d,
                  const float* __restrict__ mave,
                  const float* __restrict__ na, float* __restrict__ eps,
                  int T, int B, int mb) {
  extern __shared__ float sm[];
  float* sd = sm;                    // (T, B) d
  float* smd = sm + T * B;           // (T, B) mave * d
  int* srow = (int*)(sm + 2 * T * B);
  for (int x = threadIdx.x; x < T * B; x += THREADS) {
    const float dv = d[x];
    sd[x] = dv;
    smd[x] = mave[x] * dv;
  }
  for (int x = threadIdx.x; x < B; x += THREADS) srow[x] = rows[x];
  __syncthreads();

  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= 4 * mb) return;
  const int k = g / mb;
  const int n = g % mb;
  float acc[MAX_T];
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) acc[t] = 0.0f;
  for (int i = 0; i < B; ++i) {
    int a, b;
    gmrm_decode(bed[(size_t)srow[i] * mb + n], k, a, b);
    const float af = (float)a, bf = (float)b;
#pragma unroll
    for (int t = 0; t < MAX_T; ++t)
      if (t < T) acc[t] += sd[t * B + i] * af - smd[t * B + i] * bf;
  }
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t < T) {
      const size_t o = ((size_t)t * 4 + k) * mb + n;
      eps[o] += na[o] * acc[t];
    }
  }
}

}  // namespace

extern "C" int gmrm_eps_update(const void* bed, const void* rows,
                               const void* d, const void* mave,
                               const void* na, void* eps, int T, int B,
                               int mb, void* stream) {
  const int blocks = (4 * mb + THREADS - 1) / THREADS;
  const size_t smem = (2 * (size_t)T * B) * sizeof(float) + B * sizeof(int);
  eps_update_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bed, (const int*)rows, (const float*)d,
      (const float*)mave, (const float*)na, (float*)eps, T, B, mb);
  return (int)cudaGetLastError();
}
