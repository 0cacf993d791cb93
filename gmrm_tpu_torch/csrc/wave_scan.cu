// Within-block Gibbs scan in waves of W markers (the W co-scheduled
// shards relaxation, gmrm_tpu/ops/scan_kernel_wave.py).
//
// Per wave, for every trait t and marker j of the wave:
//   num = base + corr,  q = num^2 / (2 sigmaE),  L_k = lc_k + q rd_k,
//   cdf_i = sum_{k<=i} E_k / S with E_k = exp(L_k - Lmax), S = sum_k E_k,
//   a term zeroed when |L_k - L_i| > 700 for some k >= i (suffix max/min),
//   comp = the smallest i with u <= cdf_i (else K-1),
//   beta = comp ? num rd_comp + sqb_comp z : 0, under the live/zerob masks;
// then the wave's rank-W fold corr[t, :] += sum_j dbeta[t, j] gs[t, j, :].
//
// Replaces _wave_kernel (gmrm_tpu/ops/scan_kernel_wave.py:57, built by
// _build_call :176, wrapper make_block_scan_wave :196).  The TPU kernel
// takes the Gram wave-stacked to (T*B, B) for its lane layout and folds
// with one block-diagonal MXU dot; here gs keeps its (T, B, B) layout and
// the fold is a plain loop.
//
// Bound on the H100: latency.  The B/W waves are a serial chain of small
// steps (T*W candidates, then a T*B fold), so one CTA runs the block and
// the time is the chain of dependent steps and barriers.  corr and the
// wave's dbeta live in shared memory.  The scaled Gram (256 KB at T=4,
// B=128) is larger than a CTA's 227 KB of shared memory, so it is read from
// global memory, where it stays in L2.  K is a runtime argument up to
// MAX_K, so the per-candidate arrays stay in registers.  Adds and products
// of the candidate math use the _rn intrinsics so nvcc does not contract
// them into FMAs: the plain PyTorch version rounds each one separately,
// and comp must agree with it exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 16;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
wave_scan_kernel(const float* __restrict__ base,
                 const float* __restrict__ lc,     // (K, T, B)
                 const float* __restrict__ rd,     // (K, T, B)
                 const float* __restrict__ sqb,    // (K, T, B)
                 const float* __restrict__ gs,     // (T, B, B)
                 const float* __restrict__ beta_old,
                 const int* __restrict__ comp_old,
                 const float* __restrict__ acum_old,
                 const float* __restrict__ u, const float* __restrict__ z,
                 const int* __restrict__ live, const int* __restrict__ zerob,
                 const float* __restrict__ i2se,   // (T,)
                 float* __restrict__ dbeta_out, float* __restrict__ beta_new,
                 int* __restrict__ comp_new, float* __restrict__ acum_new,
                 int T, int B, int K, int W) {
  extern __shared__ float sm[];
  float* corr = sm;            // (T, B)
  float* wdb = sm + T * B;     // (T, W) this wave's dbeta
  const int TB = T * B;
  const int TW = T * W;
  for (int x = threadIdx.x; x < TB; x += THREADS) corr[x] = 0.0f;
  __syncthreads();

  for (int w0 = 0; w0 < B; w0 += W) {
    int moved = 0;
    for (int x = threadIdx.x; x < TW; x += THREADS) {
      const int t = x / W;
      const int o = t * B + w0 + x % W;
      const float num = __fadd_rn(base[o], corr[o]);
      const float q = __fmul_rn(__fmul_rn(num, num), i2se[t]);
      float L[MAX_K], e[MAX_K], cdf[MAX_K];
      float lmax = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) {
        if (k < K) {
          L[k] = __fadd_rn(lc[(size_t)k * TB + o],
                           __fmul_rn(q, rd[(size_t)k * TB + o]));
          lmax = (k == 0) ? L[0] : fmaxf(lmax, L[k]);
        }
      }
      float ssum = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) {
        if (k < K) {
          e[k] = expf(__fsub_rn(L[k], lmax));
          ssum = (k == 0) ? e[0] : __fadd_rn(ssum, e[k]);
        }
      }
      const float inv_s = __fdiv_rn(1.0f, ssum);
      // Walk i downwards keeping the suffix max/min of L over k >= i.
      float smax = 0.0f, smin = 0.0f;
#pragma unroll
      for (int i = MAX_K - 1; i >= 0; --i) {
        if (i < K) {
          smax = (i == K - 1) ? L[i] : fmaxf(L[i], smax);
          smin = (i == K - 1) ? L[i] : fminf(L[i], smin);
          const bool over = (__fsub_rn(smax, L[i]) > 700.0f) ||
                            (__fsub_rn(L[i], smin) > 700.0f);
          cdf[i] = over ? 0.0f : __fmul_rn(e[i], inv_s);
        }
      }
#pragma unroll
      for (int i = 1; i < MAX_K; ++i)
        if (i < K) cdf[i] = __fadd_rn(cdf[i - 1], cdf[i]);

      const float uu = u[o];
      int comp = K - 1;
#pragma unroll
      for (int i = MAX_K - 1; i >= 0; --i)
        if (i < K && uu <= cdf[i]) comp = i;
      float acum_sel = 0.0f, rd_sel = 0.0f, sqb_sel = 0.0f;
#pragma unroll
      for (int i = 0; i < MAX_K; ++i) {
        if (i == comp) {
          acum_sel = cdf[i];
          rd_sel = rd[(size_t)i * TB + o];
          sqb_sel = sqb[(size_t)i * TB + o];
        }
      }
      const float muk = __fmul_rn(num, rd_sel);
      const float samp =
          comp == 0 ? 0.0f : __fadd_rn(muk, __fmul_rn(sqb_sel, z[o]));
      const bool lv = live[o] != 0;
      const bool zb = zerob[o] != 0;
      const float bo = beta_old[o];
      const float db = lv ? __fsub_rn(bo, samp) : 0.0f;
      dbeta_out[o] = db;
      beta_new[o] = lv ? samp : (zb ? 0.0f : bo);
      comp_new[o] = lv ? comp : comp_old[o];
      acum_new[o] = lv ? acum_sel : (zb ? 1.0f : acum_old[o]);
      wdb[x] = db;
      moved |= (db != 0.0f);
    }
    // Fold the wave's rank-W correction, skipped when nothing moved.
    if (__syncthreads_or(moved)) {
      for (int x = threadIdx.x; x < TB; x += THREADS) {
        const int t = x / B;
        const int i = x % B;
        const float* g = gs + ((size_t)t * B + w0) * B + i;
        const float* dw = wdb + t * W;
        float s = 0.0f;
        for (int j = 0; j < W; ++j) s += dw[j] * g[(size_t)j * B];
        corr[x] += s;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int gmrm_wave_scan(
    const void* base, const void* lc, const void* rd, const void* sqb,
    const void* gs, const void* beta_old, const void* comp_old,
    const void* acum_old, const void* u, const void* z, const void* live,
    const void* zerob, const void* i2se, void* dbeta, void* beta_new,
    void* comp_new, void* acum_new, int T, int B, int K, int W,
    void* stream) {
  if (K < 1 || K > MAX_K || W < 1 || B % W != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)T * B + (size_t)T * W) * sizeof(float);
  wave_scan_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)base, (const float*)lc, (const float*)rd,
      (const float*)sqb, (const float*)gs, (const float*)beta_old,
      (const int*)comp_old, (const float*)acum_old, (const float*)u,
      (const float*)z, (const int*)live, (const int*)zerob,
      (const float*)i2se, (float*)dbeta, (float*)beta_new, (int*)comp_new,
      (float*)acum_new, T, B, K, W);
  return (int)cudaGetLastError();
}
