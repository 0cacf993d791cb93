// Exact serial Gibbs scan of one block in float64 (kernel C, a --dtype
// float64 run): for j = 0 .. B-1 and every trait t, as serial_scan.cu
// computes it in float32,
//   base = c + beta_old (nonas - 1)   (or given as it is),
//   num = base + corr,  muk_k = num rd_k,  L_k = lc_k + muk_k (num i2se),
//   s_i = 1 / sum_k exp(L_k - L_i), set to 0 when |L_k - L_i| > 700 for
//   some k >= i;  cdf_i = s_0 + ... + s_i  (the reference's CDF walk),
//   comp = the smallest i with u <= cdf_i (else K-1),
//   beta = comp ? muk_comp + sqb_comp z : 0, under the live/zerob masks,
// then corr[t, i] += gs[t, j, i] dbeta[t] for every i, and d = msig dbeta.
//
// Replaces the float64 side of TPU kernel 6: on a float64 run the JAX
// package scans with the XLA block_scan (gmrm_tpu/sampler/scan.py:33), the
// reference's recursion (bayes.cpp:391-492).  The interface is
// serial_scan.cu's (the sweep's arrays, a block index, the results written
// in place), so SerialScanSweep drives either.
//
// Bound on the H100: latency, B dependent steps.  Design (simple and right
// first): the traits are independent chains, so each trait is one CTA of
// one warp, and no barrier spans warps.  A step's candidate math is spread
// over the warp through a small shared scratch: lanes k < K form L_k, the
// K x K exponentials go to the lanes, lane i < K sums its K terms in index
// order and takes the reciprocal, and every lane walks the CDF in index
// order (the same values on every lane, so comp needs no broadcast).  Lane
// l holds corr[i] for i = l, l + 32, ... in registers; the next step's
// inputs and Gram row are loaded while the current step computes.  Math in
// double with exp and IEEE division; adds and products use the _rn
// intrinsics so nvcc does not contract them, as the plain version rounds
// each on its own.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 16;
constexpr int MAX_T = 65535;
constexpr unsigned FULL = 0xffffffffu;

struct ScanF64 {
  // One block's operands (already offset by the entry point).
  const double *c, *nm1, *lc, *rd, *sqb, *gs, *beta_old, *acum_old, *u, *z,
      *msig, *i2se;
  const int *comp_old, *live, *zerob;
  double *dbeta, *d, *beta_new, *acum_new;
  int* comp_new;
  int T, B, K;
};

// Step j's per-marker inputs of one trait.
struct StepIn {
  double c, bo, ao, u, z, ms, lc, rd, sq;
  int co, lv, zb;
};

__device__ __forceinline__ StepIn load_step(const ScanF64& a, size_t tb,
                                            size_t ktb, int j, int lane) {
  StepIn s;
  const size_t x = tb + j;
  s.c = __ldg(a.c + x);
  s.bo = __ldg(a.beta_old + x);
  s.ao = __ldg(a.acum_old + x);
  s.u = __ldg(a.u + x);
  s.z = __ldg(a.z + x);
  s.ms = a.msig ? __ldg(a.msig + x) : 0.0;
  s.co = __ldg(a.comp_old + x);
  s.lv = __ldg(a.live + x);
  s.zb = __ldg(a.zerob + x);
  s.lc = s.rd = s.sq = 0.0;
  if (lane < a.K) {
    const size_t y = (size_t)lane * ktb + x;
    s.lc = __ldg(a.lc + y);
    s.rd = __ldg(a.rd + y);
    s.sq = __ldg(a.sqb + y);
  }
  return s;
}

// NPL Gram entries a lane: B <= 32 NPL.
template <int NPL>
__global__ void __launch_bounds__(32) serial_scan_f64_kernel(ScanF64 a) {
  __shared__ double sL[MAX_K], sMu[MAX_K], sSq[MAX_K], sS[MAX_K];
  __shared__ double sE[MAX_K * MAX_K];
  const int t = blockIdx.x, lane = threadIdx.x;
  const int B = a.B, K = a.K;
  const size_t tb = (size_t)t * B;           // (T, B) arrays of the block
  const size_t ktb = (size_t)a.T * B;        // the k stride of (K, T, B)
  const double* gs = a.gs + (size_t)t * B * B;
  const double nm1 = a.nm1 ? a.nm1[t] : 0.0;
  const double i2se = a.i2se[t];

  double corr[NPL], g[NPL], gn[NPL];
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    corr[r] = 0.0;
    const int i = r * 32 + lane;
    gn[r] = i < B ? __ldg(gs + i) : 0.0;
  }
  StepIn nx = load_step(a, tb, ktb, 0, lane);

#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    for (int jj = 0; jj < 32; ++jj) {
      const int j = r * 32 + jj;
      if (j >= B) break;
      const StepIn in = nx;
#pragma unroll
      for (int r2 = 0; r2 < NPL; ++r2) g[r2] = gn[r2];
      if (j + 1 < B) {
        nx = load_step(a, tb, ktb, j + 1, lane);
        const double* row = gs + (size_t)(j + 1) * B;
#pragma unroll
        for (int r2 = 0; r2 < NPL; ++r2) {
          const int i = r2 * 32 + lane;
          gn[r2] = i < B ? __ldg(row + i) : 0.0;
        }
      }
      const double base =
          a.nm1 ? __dadd_rn(in.c, __dmul_rn(in.bo, nm1)) : in.c;
      const double num = __dadd_rn(base, __shfl_sync(FULL, corr[r], jj));
      if (lane < K) {
        const double mu = __dmul_rn(num, in.rd);
        sMu[lane] = mu;
        sL[lane] = __dadd_rn(in.lc, __dmul_rn(mu, __dmul_rn(num, i2se)));
        sSq[lane] = in.sq;
      }
      __syncwarp();
      for (int p = lane; p < K * K; p += 32) {
        const int i = p / K, k = p % K;
        sE[p] = exp(__dsub_rn(sL[k], sL[i]));
      }
      __syncwarp();
      if (lane < K) {
        const double Li = sL[lane];
        double esum = sE[lane * K];
        bool guard = false;
        for (int k = 0; k < K; ++k) {
          if (k > 0) esum = __dadd_rn(esum, sE[lane * K + k]);
          if (k >= lane && fabs(__dsub_rn(sL[k], Li)) > 700.0) guard = true;
        }
        sS[lane] = guard ? 0.0 : __ddiv_rn(1.0, esum);
      }
      __syncwarp();
      int comp = K - 1;
      double cdf = 0.0, acum = 0.0;
      bool found = false;
      for (int i = 0; i < K; ++i) {
        cdf = i == 0 ? sS[0] : __dadd_rn(cdf, sS[i]);
        if (!found && in.u <= cdf) {
          comp = i;
          acum = cdf;
          found = true;
        }
      }
      if (!found) acum = cdf;
      const double samp =
          comp == 0 ? 0.0 : __dadd_rn(sMu[comp], __dmul_rn(sSq[comp], in.z));
      const double db = in.lv ? __dsub_rn(in.bo, samp) : 0.0;
      if (lane == 0) {
        const size_t x = tb + j;
        a.dbeta[x] = db;
        if (a.d) a.d[x] = __dmul_rn(in.ms, db);
        a.beta_new[x] = in.lv ? samp : (in.zb ? 0.0 : in.bo);
        a.comp_new[x] = in.lv ? comp : in.co;
        a.acum_new[x] = in.lv ? acum : (in.zb ? 1.0 : in.ao);
      }
#pragma unroll
      for (int r2 = 0; r2 < NPL; ++r2)
        corr[r2] = __dadd_rn(corr[r2], __dmul_rn(g[r2], db));
      __syncwarp();
    }
  }
}

}  // namespace

// The sweep's arrays: c (nc, T, B) (base itself when nm1 is null); nm1,
// i2se (T,); lc, rd, sqb (nb, K, T, B); gs (nr, T, B, B); beta_old,
// acum_old, u, z, msig, dbeta, d, beta_new, acum_new (nb, T, B) float64;
// comp_old, live, zerob, comp_new (nb, T, B) int32.  Block b with c[bc] and
// Gram gs[bg]; msig and d both null or both set.  K <= 16, B <= 512.
extern "C" int gmrm_serial_scan_f64(
    const void* c, const void* nm1, const void* lc, const void* rd,
    const void* sqb, const void* gs, const void* beta_old,
    const void* comp_old, const void* acum_old, const void* u, const void* z,
    const void* live, const void* zerob, const void* msig, const void* i2se,
    void* dbeta, void* d, void* beta_new, void* comp_new, void* acum_new,
    int b, int bc, int bg, int T, int B, int K, void* stream) {
  if (K < 1 || K > MAX_K || T < 1 || T > MAX_T || B < 1 || B > 512 ||
      b < 0 || bc < 0 || bg < 0 || (msig == nullptr) != (d == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t tb = (size_t)b * T * B, ktb = (size_t)b * K * T * B;
  ScanF64 a;
  a.c = (const double*)c + (size_t)bc * T * B;
  a.nm1 = (const double*)nm1;
  a.lc = (const double*)lc + ktb;
  a.rd = (const double*)rd + ktb;
  a.sqb = (const double*)sqb + ktb;
  a.gs = (const double*)gs + (size_t)bg * T * B * B;
  a.beta_old = (const double*)beta_old + tb;
  a.comp_old = (const int*)comp_old + tb;
  a.acum_old = (const double*)acum_old + tb;
  a.u = (const double*)u + tb;
  a.z = (const double*)z + tb;
  a.live = (const int*)live + tb;
  a.zerob = (const int*)zerob + tb;
  a.msig = msig ? (const double*)msig + tb : nullptr;
  a.i2se = (const double*)i2se;
  a.dbeta = (double*)dbeta + tb;
  a.d = d ? (double*)d + tb : nullptr;
  a.beta_new = (double*)beta_new + tb;
  a.comp_new = (int*)comp_new + tb;
  a.acum_new = (double*)acum_new + tb;
  a.T = T;
  a.B = B;
  a.K = K;
  cudaStream_t s = (cudaStream_t)stream;
  const int npl = (B + 31) / 32;
  if (npl <= 1)
    serial_scan_f64_kernel<1><<<T, 32, 0, s>>>(a);
  else if (npl <= 2)
    serial_scan_f64_kernel<2><<<T, 32, 0, s>>>(a);
  else if (npl <= 4)
    serial_scan_f64_kernel<4><<<T, 32, 0, s>>>(a);
  else if (npl <= 8)
    serial_scan_f64_kernel<8><<<T, 32, 0, s>>>(a);
  else
    serial_scan_f64_kernel<16><<<T, 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}
