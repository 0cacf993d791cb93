// Residual dot products of one block, in processing order (kernel 2):
//   c[t, i] = msig[t, i] * (sum_n a_i[n] eps_t[n] - mave[t, i] * sum_n b_i[n] eps_t[n])
// for marker row rows[i] of the bed (rows = blk*B + win, so the bed is read
// in place and never permuted or copied).
//
// Replaces _cdot_kernel (gmrm_tpu/ops/pallas_kernels.py:275, built by
// _build_cdot_call :315, wrapper block_cdot_pallas :335).  The TPU kernel
// carries eps as a bf16 hi/lo pair through the MXU; here the sums are
// plain float32 FMAs.
//
// Bound and design: block_passes.cuh (the c-dot pass of the column-slice
// kernel alone: per-slice partials, then a fixed-order two-level tree
// through the scratch buffer, whose counters start at zero and are left at
// zero by every launch).  gmrm_block_cdot_f64 is the same pass at double
// (kernel B, a --dtype float64 run; the JAX package's float64 route is the
// craw einsum of gmrm_tpu/ops/blockops.py:131 _block_gram_wide).
#include "block_passes.cuh"

namespace {

template <typename V>
int block_cdot(const void* bed, const void* rows, const void* eps,
               const void* mave, const void* msig, void* c, void* scratch,
               int T, int B, int mb, int S, void* stamps, void* stream) {
  PassArgs<V> a = {};
  a.bed = (const uint8_t*)bed;
  a.rows_c = (const int*)rows;
  a.mave_c = (const V*)mave;
  a.msig_c = (const V*)msig;
  a.eps = (V*)eps;                  // read only in this pass
  a.c = (V*)c;
  a.scratch = (unsigned*)scratch;
  a.T = T;
  a.B = B;
  a.mb = mb;
  a.S = S;
  a.stamps = (unsigned long long*)stamps;
  return launch_block_passes<V, CDOT>(a, (cudaStream_t)stream);
}

}  // namespace

extern "C" int gmrm_block_cdot(const void* bed, const void* rows,
                               const void* eps, const void* mave,
                               const void* msig, void* c, void* scratch,
                               int T, int B, int mb, int S, void* stamps,
                               void* stream) {
  return block_cdot<float>(bed, rows, eps, mave, msig, c, scratch, T, B, mb,
                           S, stamps, stream);
}

// Kernel B's c-dot: the same pass on float64 eps, mave, msig and c.
extern "C" int gmrm_block_cdot_f64(const void* bed, const void* rows,
                                   const void* eps, const void* mave,
                                   const void* msig, void* c, void* scratch,
                                   int T, int B, int mb, int S, void* stamps,
                                   void* stream) {
  return block_cdot<double>(bed, rows, eps, mave, msig, c, scratch, T, B,
                            mb, S, stamps, stream);
}
