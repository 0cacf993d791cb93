// Residual update of one block, in place (kernel 4):
//   eps[t, k, n] += na[t, k, n] * sum_i (d[t, i] a_i[k, n] - mave[t, i] d[t, i] b_i[k, n])
// over the block's B marker rows rows[i] = blk*B + win[i], with
// d = msig * dbeta from the scan.
//
// Replaces _eps_update_kernel (gmrm_tpu/ops/pallas_kernels.py:352, built by
// _build_eps_update_call :378, wrapper block_eps_update_pallas :396).  The
// TPU kernel returns deps and XLA adds it; this kernel also does the add,
// so the residual is read and written once.
//
// Bound and design: block_passes.cuh (the update pass of the column-slice
// kernel alone; the W=1 sweep on one device runs it fused with the next
// block's c-dot, update_cdot.cu, and this launch for its last block).
// gmrm_eps_update_f64 is the same pass at double (kernel B; the JAX
// package's float64 route is gmrm_tpu/ops/blockops.py:141 block_eps_update).
#include "block_passes.cuh"

namespace {

template <typename V>
int eps_update(const void* bed, const void* rows, const void* d,
               const void* mave, const void* na, void* eps, int T, int B,
               int mb, int S, void* stamps, void* stream) {
  PassArgs<V> a = {};
  a.bed = (const uint8_t*)bed;
  a.rows_u = (const int*)rows;
  a.d = (const V*)d;
  a.mave_u = (const V*)mave;
  a.na = (const V*)na;
  a.eps = (V*)eps;
  a.T = T;
  a.B = B;
  a.mb = mb;
  a.S = S;
  a.stamps = (unsigned long long*)stamps;
  return launch_block_passes<V, UPDATE>(a, (cudaStream_t)stream);
}

}  // namespace

extern "C" int gmrm_eps_update(const void* bed, const void* rows,
                               const void* d, const void* mave,
                               const void* na, void* eps, int T, int B,
                               int mb, int S, void* stamps,
                               void* stream) {
  return eps_update<float>(bed, rows, d, mave, na, eps, T, B, mb, S, stamps,
                           stream);
}

// Kernel B's update: the same pass on float64 d, mave, na and eps (the
// residual itself on one device, a zeroed delta on a marker-sharded run).
extern "C" int gmrm_eps_update_f64(const void* bed, const void* rows,
                                   const void* d, const void* mave,
                                   const void* na, void* eps, int T, int B,
                                   int mb, int S, void* stamps,
                                   void* stream) {
  return eps_update<double>(bed, rows, d, mave, na, eps, T, B, mb, S, stamps,
                            stream);
}
