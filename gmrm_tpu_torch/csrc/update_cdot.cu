// Block b's residual update and block b+1's residual dot products in one
// launch (kernels 4 and 2 fused), the step of the one-device W=1 sweep
// between two serial scans:
//   eps += na * sum_i d_i (a_i - mave_i b_i)        over block b's rows,
//   c_next = msig_next * (A_next . eps - mave_next * B_next . eps)
// from the updated eps.
//
// Replaces, on that path, _eps_update_kernel followed by _cdot_kernel
// (gmrm_tpu/ops/pallas_kernels.py:352 and :275).  Block b's update and block
// b+1's c-dot read the same slice of the residual: each CTA updates its
// slice, keeps it in shared memory and dots it against the next block's
// rows, staged with the first block's in the same round of copies.  One
// dependent launch fewer per block, and eps is read and written once for
// both passes.  Design: block_passes.cuh.
#include "block_passes.cuh"

namespace {

template <typename V>
int update_cdot(const void* bed, const void* rows, const void* rows_next,
                const void* d, const void* mave, const void* mave_next,
                const void* msig_next, const void* na, void* eps,
                void* c_next, void* scratch, int T, int B, int mb, int S,
                void* stamps, void* stream) {
  PassArgs<V> a = {};
  a.bed = (const uint8_t*)bed;
  a.rows_u = (const int*)rows;
  a.rows_c = (const int*)rows_next;
  a.d = (const V*)d;
  a.mave_u = (const V*)mave;
  a.mave_c = (const V*)mave_next;
  a.msig_c = (const V*)msig_next;
  a.na = (const V*)na;
  a.eps = (V*)eps;
  a.c = (V*)c_next;
  a.scratch = (unsigned*)scratch;
  a.T = T;
  a.B = B;
  a.mb = mb;
  a.S = S;
  a.stamps = (unsigned long long*)stamps;
  return launch_block_passes<V, UPDATE | CDOT>(a, (cudaStream_t)stream);
}

}  // namespace

extern "C" int gmrm_update_cdot(const void* bed, const void* rows,
                                const void* rows_next, const void* d,
                                const void* mave, const void* mave_next,
                                const void* msig_next, const void* na,
                                void* eps, void* c_next, void* scratch,
                                int T, int B, int mb, int S, void* stamps,
                                void* stream) {
  return update_cdot<float>(bed, rows, rows_next, d, mave, mave_next,
                            msig_next, na, eps, c_next, scratch, T, B, mb, S,
                            stamps, stream);
}

// Kernel B's fused pass: the same launch on float64 operands, the step of
// a --dtype float64 run's one-device W=1 sweep.
extern "C" int gmrm_update_cdot_f64(const void* bed, const void* rows,
                                    const void* rows_next, const void* d,
                                    const void* mave, const void* mave_next,
                                    const void* msig_next, const void* na,
                                    void* eps, void* c_next, void* scratch,
                                    int T, int B, int mb, int S, void* stamps,
                                    void* stream) {
  return update_cdot<double>(bed, rows, rows_next, d, mave, mave_next,
                             msig_next, na, eps, c_next, scratch, T, B, mb,
                             S, stamps, stream);
}
