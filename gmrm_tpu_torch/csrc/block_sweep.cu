// One Gram block of the wave-mode sweep (W > 1) in one launch, with the
// residual as a read-only input and the block's residual DELTA as an output:
// the unit of work of the marker-sharded sweep, whose caller sums the deltas
// of all shards before any of them touches the residual.
//
// For natural block blk = *blk_b of the shard's operands, marker rows
// blk*B + win[i], i the processing position:
//   (1) c[t, i] = msig (A_i . eps_t - mave B_i . eps_t) over all individuals,
//       base = c + beta_old (nonas - 1);
//   (2) the block's cached raw Gram quadrants gathered through win and scaled
//       (sweep_math.cuh);
//   (3) B/W waves of the mixture scan with the rank-W fold of corr;
//   (4) deps[t, k, n] = na[t, k, n] sum_i dbeta msig (a_i - mave b_i), every
//       element written (pad columns and all-pad blocks give zeros): deps is
//       the operand of a sum across processes;
//   (5) beta, comp, acum of the block updated in place, in their natural
//       slots.
//
// Replaces _block_sweep_kernel (gmrm_tpu/ops/sweep_kernel.py:961, call :1082,
// wrapper block_sweep_pallas :1104).  Not carried over: the one-hot matrix
// permute of the bed rows (here the row order is an index load), the bf16
// hi/lo splits of eps and of the update's left operand, the lane tiling and
// the B <= 512 / G <= 256 ceilings.  blk_b and m_local are read on the device,
// so the host never waits on them inside its block loop.
//
// Bound on the H100: latency.  One block moves ~1 MB (the bed rows once, the
// raw Gram, eps in and deps out) and does ~42 Mflop, under a microsecond of
// either; the time goes to the launch, three grid-wide barriers and the scan, which only
// one CTA can run.  The design is one block of csrc/sweep_blocks.cu with
// nothing to overlap across blocks:
//   - a cooperative grid, one CTA per SM at most, CTA g owning byte columns
//     [g*S, (g+1)*S).  Every CTA stages the row order, the block's marker
//     statistics and its bed bytes in shared memory, where (1) and (4) read
//     them; CTA 0 also loads the block's marker state, which does not depend
//     on eps, before the first barrier;
//   - all CTAs build the scaled Gram entries (j, i) that a fold reads (i in a
//     later wave than j) into a scratch, then their partial sums of (1) (a
//     thread per marker row and column part, summed in a fixed order); grid
//     sync; each CTA sums its share of the 2TB sums over all CTAs' partials in
//     CTA order; grid sync;
//   - CTA 0 runs (3) and (5) and publishes dbeta; grid sync;
//   - all CTAs write (4) for their columns, a thread per byte column and row
//     part.
// No float atomics and every sum in a fixed order, so a delta, and with it a
// chain, is reproducible bit for bit; _rn intrinsics and IEEE expf in the draw
// and the Gram scaling, so comp equals the plain version's.
//
// The code is a copy of the matching pieces of sweep_blocks.cu, not shared
// with it: moving the draw into a shared header once changed the schedule of
// wave_scan.cu and nearly doubled its time (see sweep_math.cuh), so the
// whole-sweep kernel's source stays as it is.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>

#include "decode.cuh"
#include "sweep_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_T = 8;
constexpr int THREADS = 512;
constexpr int MAX_ROW_PARTS = 16;
enum { BED_SMEM = 1, TAB_SMEM = 2 };

struct BlockArgs {
  const int* blk_b;       // (1,) natural block id, on the device
  const int* m_local;     // (1,) real marker count of the shard, on the device
  const uint8_t* bed;     // (nb*B, mb) natural order
  const int* win;         // (B,)
  const float* gram;      // (nb, nt, 2B, 2B)
  const float* eps;       // (T, 4, mb), read only
  const float* na;        // (nt, 4, mb)
  const float* mave;      // (T, nb*B) natural order, as msig, beta, comp,
  const float* msig;      //   acum and grp (nb*B,)
  float* beta;            // the block's slots are updated in place
  int* comp;
  float* acum;
  const int* grp;
  const float* u;         // (T, B) processing order
  const float* z;
  const float* sigmag;    // (T, G)
  const float* lc;        // (K, T, G)
  const float* rd;
  const float* sqb;
  const float* i2se;      // (T,)
  const float* nonas;     // (T,)
  float* deps;            // (T, 4, mb), every element written
  float* part;            // (CTAs, 2T, B) scratch
  float* red;             // (2T, B) scratch: the partials summed
  float* gs;              // (T, B, B) scratch: scaled Gram, later waves only
  float* dbuf;            // (T, B) scratch: dbeta
  int nb, T, B, mb, nt, K, W, G, S, flags;
};

// Shared memory offsets in bytes; the same layout in every CTA.  Only CTA 0
// uses the scan's part.
struct Layout {
  size_t win, row, grp, mave, msig, x0, x1, red, bed;
  size_t s_comp, s_flag, s_beta, s_acum, s_db, s_wdb, s_lc, s_rd, s_sqb;
  size_t total;
  int SP;   // bed row stride in shared memory
  int P;    // column parts per marker row in step (1)
  int R;    // row parts per byte column in step (4)
};

__host__ __device__ inline Layout make_layout(int T, int B, int W, int K,
                                              int S, int flags) {
  Layout L;
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  };
  const size_t tb = (size_t)T * B * 4;
  // An odd word stride keeps rows that 32 threads read at once in 32 banks.
  L.SP = ((S + 3) / 4) * 4;
  if ((L.SP / 4) % 2 == 0) L.SP += 4;
  L.P = B <= THREADS ? THREADS / B : 1;
  L.R = S <= THREADS ? THREADS / S : 1;
  if (L.R > MAX_ROW_PARTS) L.R = MAX_ROW_PARTS;
  if (L.R > B) L.R = B;
  L.win = take((size_t)B * 4);
  L.row = take((size_t)B * 4);
  L.grp = take((size_t)B * 4);
  L.mave = take(tb);
  L.msig = take(tb);
  L.x0 = take(tb);   // base in the scan, msig * dbeta in step (4)
  L.x1 = take(tb);   // corr in the scan, mave * msig * dbeta in step (4)
  const size_t red_a = (size_t)L.P * 2 * tb;
  const size_t red_c = L.R > 1 ? (size_t)L.R * T * 4 * S * 4 : 0;
  L.red = take(red_a > red_c ? red_a : red_c);
  L.bed = take((flags & BED_SMEM) ? (size_t)B * L.SP : 0);
  L.s_comp = take(tb);
  L.s_flag = take(tb);
  L.s_beta = take(tb);
  L.s_acum = take(tb);
  L.s_db = take(tb);
  L.s_wdb = take((size_t)T * W * 4);
  const size_t tab = (flags & TAB_SMEM) ? (size_t)K * tb : 0;
  L.s_lc = take(tab);
  L.s_rd = take(tab);
  L.s_sqb = take(tab);
  L.total = off;
  return L;
}

template <int MT, int MK>
__global__ void __launch_bounds__(THREADS)
block_sweep_kernel(const BlockArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char sm[];
  const int T = a.T, B = a.B, W = a.W, K = a.K, G = a.G, S = a.S, mb = a.mb;
  const int TB = T * B;
  const Layout L = make_layout(T, B, W, K, S, a.flags);
  const int SP = L.SP;
  const bool bed_s = a.flags & BED_SMEM;
  const bool tab_s = a.flags & TAB_SMEM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cta = blockIdx.x;
  const int ncta = gridDim.x;
  const int col0 = cta * S;
  const int ncol = min(S, mb - col0);

  const int blk = *a.blk_b;
  const int m_local = *a.m_local;
  // A block outside the operands would read and write out of bounds.
  if (a.nb > 1 && (blk < 0 || blk >= a.nb)) __trap();
  const int off = a.nb > 1 ? blk * B : 0;        // the block in the operands
  const size_t m_in = (size_t)a.nb * B;

  int* swin = (int*)(sm + L.win);
  int* srow = (int*)(sm + L.row);
  int* sgrp = (int*)(sm + L.grp);
  float* smave = (float*)(sm + L.mave);
  float* smsig = (float*)(sm + L.msig);
  float* sx0 = (float*)(sm + L.x0);
  float* sx1 = (float*)(sm + L.x1);
  float* sred = (float*)(sm + L.red);
  uint8_t* sbed = sm + L.bed;
  int* scomp = (int*)(sm + L.s_comp);
  int* sflag = (int*)(sm + L.s_flag);      // bit 0 live, bit 1 zerob
  float* sbeta = (float*)(sm + L.s_beta);
  float* sacum = (float*)(sm + L.s_acum);
  float* sdb = (float*)(sm + L.s_db);
  float* swdb = (float*)(sm + L.s_wdb);    // (T, W) this wave's dbeta
  float* slc = (float*)(sm + L.s_lc);      // (K, T, B) per-marker tables
  float* srd = (float*)(sm + L.s_rd);
  float* ssqb = (float*)(sm + L.s_sqb);

  // ---- stage the row order, the statistics and the CTA's bed bytes --------
#pragma unroll 1
  for (int i = tid; i < B; i += THREADS) {
    const int w = a.win[i];
    swin[i] = w;
    srow[i] = off + w;
    sgrp[i] = a.grp[off + w];
  }
  __syncthreads();
#pragma unroll 1
  for (int x = tid; x < TB; x += THREADS) {
    const size_t o = (size_t)(x / B) * m_in + srow[x % B];
    const float va = a.mave[o], vs = a.msig[o];
    smave[x] = va;
    smsig[x] = vs;
  }
  if (bed_s) {
    // Eight rows' loads in flight per warp before the first store.
    constexpr int NW = THREADS / 32, RB = 8;
    for (int i0 = warp; i0 < B; i0 += NW * RB) {
      for (int c = lane; c < ncol; c += 32) {
        uint8_t v[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int i = i0 + r * NW;
          v[r] = i < B ? a.bed[(size_t)srow[i] * mb + col0 + c] : 0;
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int i = i0 + r * NW;
          if (i < B) sbed[(size_t)i * SP + c] = v[r];
        }
      }
    }
  }
  // CTA 0: the block's marker state in processing order, and valid, live and
  // zerob from m_local, grp and sigmag
  // (gmrm_tpu/ops/sweep_kernel.py:201-213).  None of it depends on eps.
  if (cta == 0) {
#pragma unroll 1
    for (int x = tid; x < TB; x += THREADS) {
      const int t = x / B, i = x % B;
      const size_t o = (size_t)t * m_in + srow[i];
      const int tg = t * G + sgrp[i];
      const float v_beta = a.beta[o], v_acum = a.acum[o];
      const int v_comp = a.comp[o];
      const bool adav = a.sigmag[tg] == 0.0f;
      float tl[MK], tr[MK], ts[MK];
#pragma unroll
      for (int k = 0; k < MK; ++k) {
        if (tab_s && k < K) {
          const size_t s = (size_t)k * T * G + tg;
          tl[k] = a.lc[s];
          tr[k] = a.rd[s];
          ts[k] = a.sqb[s];
        }
      }
      const bool valid = blk * B + swin[i] < m_local;
      sbeta[x] = v_beta;
      sacum[x] = v_acum;
      scomp[x] = v_comp;
      sflag[x] = (valid && !adav ? 1 : 0) | (valid && adav ? 2 : 0);
#pragma unroll
      for (int k = 0; k < MK; ++k) {
        if (tab_s && k < K) {
          slc[k * TB + x] = tl[k];
          srd[k * TB + x] = tr[k];
          ssqb[k * TB + x] = ts[k];
        }
      }
    }
  }
  __syncthreads();

  // ---- (2) the scaled Gram entries a fold reads: i in a later wave than j --
  {
    const int B2 = 2 * B;
    const size_t quad = (size_t)B2 * B2;
    const float* g0 = a.gram + (size_t)(a.nb > 1 ? blk : 0) * a.nt * quad;
    const int n = T * B * B;
#pragma unroll 1
    for (int e = cta * THREADS + tid; e < n; e += ncta * THREADS) {
      const int t = e / (B * B);
      const int j = (e / B) % B;
      const int i = e % B;
      if (i / W > j / W) {
        const float* g = g0 + (a.nt == 1 ? 0 : t) * quad;
        const int wj = swin[j], wi = swin[i];
        a.gs[e] = gmrm_scale_gram(
            g[(size_t)wj * B2 + wi], g[(size_t)(B + wj) * B2 + wi],
            g[(size_t)wj * B2 + B + wi], g[(size_t)(B + wj) * B2 + B + wi],
            smave[t * B + i], smave[t * B + j], smsig[t * B + i],
            smsig[t * B + j]);
      }
    }
  }

  // ---- (1) partial sums of A_i . eps_t and B_i . eps_t over the CTA's
  // columns.  Thread (i, h): marker row i, part h of the columns.
  {
    const int P = L.P;
    const int cw = (ncol + P - 1) / P;
#pragma unroll 1
    for (int x = tid; x < B * P; x += THREADS) {
      const int i = x % B, h = x / B;
      const int c1 = min(ncol, (h + 1) * cw);
      const uint8_t* rp =
          bed_s ? sbed + (size_t)i * SP : a.bed + (size_t)srow[i] * mb + col0;
      float sa[MT], sb[MT];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        sa[t] = 0.0f;
        sb[t] = 0.0f;
      }
#pragma unroll 4
      for (int c = h * cw; c < c1; ++c) {
        const uint32_t byte = rp[c];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          int ga, gb;
          gmrm_decode(byte, k, ga, gb);
          const float af = (float)ga, bf = (float)gb;
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            if (t < T) {
              const float e = a.eps[(size_t)(t * 4 + k) * mb + col0 + c];
              sa[t] += af * e;
              sb[t] += bf * e;
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t < T) {
          sred[((size_t)h * 2 * T + 2 * t) * B + i] = sa[t];
          sred[((size_t)h * 2 * T + 2 * t + 1) * B + i] = sb[t];
        }
      }
    }
    __syncthreads();
    float* out = a.part + (size_t)cta * 2 * TB;
#pragma unroll 1
    for (int o = tid; o < 2 * TB; o += THREADS) {
      float s = sred[o];
      for (int h = 1; h < P; ++h) s += sred[(size_t)h * 2 * TB + o];
      out[o] = s;
    }
  }
  grid.sync();

  // The partials summed in CTA order, each CTA its share of the 2TB sums: a
  // warp per sum, a lane per 32nd of the partials, then a fixed-order shuffle
  // tree.
  {
    const int n2 = 2 * TB;
    const int per = (n2 + ncta - 1) / ncta;
    for (int w = warp; w < per; w += THREADS / 32) {
      const int o = cta * per + w;
      if (o < n2) {
        float v = 0.0f;
#pragma unroll 4
        for (int g = lane; g < ncta; g += 32)
          v += __ldcg(a.part + (size_t)g * n2 + o);
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, sh);
        if (lane == 0) a.red[o] = v;
      }
    }
  }
  grid.sync();

  // ---- (3), (5): the scan, CTA 0 ------------------------------------------
  if (cta == 0) {
    float* sbase = sx0;
    float* scorr = sx1;
#pragma unroll 1
    for (int o = tid; o < 2 * TB; o += THREADS) sred[o] = __ldcg(a.red + o);
    __syncthreads();
#pragma unroll 1
    for (int x = tid; x < TB; x += THREADS) {
      const int t = x / B, i = x % B;
      const float sa = sred[(2 * t) * B + i];
      const float sb = sred[(2 * t + 1) * B + i];
      const float c =
          __fmul_rn(smsig[x], __fsub_rn(sa, __fmul_rn(smave[x], sb)));
      sbase[x] =
          __fadd_rn(c, __fmul_rn(sbeta[x], __fsub_rn(a.nonas[t], 1.0f)));
      scorr[x] = 0.0f;
    }
    __syncthreads();

#pragma unroll 1
    for (int w0 = 0; w0 < B; w0 += W) {
      int moved = 0;
#pragma unroll 1
      for (int x = tid; x < T * W; x += THREADS) {
        const int t = x / W;
        const int i = w0 + x % W;
        const int o = t * B + i;
        const float uu = a.u[o], zz = a.z[o];
        const float num = __fadd_rn(sbase[o], scorr[o]);
        const int tg = t * G + sgrp[i];
        const GmrmDraw dr =
            tab_s ? gmrm_wave_draw<MK>(num, a.i2se[t], slc + o, srd + o,
                                       ssqb + o, (size_t)TB, K, uu, zz)
                  : gmrm_wave_draw<MK>(num, a.i2se[t], a.lc + tg, a.rd + tg,
                                       a.sqb + tg, (size_t)T * G, K, uu, zz);
        const bool lv = sflag[o] & 1;
        const bool zb = sflag[o] & 2;
        const float bo = sbeta[o];
        const float db = lv ? __fsub_rn(bo, dr.samp) : 0.0f;
        const size_t nat = (size_t)t * m_in + srow[i];
        a.beta[nat] = lv ? dr.samp : (zb ? 0.0f : bo);
        a.comp[nat] = lv ? dr.comp : scomp[o];
        a.acum[nat] = lv ? dr.acum : (zb ? 1.0f : sacum[o]);
        sdb[o] = db;
        swdb[x] = db;
        moved |= (db != 0.0f);
      }
      // Fold the wave's rank-W correction into the later waves' corr,
      // skipped when nothing moved.
      const bool any = __syncthreads_or(moved);
      const int rest = B - (w0 + W);
      if (any && rest > 0) {
#pragma unroll 1
        for (int x = tid; x < T * rest; x += THREADS) {
          const int t = x / rest;
          const int i = w0 + W + x % rest;
          const float* dw = swdb + t * W;
          const float* g = a.gs + ((size_t)t * B + w0) * B + i;
          float s = 0.0f;
#pragma unroll 4
          for (int j = 0; j < W; ++j) s += dw[j] * __ldcg(g + (size_t)j * B);
          scorr[t * B + i] += s;
        }
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int x = tid; x < TB; x += THREADS) a.dbuf[x] = sdb[x];
  }
  grid.sync();

  // ---- (4) the residual delta of the CTA's columns -------------------------
  float* sd = sx0;     // msig * dbeta
  float* smd = sx1;    // mave * msig * dbeta
#pragma unroll 1
  for (int x = tid; x < TB; x += THREADS) {
    const float dv = smsig[x] * __ldcg(a.dbuf + x);
    sd[x] = dv;
    smd[x] = smave[x] * dv;
  }
  __syncthreads();
  // Thread (c, r): byte column c, part r of the block's rows.
  const int R = L.R;
  const int rw = (B + R - 1) / R;
#pragma unroll 1
  for (int x = tid; x < ncol * R; x += THREADS) {
    const int c = x % ncol, r = x / ncol;
    const int i1 = min(B, (r + 1) * rw);
    float acc[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][k] = 0.0f;
#pragma unroll 4
    for (int i = r * rw; i < i1; ++i) {
      const uint8_t* rp =
          bed_s ? sbed + (size_t)i * SP : a.bed + (size_t)srow[i] * mb + col0;
      const uint32_t byte = rp[c];
      float af[4], bf[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int ga, gb;
        gmrm_decode(byte, k, ga, gb);
        af[k] = (float)ga;
        bf[k] = (float)gb;
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t < T) {
          const float dv = sd[t * B + i], mdv = smd[t * B + i];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[t][k] += dv * af[k] - mdv * bf[k];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if (t < T) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = t * 4 + k;
          if (R == 1) {
            const float nav =
                a.na[(size_t)((a.nt == 1 ? 0 : t) * 4 + k) * mb + col0 + c];
            a.deps[(size_t)p * mb + col0 + c] = nav * acc[t][k];
          } else {
            sred[((size_t)r * T * 4 + p) * ncol + c] = acc[t][k];
          }
        }
      }
    }
  }
  if (R > 1) {
    __syncthreads();
    for (int p = warp; p < T * 4; p += THREADS / 32) {
      const int t = p / 4, k = p % 4;
      for (int c = lane; c < ncol; c += 32) {
        float s = sred[(size_t)p * ncol + c];
        for (int r = 1; r < R; ++r)
          s += sred[((size_t)r * T * 4 + p) * ncol + c];
        const float nav =
            a.na[(size_t)((a.nt == 1 ? 0 : t) * 4 + k) * mb + col0 + c];
        a.deps[(size_t)p * mb + col0 + c] = nav * s;
      }
    }
  }
}

struct Plan {
  int grid;     // CTAs, each with S byte columns
  int S;
  int flags;    // what stays in shared memory
  int smem;     // dynamic shared memory bytes
  const void* kernel;
};

// One CTA per SM at most, S = ceil(mb / SMs) byte columns each; the scan's
// per-marker tables, then the bed slice stay in shared memory while they fit.
cudaError_t plan_block_uncached(int T, int B, int mb, int nt, int K, int W,
                                Plan* p);

// A sharded sweep launches the same shapes once per shard and block step, so
// the last plan is kept: planning asks the runtime half a dozen questions.
cudaError_t plan_block(int T, int B, int mb, int nt, int K, int W, Plan* p) {
  static std::mutex lock;
  static int key[7] = {-1, -1, -1, -1, -1, -1, -1};
  static Plan last;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int want[7] = {T, B, mb, nt, K, W, dev};
  std::lock_guard<std::mutex> guard(lock);
  bool hit = true;
  for (int i = 0; i < 7; ++i) hit = hit && key[i] == want[i];
  if (!hit) {
    err = plan_block_uncached(T, B, mb, nt, K, W, &last);
    if (err != cudaSuccess) {
      key[0] = -1;
      return err;
    }
    for (int i = 0; i < 7; ++i) key[i] = want[i];
  }
  *p = last;
  return cudaSuccess;
}

cudaError_t plan_block_uncached(int T, int B, int mb, int nt, int K, int W,
                                Plan* p) {
  if (T < 1 || T > MAX_T || K < 1 || K > GMRM_MAX_K || W < 1 || B % W != 0 ||
      B < 1 || mb < 1 || (nt != 1 && nt != T))
    return cudaErrorInvalidValue;
  const void* kernels[2][3] = {
      {(const void*)block_sweep_kernel<4, 4>,
       (const void*)block_sweep_kernel<4, 8>,
       (const void*)block_sweep_kernel<4, GMRM_MAX_K>},
      {(const void*)block_sweep_kernel<MAX_T, 4>,
       (const void*)block_sweep_kernel<MAX_T, 8>,
       (const void*)block_sweep_kernel<MAX_T, GMRM_MAX_K>}};
  p->kernel = kernels[T <= 4 ? 0 : 1][K <= 4 ? 0 : K <= 8 ? 1 : 2];
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (sms < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int want = sms < mb ? sms : mb;
  p->S = (mb + want - 1) / want;
  p->grid = (mb + p->S - 1) / p->S;
  p->flags = 0;
  for (int bit : {TAB_SMEM, BED_SMEM}) {
    if (make_layout(T, B, W, K, p->S, p->flags | bit).total <= (size_t)optin)
      p->flags |= bit;
  }
  const size_t total = make_layout(T, B, W, K, p->S, p->flags).total;
  if (total > (size_t)optin) return cudaErrorInvalidValue;
  p->smem = (int)total;
  err = cudaFuncSetAttribute(
      p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
  if (err != cudaSuccess) return err;
  // grid.sync() needs every CTA resident at once.
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, p->kernel, THREADS, (size_t)p->smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < p->grid)
    return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

// out: grid, S, flags (1 bed slice, 2 scan tables in shared memory), dynamic
// shared memory bytes.  No launch.
extern "C" int gmrm_block_sweep_plan(int T, int B, int mb, int nt, int K,
                                     int W, int* out) {
  Plan p;
  const cudaError_t err = plan_block(T, B, mb, nt, K, W, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.grid;
  out[1] = p.S;
  out[2] = p.flags;
  out[3] = p.smem;
  return 0;
}

// scratch: (grid*2*T*B + 2*T*B + T*B*B + T*B) floats.
extern "C" int gmrm_block_sweep(
    const void* blk_b, const void* m_local, const void* bed, const void* win,
    const void* gram, const void* eps, const void* na, const void* mave,
    const void* msig, void* beta, void* comp, void* acum, const void* grp,
    const void* u, const void* z, const void* sigmag, const void* lc,
    const void* rd, const void* sqb, const void* i2se, const void* nonas,
    void* deps, void* scratch, int nb, int T, int B, int mb, int nt, int K,
    int W, int G, void* stream) {
  Plan p;
  cudaError_t err = plan_block(T, B, mb, nt, K, W, &p);
  if (err != cudaSuccess) return (int)err;
  if (nb < 1) return (int)cudaErrorInvalidValue;
  BlockArgs a;
  a.blk_b = (const int*)blk_b;
  a.m_local = (const int*)m_local;
  a.bed = (const uint8_t*)bed;
  a.win = (const int*)win;
  a.gram = (const float*)gram;
  a.eps = (const float*)eps;
  a.na = (const float*)na;
  a.mave = (const float*)mave;
  a.msig = (const float*)msig;
  a.beta = (float*)beta;
  a.comp = (int*)comp;
  a.acum = (float*)acum;
  a.grp = (const int*)grp;
  a.u = (const float*)u;
  a.z = (const float*)z;
  a.sigmag = (const float*)sigmag;
  a.lc = (const float*)lc;
  a.rd = (const float*)rd;
  a.sqb = (const float*)sqb;
  a.i2se = (const float*)i2se;
  a.nonas = (const float*)nonas;
  a.deps = (float*)deps;
  const size_t tb = (size_t)T * B;
  a.part = (float*)scratch;
  a.red = a.part + (size_t)p.grid * 2 * tb;
  a.gs = a.red + 2 * tb;
  a.dbuf = a.gs + tb * B;
  a.nb = nb;
  a.T = T;
  a.B = B;
  a.mb = mb;
  a.nt = nt;
  a.K = K;
  a.W = W;
  a.G = G;
  a.S = p.S;
  a.flags = p.flags;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(p.kernel, dim3(p.grid), dim3(THREADS),
                                    args, (size_t)p.smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
