// The whole marker sweep of wave mode (W > 1) in one launch.
//
// Per processing step b (natural block blk = blkidx[b], marker rows
// blk*B + win[b, i], i the processing position):
//   (1) c[t, i] = msig (A_i . eps_t - mave B_i . eps_t) over all individuals,
//       base = c + beta_old (nonas - 1);
//   (2) the block's cached raw Gram quadrants gathered through win and scaled
//       (sweep_math.cuh);
//   (3) B/W waves of the mixture scan with the rank-W fold of corr;
//   (4) eps[t, k, n] += na[t, k, n] sum_i dbeta msig (a_i - mave b_i);
//   (5) beta, comp, acum written to their natural slots.
// Step b+1's (1) needs step b's (4): the sweep is a serial chain of blocks.
//
// Replaces both _sweep_kernel (gmrm_tpu/ops/sweep_kernel.py:371, call :571)
// and _sweep_kernel_tiled (:576, call :807), wrapper sweep_blocks_pallas
// (:839).  The two TPU kernels differ only in how much of N their fast
// memory holds; here every CTA streams its own slice of N, so one kernel
// serves both regimes.  Not carried over: the bf16 hi/lo split of eps, the
// one-hot matrix permutes of bed rows, marker operands and the Gram (here a
// permute is an indexed load) and the wave-stacked Gram layout.
//
// Bound on the H100: latency.  A sweep moves little (the bed once, 51 MB
// at N=10,000 x Mt=20,000, and the Gram cache once, 41 MB) but is a chain
// of nblocks dependent steps, each with an N-wide reduction, a scan that
// only one CTA can run, and an N-wide update.  So the design keeps
// everything that does not depend on the previous block off that chain:
//   - a persistent cooperative grid, one CTA per SM.  CTA 0 runs the scans;
//     column CTA g owns byte columns [g*S, (g+1)*S) for the whole sweep.
//     Its slice of eps (T x 4 x S) and of na stay in shared memory from the
//     first block to the last, and the block's bed bytes (B x S) are staged
//     in shared memory and read once for (1) and (4).  An explicit size rule
//     (plan_sweep) keeps CTA 0's tables and scaled Gram, then eps, then na,
//     then the bed slice resident as far as the SM's shared memory reaches;
//     what does not fit is read from global memory instead;
//   - phase A, column CTAs: partial sums of (1) over the CTA's columns (a
//     thread per marker row and column part, summed in a fixed order) to a
//     scratch; grid sync; each column CTA sums its share of the 2TB sums
//     over all CTAs' partials in a fixed order (no float atomics, so a chain
//     is reproducible from its seed); grid sync;
//   - phase B, CTA 0: c and base from the sums, then (3) and (5) with every
//     per-marker operand, table and Gram entry in shared memory, and dbeta
//     published.  Meanwhile the column CTAs stage the next block's row
//     order, statistics and bed bytes into a second buffer and build its
//     scaled Gram (2), which does not depend on eps.  Only entries (j, i)
//     with i in a later wave than j are ever read by the fold, so only those
//     are built, packed wave by wave;
//   - grid sync; phase C, column CTAs: (4) on the CTA's eps slice, a thread
//     per byte column and row part.  Meanwhile CTA 0 loads the next block's
//     marker state, draws, per-marker tables and scaled Gram.
// What a CTA runs once per block is paced by instruction fetch as much as by
// data (the kernel's code is larger than the instruction cache), so each
// piece of code has one call site and plain copy loops are not unrolled.
// Buffers written inside the launch (part, red, gsbuf, dbuf) are read with
// __ldcg, never through the non-coherent path.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "decode.cuh"
#include "sweep_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_T = 8;
constexpr int THREADS = 512;
constexpr int MAX_ROW_PARTS = 16;
enum { EPS_SMEM = 1, NA_SMEM = 2, BED_SMEM = 4, TAB_SMEM = 8, GS_SMEM = 16 };

struct SweepArgs {
  const uint8_t* bed;     // (nblocks*B, mb) natural order
  const int* blkidx;      // (nblocks,)
  const int* win;         // (nblocks, B)
  const float* gram;      // (nblocks, nt, 2B, 2B)
  float* eps;             // (T, 4, mb), updated in place
  const float* na;        // (nt, 4, mb)
  const float* mave;      // (T, m_pad) natural order, as msig, beta_old,
  const float* msig;      //   comp_old, acum_old and grp (m_pad,)
  const float* beta_old;
  const int* comp_old;
  const float* acum_old;
  const int* grp;
  const float* u;         // (nblocks, T, B) processing order
  const float* z;
  const float* sigmag;    // (T, G)
  const float* lc;        // (K, T, G)
  const float* rd;
  const float* sqb;
  const float* i2se;      // (T,)
  const float* nonas;     // (T,)
  float* beta_new;        // (T, m_pad) natural order
  int* comp_new;
  float* acum_new;
  float* part;            // (column CTAs, 2T, B) scratch
  float* red;             // (2T, B) scratch: the partials summed
  float* gsbuf;           // (2, T, gs_tot) scratch: packed scaled Gram of
                          //   the block in work and of the next one
  float* dbuf;            // (T, B) scratch
  int nblocks, T, B, mb, nt, K, W, G, m_local, S, flags;
};

// Shared memory offsets in bytes.  CTA 0 (the scan) and the column CTAs lay
// out the same allocation differently; total is the larger of the two.
struct Layout {
  // column CTAs; [2]: the block in work and the next one being staged
  size_t win[2], row[2], mave[2], msig[2], bed[2];
  size_t sd, smd, red, eps, na;
  // CTA 0
  size_t s_row, s_grp, s_comp, s_flag, s_mave, s_msig, s_beta, s_acum, s_u,
      s_z, s_base, s_corr, s_db, s_wdb, s_red, s_lc, s_rd, s_sqb, s_gs;
  size_t total;
  int gs_tot;  // packed scaled-Gram floats per trait
  int SP;   // bed row stride in shared memory
  int P;    // column parts per marker row in phase A
  int R;    // row parts per byte column in phase C
};

// The fold of wave w reads gs[t, j, i] only for j in wave w and i in a later
// wave, so the scaled Gram is kept packed: per trait, wave after wave, W rows
// of B - (w+1)W floats each.
__host__ __device__ inline int gs_wave_offset(int B, int W, int w) {
  return W * (w * B - W * (w * (w + 1) / 2));
}

__host__ __device__ inline Layout make_layout(int T, int B, int W, int K,
                                              int nt, int S, int flags) {
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
  for (int q = 0; q < 2; ++q) {
    L.win[q] = take((size_t)B * 4);
    L.row[q] = take((size_t)B * 4);
    L.mave[q] = take(tb);
    L.msig[q] = take(tb);
    L.bed[q] = take((flags & BED_SMEM) ? (size_t)B * L.SP : 0);
  }
  L.sd = take(tb);
  L.smd = take(tb);
  const size_t red_a = (size_t)L.P * 2 * tb;
  const size_t red_c = L.R > 1 ? (size_t)L.R * T * 4 * S * 4 : 0;
  L.red = take(red_a > red_c ? red_a : red_c);
  L.eps = take((flags & EPS_SMEM) ? (size_t)T * 4 * S * 4 : 0);
  L.na = take((flags & NA_SMEM) ? (size_t)nt * 4 * S * 4 : 0);
  const size_t col_total = off;
  off = 0;
  L.s_row = take((size_t)B * 4);
  L.s_grp = take((size_t)B * 4);
  L.s_comp = take(tb);
  L.s_flag = take(tb);
  L.s_mave = take(tb);
  L.s_msig = take(tb);
  L.s_beta = take(tb);
  L.s_acum = take(tb);
  L.s_u = take(tb);
  L.s_z = take(tb);
  L.s_base = take(tb);
  L.s_corr = take(tb);
  L.s_db = take(tb);
  L.s_wdb = take((size_t)T * W * 4);
  L.s_red = take(2 * tb);
  const size_t tab = (flags & TAB_SMEM) ? (size_t)K * tb : 0;
  L.s_lc = take(tab);
  L.s_rd = take(tab);
  L.s_sqb = take(tab);
  L.gs_tot = gs_wave_offset(B, W, B / W - 1);
  L.s_gs = take((flags & GS_SMEM) ? (size_t)T * L.gs_tot * 4 : 0);
  L.total = off > col_total ? off : col_total;
  return L;
}

// ---- the column CTAs: phases A and C on byte columns [col0, col0 + ncol) --
template <int MT>
__device__ void column_cta(const SweepArgs& a, const Layout& L,
                           cg::grid_group& grid, unsigned char* sm) {
  const int T = a.T, B = a.B, W = a.W, S = a.S, mb = a.mb, SP = L.SP;
  const int TB = T * B;
  const size_t m_pad = (size_t)a.nblocks * B;
  const bool eps_s = a.flags & EPS_SMEM;
  const bool na_s = a.flags & NA_SMEM;
  const bool bed_s = a.flags & BED_SMEM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cta = blockIdx.x - 1;
  const int ncta = gridDim.x - 1;
  const int col0 = cta * S;
  const int ncol = min(S, mb - col0);

  float* sd = (float*)(sm + L.sd);       // msig * dbeta
  float* smd = (float*)(sm + L.smd);     // mave * msig * dbeta
  float* sred = (float*)(sm + L.red);
  float* seps = (float*)(sm + L.eps);
  float* sna = (float*)(sm + L.na);

  // The CTA's view of eps and na: plane p = t*4 + k starts at p * stride.
  float* ep = eps_s ? seps : a.eps + col0;
  const size_t es = eps_s ? (size_t)S : (size_t)mb;
  const float* nap = na_s ? sna : a.na + col0;
  const size_t ns = na_s ? (size_t)S : (size_t)mb;
  if (eps_s) {
    for (int p = warp; p < T * 4; p += THREADS / 32)
      for (int c = lane; c < ncol; c += 32)
        seps[(size_t)p * S + c] = a.eps[(size_t)p * mb + col0 + c];
  }
  if (na_s) {
    for (int p = warp; p < a.nt * 4; p += THREADS / 32)
      for (int c = lane; c < ncol; c += 32)
        sna[(size_t)p * S + c] = a.na[(size_t)p * mb + col0 + c];
  }

  // Block b's row order, marker statistics and bed bytes into buffer q.
  auto stage = [&](int b, int q) {
    int* swin = (int*)(sm + L.win[q]);
    int* srow = (int*)(sm + L.row[q]);
    float* smave = (float*)(sm + L.mave[q]);
    float* smsig = (float*)(sm + L.msig[q]);
    uint8_t* sbed = sm + L.bed[q];
    const int blk = a.blkidx[b];
#pragma unroll 1
    for (int i = tid; i < B; i += THREADS) {
      const int w = a.win[(size_t)b * B + i];
      swin[i] = w;
      srow[i] = blk * B + w;
    }
    __syncthreads();
#pragma unroll 1
    for (int x = tid; x < TB; x += THREADS) {
      const size_t o = (size_t)(x / B) * m_pad + srow[x % B];
      const float va = a.mave[o], vs = a.msig[o];
      smave[x] = va;
      smsig[x] = vs;
    }
    if (bed_s) {
      // Eight rows' loads in flight per warp before the first store: a
      // store to shared memory may alias the next row's load for all the
      // compiler knows, so a plain copy loop waits out every row's latency.
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
  };

  // The CTA's share of block b's scaled Gram, packed, into half b & 1 of
  // gsbuf; from buffer q of the staged block.
  auto gram = [&](int b, int q) {
    const int* swin = (const int*)(sm + L.win[q]);
    const float* smave = (const float*)(sm + L.mave[q]);
    const float* smsig = (const float*)(sm + L.msig[q]);
    const int B2 = 2 * B;
    const size_t quad = (size_t)B2 * B2;
    const float* g0 = a.gram + (size_t)a.blkidx[b] * a.nt * quad;
    float* out = a.gsbuf + (size_t)(b & 1) * T * L.gs_tot;
    // The packed entries are dealt to the threads of all column CTAs, so
    // that each thread makes the four gathered loads of an entry once.
    const int n = T * L.gs_tot;
#pragma unroll 1
    for (int e = cta * THREADS + tid; e < n; e += ncta * THREADS) {
      const int t = e / L.gs_tot;
      int rem = e % L.gs_tot;
      int w = 0;
      while (rem >= W * (B - (w + 1) * W)) {
        rem -= W * (B - (w + 1) * W);
        ++w;
      }
      const int len = B - (w + 1) * W;
      const int j = w * W + rem / len;
      const int i = (w + 1) * W + rem % len;
      const float* g = g0 + (a.nt == 1 ? 0 : t) * quad;
      const int wj = swin[j], wi = swin[i];
      out[e] = gmrm_scale_gram(
          g[(size_t)wj * B2 + wi], g[(size_t)(B + wj) * B2 + wi],
          g[(size_t)wj * B2 + B + wi], g[(size_t)(B + wj) * B2 + B + wi],
          smave[t * B + i], smave[t * B + j], smsig[t * B + i],
          smsig[t * B + j]);
    }
  };

  // Step -1 only stages block 0, so that each piece of code has one call
  // site: the per-block loop is long, and what a CTA runs once per block is
  // paced by instruction fetch.
  for (int b = -1; b < a.nblocks; ++b) {
    const int q = b & 1;
    const int* srow = (const int*)(sm + L.row[q]);
    const float* smave = (const float*)(sm + L.mave[q]);
    const float* smsig = (const float*)(sm + L.msig[q]);
    const uint8_t* sbed = sm + L.bed[q];
    __syncthreads();

    // ---- phase A1: partial sums of A_i . eps_t and B_i . eps_t -----------
    // Thread (i, h): marker row i, part h of the CTA's columns.
    if (b >= 0) {
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
                const float e = ep[(size_t)(t * 4 + k) * es + c];
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
      grid.sync();

      // ---- the partials summed in CTA order, each CTA its share of the 2TB
      // sums: a warp per sum, a lane per 32nd of the partials, then a
      // fixed-order shuffle tree.  No float atomics, so a chain is
      // reproducible from its seed.
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
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) a.red[o] = v;
        }
      }
      grid.sync();
    }

    // While CTA 0 scans: stage the next block and build its scaled Gram.
    if (b + 1 < a.nblocks) {
      stage(b + 1, q ^ 1);
      __syncthreads();
      gram(b + 1, q ^ 1);
    }
    grid.sync();
    if (b < 0) continue;

    // ---- phase C: the residual update of the CTA's columns ----------------
#pragma unroll 1
    for (int x = tid; x < TB; x += THREADS) {
      const float dv = smsig[x] * __ldcg(a.dbuf + x);
      sd[x] = dv;
      smd[x] = smave[x] * dv;
    }
    __syncthreads();
    // Thread (c, r): byte column c, part r of the block's rows.
    {
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
          const uint8_t* rp = bed_s ? sbed + (size_t)i * SP
                                    : a.bed + (size_t)srow[i] * mb + col0;
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
                    nap[(size_t)((a.nt == 1 ? 0 : t) * 4 + k) * ns + c];
                ep[(size_t)p * es + c] += nav * acc[t][k];
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
                nap[(size_t)((a.nt == 1 ? 0 : t) * 4 + k) * ns + c];
            ep[(size_t)p * es + c] += nav * s;
          }
        }
      }
    }
  }

  if (eps_s) {
    __syncthreads();
    for (int p = warp; p < T * 4; p += THREADS / 32)
      for (int c = lane; c < ncol; c += 32)
        a.eps[(size_t)p * mb + col0 + c] = seps[(size_t)p * S + c];
  }
}

// ---- CTA 0: phase B, the scan of every block --------------------------------
template <int MK>
__device__ void scan_cta(const SweepArgs& a, const Layout& L,
                         cg::grid_group& grid, unsigned char* sm) {
  const int T = a.T, B = a.B, W = a.W, K = a.K, G = a.G;
  const int TB = T * B;
  const size_t m_pad = (size_t)a.nblocks * B;
  const int tid = threadIdx.x;
  int* srow = (int*)(sm + L.s_row);
  int* sgrp = (int*)(sm + L.s_grp);
  int* scomp = (int*)(sm + L.s_comp);
  int* sflag = (int*)(sm + L.s_flag);    // bit 0 live, bit 1 zerob
  float* smave = (float*)(sm + L.s_mave);
  float* smsig = (float*)(sm + L.s_msig);
  float* sbeta = (float*)(sm + L.s_beta);
  float* sacum = (float*)(sm + L.s_acum);
  float* su = (float*)(sm + L.s_u);
  float* sz = (float*)(sm + L.s_z);
  float* sbase = (float*)(sm + L.s_base);
  float* scorr = (float*)(sm + L.s_corr);
  float* sdb = (float*)(sm + L.s_db);
  float* swdb = (float*)(sm + L.s_wdb);  // (T, W) this wave's dbeta
  float* sred = (float*)(sm + L.s_red);  // (2T, B)
  // (K, T, B) per-marker copies of the group tables, when they fit.
  const bool tab_s = a.flags & TAB_SMEM;
  float* slc = (float*)(sm + L.s_lc);
  float* srd = (float*)(sm + L.s_rd);
  float* ssqb = (float*)(sm + L.s_sqb);
  // The packed scaled Gram of the block in work, when it fits.
  const bool gs_s = a.flags & GS_SMEM;
  float* sgs = (float*)(sm + L.s_gs);
  const int gs_n = T * L.gs_tot;

  // Block b's marker state in processing order, its draws, and valid, live
  // and zerob from m_local, grp and sigmag
  // (gmrm_tpu/ops/sweep_kernel.py:201-213).
  auto load = [&](int b) {
    const int blk = a.blkidx[b];
#pragma unroll 1
    for (int i = tid; i < B; i += THREADS) {
      const int row = blk * B + a.win[(size_t)b * B + i];
      srow[i] = row;
      sgrp[i] = a.grp[row];
    }
    __syncthreads();
    // Every load of an element before its first store: a store to shared
    // memory may alias the next load for all the compiler knows, and would
    // make each wait out the one before.
#pragma unroll 1
    for (int x = tid; x < TB; x += THREADS) {
      const int t = x / B, i = x % B;
      const size_t o = (size_t)t * m_pad + srow[i];
      const int tg = t * G + sgrp[i];
      const float v_mave = a.mave[o], v_msig = a.msig[o];
      const float v_beta = a.beta_old[o], v_acum = a.acum_old[o];
      const int v_comp = a.comp_old[o];
      const float v_u = a.u[(size_t)b * TB + x], v_z = a.z[(size_t)b * TB + x];
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
      const bool valid = srow[i] < a.m_local;
      smave[x] = v_mave;
      smsig[x] = v_msig;
      sbeta[x] = v_beta;
      sacum[x] = v_acum;
      scomp[x] = v_comp;
      su[x] = v_u;
      sz[x] = v_z;
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
  };

  // Block b's packed scaled Gram, built by the column CTAs before the last
  // grid sync, from L2 into shared memory.
  auto fetch_gs = [&](int b) {
    if (!gs_s) return;
    const float* src = a.gsbuf + (size_t)(b & 1) * gs_n;
    if (gs_n % 4 == 0) {
      for (int x = tid; x < gs_n / 4; x += THREADS)
        ((float4*)sgs)[x] = __ldcg((const float4*)src + x);
    } else {
      for (int x = tid; x < gs_n; x += THREADS) sgs[x] = __ldcg(src + x);
    }
  };

  // Phase B of block b.
  auto scan_block = [&](int b) {
    grid.sync();
    grid.sync();
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
      sbase[x] = __fadd_rn(
          c, __fmul_rn(sbeta[x], __fsub_rn(a.nonas[t], 1.0f)));
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
        const float num = __fadd_rn(sbase[o], scorr[o]);
        const int tg = t * G + sgrp[i];
        const GmrmDraw dr =
            tab_s ? gmrm_wave_draw<MK>(num, a.i2se[t], slc + o, srd + o,
                                       ssqb + o, (size_t)TB, K, su[o], sz[o])
                  : gmrm_wave_draw<MK>(num, a.i2se[t], a.lc + tg, a.rd + tg,
                                       a.sqb + tg, (size_t)T * G, K, su[o],
                                       sz[o]);
        const bool lv = sflag[o] & 1;
        const bool zb = sflag[o] & 2;
        const float bo = sbeta[o];
        const float db = lv ? __fsub_rn(bo, dr.samp) : 0.0f;
        const size_t nat = (size_t)t * m_pad + srow[i];
        a.beta_new[nat] = lv ? dr.samp : (zb ? 0.0f : bo);
        a.comp_new[nat] = lv ? dr.comp : scomp[o];
        a.acum_new[nat] = lv ? dr.acum : (zb ? 1.0f : sacum[o]);
        sdb[o] = db;
        swdb[x] = db;
        moved |= (db != 0.0f);
      }
      // Fold the wave's rank-W correction into the later waves' corr,
      // skipped when nothing moved.
      const bool any = __syncthreads_or(moved);
      const int rest = B - (w0 + W);
      if (any && rest > 0) {
        const int off = gs_wave_offset(B, W, w0 / W);
#pragma unroll 1
        for (int x = tid; x < T * rest; x += THREADS) {
          const int t = x / rest;
          const int i = x % rest;
          const int go = t * L.gs_tot + off + i;
          const float* dw = swdb + t * W;
          float s = 0.0f;
          if (gs_s) {
            const float* g = sgs + go;
#pragma unroll 4
            for (int j = 0; j < W; ++j) s += dw[j] * g[j * rest];
          } else {
            const float* g = a.gsbuf + (size_t)(b & 1) * gs_n + go;
#pragma unroll 4
            for (int j = 0; j < W; ++j) s += dw[j] * __ldcg(g + j * rest);
          }
          scorr[t * B + w0 + W + i] += s;
        }
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int x = tid; x < TB; x += THREADS) a.dbuf[x] = sdb[x];
  };

  // Step -1 only loads block 0, so that each piece of code has one call
  // site (see column_cta).  While the column CTAs update eps, CTA 0 loads
  // the next block's operands.
  for (int b = -1; b < a.nblocks; ++b) {
    if (b >= 0) scan_block(b);
    grid.sync();
    if (b + 1 < a.nblocks) {
      load(b + 1);
      fetch_gs(b + 1);
    }
    __syncthreads();
  }
}

template <int MT, int MK>
__global__ void __launch_bounds__(THREADS)
sweep_blocks_kernel(const SweepArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char sm[];
  const Layout L = make_layout(a.T, a.B, a.W, a.K, a.nt, a.S, a.flags);
  if (blockIdx.x == 0)
    scan_cta<MK>(a, L, grid, sm);
  else
    column_cta<MT>(a, L, grid, sm);
}

struct Plan {
  int grid;     // CTAs: one for the scans plus the column CTAs
  int S;        // byte columns per column CTA
  int flags;    // what stays in shared memory
  int smem;     // dynamic shared memory bytes
  const void* kernel;
};

// One CTA per SM: CTA 0 for the scans, the others with S = ceil(mb / (SMs -
// 1)) byte columns each; CTA 0's per-marker tables and packed scaled Gram,
// then eps, then na, then the two bed-slice buffers stay in shared memory
// while they fit.
cudaError_t plan_sweep(int T, int B, int mb, int nt, int K, int W, Plan* p) {
  if (T < 1 || T > MAX_T || K < 1 || K > GMRM_MAX_K || W < 1 || B % W != 0 ||
      B < 1 || mb < 1 || (nt != 1 && nt != T))
    return cudaErrorInvalidValue;
  // Register arrays sized for T <= 4 or 8 traits and K <= 4, 8 or 16
  // mixture components.
  const void* kernels[2][3] = {
      {(const void*)sweep_blocks_kernel<4, 4>,
       (const void*)sweep_blocks_kernel<4, 8>,
       (const void*)sweep_blocks_kernel<4, GMRM_MAX_K>},
      {(const void*)sweep_blocks_kernel<MAX_T, 4>,
       (const void*)sweep_blocks_kernel<MAX_T, 8>,
       (const void*)sweep_blocks_kernel<MAX_T, GMRM_MAX_K>}};
  p->kernel = kernels[T <= 4 ? 0 : 1][K <= 4 ? 0 : K <= 8 ? 1 : 2];
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (sms < 2) return cudaErrorCooperativeLaunchTooLarge;
  const int want = sms - 1 < mb ? sms - 1 : mb;
  p->S = (mb + want - 1) / want;
  p->grid = 1 + (mb + p->S - 1) / p->S;
  p->flags = 0;
  for (int bit : {TAB_SMEM, GS_SMEM, EPS_SMEM, NA_SMEM, BED_SMEM}) {
    if (make_layout(T, B, W, K, nt, p->S, p->flags | bit).total <=
        (size_t)optin)
      p->flags |= bit;
  }
  const size_t total = make_layout(T, B, W, K, nt, p->S, p->flags).total;
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

// out: grid, S, flags (1 eps, 2 na, 4 bed slice, 8 scan tables, 16 scaled
// Gram in shared memory), dynamic shared memory bytes, eps bytes per column
// CTA, packed scaled-Gram floats per trait.
extern "C" int gmrm_sweep_blocks_plan(int T, int B, int mb, int nt, int K,
                                      int W, int* out) {
  Plan p;
  const cudaError_t err = plan_sweep(T, B, mb, nt, K, W, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.grid;
  out[1] = p.S;
  out[2] = p.flags;
  out[3] = p.smem;
  out[4] = T * 4 * p.S * 4;
  out[5] = make_layout(T, B, W, K, nt, p.S, p.flags).gs_tot;
  return 0;
}

extern "C" int gmrm_sweep_blocks(
    const void* bed, const void* blkidx, const void* win, const void* gram,
    void* eps, const void* na, const void* mave, const void* msig,
    const void* beta_old, const void* comp_old, const void* acum_old,
    const void* grp, const void* u, const void* z, const void* sigmag,
    const void* lc, const void* rd, const void* sqb, const void* i2se,
    const void* nonas, void* beta_new, void* comp_new, void* acum_new,
    void* part, void* red, void* gsbuf, void* dbuf, int nblocks, int T, int B,
    int mb,
    int nt, int K, int W, int G, int m_local, void* stream) {
  Plan p;
  cudaError_t err = plan_sweep(T, B, mb, nt, K, W, &p);
  if (err != cudaSuccess) return (int)err;
  SweepArgs a;
  a.bed = (const uint8_t*)bed;
  a.blkidx = (const int*)blkidx;
  a.win = (const int*)win;
  a.gram = (const float*)gram;
  a.eps = (float*)eps;
  a.na = (const float*)na;
  a.mave = (const float*)mave;
  a.msig = (const float*)msig;
  a.beta_old = (const float*)beta_old;
  a.comp_old = (const int*)comp_old;
  a.acum_old = (const float*)acum_old;
  a.grp = (const int*)grp;
  a.u = (const float*)u;
  a.z = (const float*)z;
  a.sigmag = (const float*)sigmag;
  a.lc = (const float*)lc;
  a.rd = (const float*)rd;
  a.sqb = (const float*)sqb;
  a.i2se = (const float*)i2se;
  a.nonas = (const float*)nonas;
  a.beta_new = (float*)beta_new;
  a.comp_new = (int*)comp_new;
  a.acum_new = (float*)acum_new;
  a.part = (float*)part;
  a.red = (float*)red;
  a.gsbuf = (float*)gsbuf;
  a.dbuf = (float*)dbuf;
  a.nblocks = nblocks;
  a.T = T;
  a.B = B;
  a.mb = mb;
  a.nt = nt;
  a.K = K;
  a.W = W;
  a.G = G;
  a.m_local = m_local;
  a.S = p.S;
  a.flags = p.flags;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(p.kernel, dim3(p.grid), dim3(THREADS),
                                    args, (size_t)p.smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
