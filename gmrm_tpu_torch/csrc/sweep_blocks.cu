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
// only one CTA can run, and an N-wide update.  The arithmetic of a step is
// a fraction of a microsecond spread over 131 SMs; what a step costs is its
// hand-offs between CTAs and the latency of each CTA's passes.  So:
//   - a persistent cooperative grid, one CTA per SM.  CTA 0 runs the scans;
//     column CTA g owns byte columns [g*S, (g+1)*S) for the whole sweep.
//     Its slice of eps (T x 4 x S) and of na stay in shared memory from the
//     first block to the last, and the block's bed bytes (B x S) are staged
//     in shared memory and read once for (1) and (4).  An explicit size rule
//     (plan_sweep) keeps CTA 0's tables and scaled Gram, then eps, then na,
//     then the bed slice resident as far as the SM's shared memory reaches;
//     what does not fit is read from global memory instead;
//   - no grid-wide barrier inside the block loop: grid.sync() runs once,
//     after CTA 0 has zeroed the counters.  The CTAs hand data over through
//     counters in global memory, released at GPU scope by the writer and
//     acquired by the reader, so only the real dependencies wait;
//   - dbeta is handed over wave by wave: CTA 0 publishes each wave's dbeta
//     under an epoch flag as soon as it is drawn, and a column CTA applies
//     (4) for that wave's rows while CTA 0 draws the next wave.  Only the
//     last wave's update is left between the scan and (1) of the next
//     block, which the column CTA runs right after it on its own eps slice;
//   - the partial sums of (1) go up a two-level tree in a fixed order,
//     without float atomics, so a chain is reproducible from its seed: each
//     column CTA publishes its partials and bumps its group's counter; the
//     CTA that arrives last in its group of GROUP column CTAs sums the
//     group's partials in CTA order and bumps the top counter; CTA 0 waits
//     on that and sums the groups' partials in group order;
//   - meanwhile the column CTAs stage the next block's row order,
//     statistics and bed bytes into a second buffer and build its scaled
//     Gram (2), which does not depend on eps, and bump a third counter.  Only
//     entries (j, i) with i in a later wave than j are ever read by the
//     fold, so only those are built, packed wave by wave.  CTA 0 loads the
//     next block's marker state, draws, per-marker tables and scaled Gram
//     while the column CTAs run (4) and (1);
//   - the scan: a thread per marker and trait draws the wave; the last warp
//     publishes it while the others fold the wave's rank-W correction into
//     the next wave's corr (each W-long dot split over up to 8 lanes, a
//     fixed shuffle tree), and the fold into the waves after that runs on
//     the warps that do not draw, during the next wave's draw.  Every corr
//     still receives the folds in wave order.
// What a CTA runs once per block is paced by instruction fetch as much as by
// data (the kernel's code is larger than the instruction cache), so each
// piece of code has one call site and plain copy loops are not unrolled.
// Buffers written inside the launch (partials, dbeta, the scaled Gram) are
// read with __ldcg, never through the non-coherent path.
//
// The tables' K is a template bound of register arrays (4, 8 or 16); a
// larger K takes the instances of bound GMRM_ANY_K, which stage the tables
// 16 components at a time and draw with sweep_math.cuh's
// gmrm_wave_draw_any (no per-component array, the same roundings).
// A launch takes at most MAX_T traits (register arrays).  A run with more
// is launched once a chunk of traits, back to back on the stream, reusing
// one scratch (ops/trait_chunks.py): the traits' chains are independent,
// and the entry point offsets every operand to the chunk's first trait
// t0 and keeps the run's trait count TS as the stride of the operands that
// are not trait-leading (u and z, the tables, a per-trait Gram cache).
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
constexpr int GROUP = 12;       // column CTAs per group of the partials' tree
constexpr int NST = 8;          // %globaltimer stamps per CTA and block
constexpr int LINE = 32;        // 32-bit words per counter (own 128 B line)
enum { EPS_SMEM = 1, NA_SMEM = 2, BED_SMEM = 4, TAB_SMEM = 8, GS_SMEM = 16 };
// The counters, each on its own line of the scratch's sync words: groups
// summed, column CTAs' scaled Grams built, waves of dbeta published, and
// one arrival counter per group.
enum { SYNC_TOP = 0, SYNC_GRAM = 1, SYNC_DBETA = 2, SYNC_GROUPS = 3 };

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
  float* beta_new;        // (T, m_pad) natural order; may be beta_old, as
  int* comp_new;          //   comp_new may be comp_old and acum_new
  float* acum_new;        //   acum_old: a slot is read before it is written
  // Scratch, carved by scratch_layout: the column CTAs' partials
  // (ncta, T, B), the groups' partials (ngroups, T, B), the packed scaled
  // Gram of the block in work and of the next one (2, T, gs_tot), dbeta
  // (T, B) and the counters.
  float* part;
  float* gpart;
  float* gsbuf;
  float* dbuf;
  unsigned* sync;
  unsigned long long* stamps;  // (grid, nblocks + 1, NST) or null
  int nblocks, T, B, mb, nt, K, W, G, m_local, S, flags;
  int TS;   // the run's traits: u and z are (nblocks, TS, B), the tables
            //   (K, TS, G) and a Gram cache of a mask a trait (nblocks, TS,
            //   2B, 2B), each offset to the chunk's first trait
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 records the global timer as event e of block b (row b + 1; row 0
// is left for a prologue) in the instantiation for a stamp buffer, ST; the
// training instantiation has no trace of it.
template <bool ST>
__device__ __forceinline__ void stamp(const SweepArgs& a, int b, int e) {
  if (ST && threadIdx.x == 0 && b < a.nblocks)
    a.stamps[((size_t)blockIdx.x * (a.nblocks + 1) + (b + 1)) * NST + e] =
        global_ns();
}

// The hand-offs, as CUTLASS's generic barrier makes them: the CTA's threads
// write, __syncthreads(), then thread 0 releases at GPU scope; a waiting
// CTA's thread 0 spins on an acquire load, then __syncthreads().
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Every thread of the CTA returns once *p >= target.  A whole sweep takes
// milliseconds, so a hand-off that has not come in 4 s means a broken
// protocol: the kernel traps, and the launch fails, rather than hang.
__device__ __forceinline__ void wait_geq(const unsigned* p, unsigned target) {
  if (threadIdx.x == 0 && ld_acquire(p) < target) {
    const unsigned long long t0 = global_ns();
    while (ld_acquire(p) < target)
      if (global_ns() - t0 > 4000000000ull) __trap();
  }
  __syncthreads();
}

// Shared memory offsets in bytes.  CTA 0 (the scan) and the column CTAs lay
// out the same allocation differently; total is the larger of the two.
struct Layout {
  // column CTAs; [2]: buffers of alternate blocks
  size_t win[2], row[2], mave[2], msig[2], bed[2];
  size_t sd, smd, red, eps, na, last;
  // CTA 0
  size_t s_row, s_grp, s_comp, s_flag, s_mave, s_msig, s_beta, s_acum, s_u,
      s_z, s_base, s_corr, s_wdb, s_lc, s_rd, s_sqb, s_gs;
  size_t total;
  int gs_tot;  // packed scaled-Gram floats per trait
  int SP;   // bed row stride in shared memory
  int P;    // column parts per marker row in phase A
  int R;    // row parts of a wave per byte column in phase C
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
  if (L.R > W) L.R = W;
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
  L.last = take(4);
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
  L.s_wdb = take((size_t)2 * T * W * 4);
  const size_t tab = (flags & TAB_SMEM) ? (size_t)K * tb : 0;
  L.s_lc = take(tab);
  L.s_rd = take(tab);
  L.s_sqb = take(tab);
  L.gs_tot = gs_wave_offset(B, W, B / W - 1);
  L.s_gs = take((flags & GS_SMEM) ? (size_t)T * L.gs_tot * 4 : 0);
  L.total = off > col_total ? off : col_total;
  return L;
}

// Scratch offsets in 4-byte words, each piece starting on its own line.
struct Scratch {
  size_t part, gpart, gsbuf, dbuf, sync, total;
};

__host__ __device__ inline Scratch scratch_layout(int ncta, int T, int B,
                                                  int gs_tot) {
  Scratch s;
  size_t off = 0;
  auto take = [&off](size_t words) {
    const size_t o = off;
    off += (words + LINE - 1) / LINE * LINE;
    return o;
  };
  const int ngroups = (ncta + GROUP - 1) / GROUP;
  const size_t tb = (size_t)T * B;
  s.part = take((size_t)ncta * tb);
  s.gpart = take((size_t)ngroups * tb);
  s.gsbuf = take(2 * (size_t)T * (gs_tot > 0 ? gs_tot : 1));
  s.dbuf = take(tb);
  s.sync = take((size_t)(SYNC_GROUPS + ngroups) * LINE);
  s.total = off;
  return s;
}

// ---- the column CTAs: phases C and A on byte columns [col0, col0 + ncol) --
// RES: eps, na and the bed slice all in shared memory (every panel up to
// about N = 1.5M at T = 4).  The pointers are then known to be shared at
// compile time, so the passes use shared-memory loads rather than generic
// ones; the other residencies take the generic instantiation.
template <int MT, bool RES, bool ST>
__device__ void column_cta(const SweepArgs& a, const Layout& L,
                           unsigned char* sm) {
  const int T = a.T, B = a.B, W = a.W, S = a.S, mb = a.mb, SP = L.SP;
  const int TB = T * B;
  const int nw = B / W;
  const size_t m_pad = (size_t)a.nblocks * B;
  const bool eps_s = RES || (a.flags & EPS_SMEM);
  const bool na_s = RES || (a.flags & NA_SMEM);
  const bool bed_s = RES || (a.flags & BED_SMEM);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cta = blockIdx.x - 1;
  const int ncta = gridDim.x - 1;
  const int col0 = cta * S;
  const int ncol = min(S, mb - col0);
  const int group = cta / GROUP;
  const int gsize = min(GROUP, ncta - group * GROUP);
  unsigned* gcount = a.sync + (SYNC_GROUPS + group) * LINE;
  // Whether this CTA arrived last in its group, for the whole CTA.
  int& last_of_group = *(int*)(sm + L.last);

  float* sd = (float*)(sm + L.sd);       // msig * dbeta
  float* smd = (float*)(sm + L.smd);     // mave * msig * dbeta
  float* sred = (float*)(sm + L.red);
  float* seps = (float*)(sm + L.eps);
  float* sna = (float*)(sm + L.na);

  // The CTA's view of eps and na: plane p = t*4 + k starts at p * stride.
  float* ep = eps_s ? seps : a.eps + col0;
  const int es = eps_s ? S : mb;
  const float* nap = na_s ? sna : a.na + col0;
  const int ns = na_s ? S : mb;
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
    const float* g0 =
        a.gram + (size_t)a.blkidx[b] * (a.nt == 1 ? 1 : a.TS) * quad;
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

  // (4) for wave w of the block in buffer q: eps += na X_w (msig dbeta_w),
  // once CTA 0 has published the wave (flag value `epoch`).  Thread (c, r):
  // byte column c, part r of the wave's rows.
  auto update = [&](int w, int q, unsigned epoch) {
    const int* srow = (const int*)(sm + L.row[q]);
    const float* smave = (const float*)(sm + L.mave[q]);
    const float* smsig = (const float*)(sm + L.msig[q]);
    const uint8_t* sbed = sm + L.bed[q];
    wait_geq(a.sync + SYNC_DBETA * LINE, epoch);
    const int w0 = w * W;
#pragma unroll 1
    for (int x = tid; x < T * W; x += THREADS) {
      const int o = (x / W) * B + w0 + x % W;
      const float dv = smsig[o] * __ldcg(a.dbuf + o);
      sd[o] = dv;
      smd[o] = smave[o] * dv;
    }
    __syncthreads();
    const int R = L.R;
    const int rw = (W + R - 1) / R;
#pragma unroll 1
    for (int x = tid; x < ncol * R; x += THREADS) {
      const int c = x % ncol, r = x / ncol;
      const int i1 = w0 + min(W, (r + 1) * rw);
      float acc[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[t][k] = 0.0f;
#pragma unroll 2
      for (int i = w0 + r * rw; i < i1; ++i) {
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
                  nap[((a.nt == 1 ? 0 : t) * 4 + k) * ns + c];
              ep[p * es + c] += nav * acc[t][k];
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
              nap[((a.nt == 1 ? 0 : t) * 4 + k) * ns + c];
          ep[p * es + c] += nav * s;
        }
      }
    }
    __syncthreads();
  };

  // Block 0 and its scaled Gram before the loop.
  stage(0, 0);
  __syncthreads();
  gram(0, 0);
  __syncthreads();
  if (tid == 0) red_release(a.sync + SYNC_GRAM * LINE, 1);

  // Step b: (4) of block b-1 wave by wave, (1) of block b, its partials
  // published, then block b+1 staged.  Step nblocks runs (4) of the last
  // block only.
  for (int b = 0; b <= a.nblocks; ++b) {
    const int q = b & 1;
    stamp<ST>(a, b, 0);
    if (b > 0) {
      for (int w = 0; w < nw; ++w) {
        if (w == nw - 1) stamp<ST>(a, b, 1);
        update(w, q ^ 1, (unsigned)((b - 1) * nw + w + 1));
      }
    }
    stamp<ST>(a, b, 2);
    if (b == a.nblocks) break;

    // ---- phase A: partial sums of A_i . eps_t - mave B_i . eps_t ----------
    // Thread (i, h): marker row i, part h of the CTA's columns.
    {
      const int* srow = (const int*)(sm + L.row[q]);
      const float* smave = (const float*)(sm + L.mave[q]);
      const uint8_t* sbed = sm + L.bed[q];
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
#pragma unroll 2
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
                const float e = ep[(t * 4 + k) * es + c];
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
      stamp<ST>(a, b, 3);
      float* out = a.part + (size_t)cta * TB;
#pragma unroll 1
      for (int o = tid; o < TB; o += THREADS) {
        const int t = o / B, i = o % B;
        float s_a = sred[(2 * t) * B + i], s_b = sred[(2 * t + 1) * B + i];
        for (int h = 1; h < P; ++h) {
          s_a += sred[((size_t)h * 2 * T + 2 * t) * B + i];
          s_b += sred[((size_t)h * 2 * T + 2 * t + 1) * B + i];
        }
        out[o] = __fsub_rn(s_a, __fmul_rn(smave[o], s_b));
      }
      __syncthreads();
      if (tid == 0)
        last_of_group = atom_add_acq_rel(gcount, 1) ==
                        (unsigned)((b + 1) * gsize - 1);
      __syncthreads();
    }
    stamp<ST>(a, b, 4);

    // ---- the last CTA of the group sums the group's partials --------------
    if (last_of_group) {
      const float* src = a.part + (size_t)group * GROUP * TB;
      float* dst = a.gpart + (size_t)group * TB;
#pragma unroll 1
      for (int o = tid; o < TB; o += THREADS) {
        float s = __ldcg(src + o);
        for (int m = 1; m < gsize; ++m) s += __ldcg(src + (size_t)m * TB + o);
        dst[o] = s;
      }
      __syncthreads();
      if (tid == 0) red_release(a.sync + SYNC_TOP * LINE, 1);
    }
    stamp<ST>(a, b, 5);

    // ---- while CTA 0 scans: stage block b+1 and build its scaled Gram -----
    if (b + 1 < a.nblocks) {
      stage(b + 1, q ^ 1);
      __syncthreads();
      gram(b + 1, q ^ 1);
      __syncthreads();
      if (tid == 0) red_release(a.sync + SYNC_GRAM * LINE, 1);
    }
    stamp<ST>(a, b, 6);
  }

  if (eps_s) {
    __syncthreads();
    for (int p = warp; p < T * 4; p += THREADS / 32)
      for (int c = lane; c < ncol; c += 32)
        a.eps[(size_t)p * mb + col0 + c] = seps[(size_t)p * S + c];
  }
}

// ---- CTA 0: phase B, the scan of every block --------------------------------
template <int MK, bool ST>
__device__ void scan_cta(const SweepArgs& a, const Layout& L,
                         unsigned char* sm) {
  const int T = a.T, B = a.B, W = a.W, K = a.K, G = a.G;
  const int TB = T * B;
  const int nw = B / W;
  const size_t m_pad = (size_t)a.nblocks * B;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ncta = gridDim.x - 1;
  const int ngroups = (ncta + GROUP - 1) / GROUP;
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
  float* swdb = (float*)(sm + L.s_wdb);  // (2, T, W) two waves' dbeta
  int b_cur = 0;                         // the block in work
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
      const size_t ux = (size_t)b * a.TS * B + x;
      const float v_u = a.u[ux], v_z = a.z[ux];
      const bool adav = a.sigmag[tg] == 0.0f;
      // Any K (MK = GMRM_ANY_K): the tables are staged below, in chunks.
      constexpr int MR = MK == GMRM_ANY_K ? GMRM_MAX_K : MK;
      float tl[MR], tr[MR], ts[MR];
#pragma unroll
      for (int k = 0; k < MK; ++k) {
        if (tab_s && k < K) {
          const size_t s = (size_t)k * a.TS * G + tg;
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
      if constexpr (MK == GMRM_ANY_K) {
        // MR components at a time, each chunk's loads before its stores.
#pragma unroll 1
        for (int k0 = 0; tab_s && k0 < K; k0 += MR) {
#pragma unroll
          for (int k = 0; k < MR; ++k) {
            if (k0 + k < K) {
              const size_t s = (size_t)(k0 + k) * a.TS * G + tg;
              tl[k] = a.lc[s];
              tr[k] = a.rd[s];
              ts[k] = a.sqb[s];
            }
          }
#pragma unroll
          for (int k = 0; k < MR; ++k) {
            if (k0 + k < K) {
              slc[(k0 + k) * TB + x] = tl[k];
              srd[(k0 + k) * TB + x] = tr[k];
              ssqb[(k0 + k) * TB + x] = ts[k];
            }
          }
        }
      }
    }
  };

  // Block b's packed scaled Gram, once the column CTAs have built it, from
  // L2 into shared memory.
  auto fetch_gs = [&](int b) {
    wait_geq(a.sync + SYNC_GRAM * LINE, (unsigned)((b + 1) * ncta));
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
  // Whether the last warp draws nothing and can publish each wave, and
  // whether warps are left between the drawing warps and it to fold in the
  // background.
  constexpr int NWARPS = THREADS / 32;
  const int draw_warps = (T * W + 31) / 32;
  const bool pub_warp = draw_warps < NWARPS;
  const bool bg_fold = draw_warps < NWARPS - 1;
  const int folders = pub_warp ? THREADS - 32 : THREADS;
  int any_prev = 0;

  // Fold wave w's rank-W correction (its dbeta in swdb half w & 1) into
  // corr of the later waves' markers i in [i0, i1) (counted from the first
  // marker after wave w), on `nthr` threads from warp `warp0` on.  `split`
  // neighbouring lanes share an output, each a fixed slice of the W terms
  // summed in order, then a shuffle tree; split is the largest power of two
  // up to 8 that keeps the fold to one pass.  Whole warps run the loop, so
  // every shuffle has all its lanes.  Only the Gram entries (j, i) with i in
  // a later wave are read.
  auto fold = [&](int w, int i0, int i1, int warp0, int nthr) {
    const int rest = B - (w + 1) * W;
    const int cols = i1 - i0;
    const int off = gs_wave_offset(B, W, w);
    const float* sw = swdb + (w & 1) * T * W;
    int split = 1;
    while (split < 8 && T * cols * split * 2 <= nthr) split *= 2;
    const int jw = (W + split - 1) / split;
    const int n = T * cols * split;
#pragma unroll 1
    for (int x0 = (warp - warp0) * 32; x0 < n; x0 += nthr) {
      const int x = x0 + lane;
      const int o = x / split, h = x % split;
      const int t = o / cols, i = i0 + o % cols;
      float s = 0.0f;
      if (x < n) {
        const int j0 = h * jw, j1 = min(W, j0 + jw);
        const int go = t * L.gs_tot + off + i;
        const float* dw = sw + t * W;
        if (gs_s) {
          const float* g = sgs + go;
#pragma unroll 4
          for (int j = j0; j < j1; ++j) s += dw[j] * g[j * rest];
        } else {
          const float* g = a.gsbuf + (size_t)(b_cur & 1) * gs_n + go;
#pragma unroll 4
          for (int j = j0; j < j1; ++j) s += dw[j] * __ldcg(g + j * rest);
        }
      }
      for (int d = 1; d < split; d <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, d);
      if (x < n && h == 0) scorr[t * B + (w + 1) * W + i] += s;
    }
  };

  auto scan_block = [&](int b) {
    b_cur = b;
    wait_geq(a.sync + SYNC_TOP * LINE, (unsigned)((b + 1) * ngroups));
    stamp<ST>(a, b, 1);
#pragma unroll 1
    for (int x = tid; x < TB; x += THREADS) {
      const int t = x / B;
      float s = __ldcg(a.gpart + x);
      for (int g = 1; g < ngroups; ++g)
        s += __ldcg(a.gpart + (size_t)g * TB + x);
      const float c = __fmul_rn(smsig[x], s);
      sbase[x] = __fadd_rn(
          c, __fmul_rn(sbeta[x], __fsub_rn(a.nonas[t], 1.0f)));
      scorr[x] = 0.0f;
    }
    __syncthreads();
    stamp<ST>(a, b, 2);

#pragma unroll 1
    for (int w = 0; w < nw; ++w) {
      const int w0 = w * W;
      float* sw = swdb + (w & 1) * T * W;  // this wave's dbeta, (T, W)
      int moved = 0;
#pragma unroll 1
      for (int x = tid; x < T * W; x += THREADS) {
        const int t = x / W;
        const int i = w0 + x % W;
        const int o = t * B + i;
        const float num = __fadd_rn(sbase[o], scorr[o]);
        const int tg = t * G + sgrp[i];
        const GmrmDraw dr =
            tab_s ? gmrm_draw<MK>(num, a.i2se[t], slc + o, srd + o, ssqb + o,
                                  (size_t)TB, K, su[o], sz[o])
                  : gmrm_draw<MK>(num, a.i2se[t], a.lc + tg, a.rd + tg,
                                  a.sqb + tg, (size_t)a.TS * G, K, su[o],
                                  sz[o]);
        const bool lv = sflag[o] & 1;
        const bool zb = sflag[o] & 2;
        const float bo = sbeta[o];
        const float db = lv ? __fsub_rn(bo, dr.samp) : 0.0f;
        const size_t nat = (size_t)t * m_pad + srow[i];
        a.beta_new[nat] = lv ? dr.samp : (zb ? 0.0f : bo);
        a.comp_new[nat] = lv ? dr.comp : scomp[o];
        a.acum_new[nat] = lv ? dr.acum : (zb ? 1.0f : sacum[o]);
        a.dbuf[o] = db;
        sw[x] = db;
        moved |= (db != 0.0f);
      }
      // Meanwhile the warps that draw nothing fold the wave before into
      // the waves after this one.
      if (bg_fold && warp >= draw_warps && warp < NWARPS - 1 && w >= 1 &&
          any_prev && w + 1 < nw)
        fold(w - 1, W, B - w0, draw_warps, THREADS - 32 * (draw_warps + 1));
      // The wave's dbeta is written: publish it to the column CTAs, which
      // update eps with it while the later waves are drawn.  A release
      // waits until the CTA's writes have reached L2, so when the draw
      // leaves the last warp free, that warp publishes while the others
      // fold, off the scan's chain.
      const bool any = __syncthreads_or(moved);
      if (w == 0) stamp<ST>(a, b, 3);
      const unsigned epoch = (unsigned)(b * nw + w + 1);
      if (pub_warp && warp == NWARPS - 1) {
        if (lane == 0) st_release(a.sync + SYNC_DBETA * LINE, epoch);
        continue;
      }
      if (!pub_warp && tid == 0)
        st_release(a.sync + SYNC_DBETA * LINE, epoch);
      // The fold the next wave's draw waits for: this wave into the next
      // one (into every later one when no warp is free to fold in the
      // background).
      if (any && w + 1 < nw)
        fold(w, 0, bg_fold ? W : B - w0 - W, 0, folders);
      // The folding threads only: the publishing warp may still wait on
      // its release, and draws nothing.
      if (pub_warp)
        asm volatile("bar.sync 1, %0;" ::"r"(THREADS - 32) : "memory");
      else
        __syncthreads();
      any_prev = any;
      if (w == 0) stamp<ST>(a, b, 4);
    }
    stamp<ST>(a, b, 5);
  };

  // While the column CTAs run (4) and (1), load the next block's operands.
  load(0);
  fetch_gs(0);
  __syncthreads();
  for (int b = 0; b < a.nblocks; ++b) {
    stamp<ST>(a, b, 0);
    scan_block(b);
    if (b + 1 < a.nblocks) {
      load(b + 1);
      fetch_gs(b + 1);
    }
    __syncthreads();
    stamp<ST>(a, b, 6);
  }
}

template <int MT, int MK, bool ST>
__global__ void __launch_bounds__(THREADS)
sweep_blocks_kernel(const SweepArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char sm[];
  const Layout L = make_layout(a.T, a.B, a.W, a.K, a.nt, a.S, a.flags);
  // The counters start at 0 in every launch: the one grid-wide barrier.
  if (blockIdx.x == 0) {
    const int ngroups = (gridDim.x - 1 + GROUP - 1) / GROUP;
    for (int x = threadIdx.x; x < (SYNC_GROUPS + ngroups) * LINE;
         x += THREADS)
      a.sync[x] = 0;
  }
  grid.sync();
  constexpr int RESIDENT = EPS_SMEM | NA_SMEM | BED_SMEM;
  if (blockIdx.x == 0)
    scan_cta<MK, ST>(a, L, sm);
  else if ((a.flags & RESIDENT) == RESIDENT)
    column_cta<MT, true, ST>(a, L, sm);
  else
    column_cta<MT, false, ST>(a, L, sm);
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
template <bool ST>
const void* pick_kernel(int T, int K) {
  // Register arrays sized for T <= 4 or 8 traits and K <= 4, 8 or 16
  // mixture components; any larger K takes the instances of GMRM_ANY_K.
  const void* kernels[2][4] = {
      {(const void*)sweep_blocks_kernel<4, 4, ST>,
       (const void*)sweep_blocks_kernel<4, 8, ST>,
       (const void*)sweep_blocks_kernel<4, GMRM_MAX_K, ST>,
       (const void*)sweep_blocks_kernel<4, GMRM_ANY_K, ST>},
      {(const void*)sweep_blocks_kernel<MAX_T, 4, ST>,
       (const void*)sweep_blocks_kernel<MAX_T, 8, ST>,
       (const void*)sweep_blocks_kernel<MAX_T, GMRM_MAX_K, ST>,
       (const void*)sweep_blocks_kernel<MAX_T, GMRM_ANY_K, ST>}};
  return kernels[T <= 4 ? 0 : 1]
                 [K <= 4 ? 0 : K <= 8 ? 1 : K <= GMRM_MAX_K ? 2 : 3];
}

cudaError_t plan_sweep(int T, int B, int mb, int nt, int K, int W,
                       bool stamped, Plan* p) {
  if (T < 1 || T > MAX_T || K < 1 || W < 1 || B % W != 0 ||
      B < 1 || mb < 1 || (nt != 1 && nt != T))
    return cudaErrorInvalidValue;
  p->kernel = stamped ? pick_kernel<true>(T, K) : pick_kernel<false>(T, K);
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
  // The hand-offs spin-wait on other CTAs: every CTA must be resident at
  // once, which the cooperative launch guarantees or refuses.
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
// CTA, packed scaled-Gram floats per trait, scratch bytes.
extern "C" int gmrm_sweep_blocks_plan(int T, int B, int mb, int nt, int K,
                                      int W, int* out) {
  Plan p;
  const cudaError_t err = plan_sweep(T, B, mb, nt, K, W, false, &p);
  if (err != cudaSuccess) return (int)err;
  const int gs_tot = make_layout(T, B, W, K, nt, p.S, p.flags).gs_tot;
  out[0] = p.grid;
  out[1] = p.S;
  out[2] = p.flags;
  out[3] = p.smem;
  out[4] = T * 4 * p.S * 4;
  out[5] = gs_tot;
  out[6] = (int)(4 * scratch_layout(p.grid - 1, T, B, gs_tot).total);
  return 0;
}

// Traits t0 .. t0 + T - 1 of a run of TS traits (t0 = 0, T = TS: the whole
// run): every operand is the run's (nt = 1 or TS masks), and the launch
// reads and writes the chunk's traits only.
extern "C" int gmrm_sweep_blocks(
    const void* bed, const void* blkidx, const void* win, const void* gram,
    void* eps, const void* na, const void* mave, const void* msig,
    const void* beta_old, const void* comp_old, const void* acum_old,
    const void* grp, const void* u, const void* z, const void* sigmag,
    const void* lc, const void* rd, const void* sqb, const void* i2se,
    const void* nonas, void* beta_new, void* comp_new, void* acum_new,
    void* scratch, void* stamps, int nblocks, int T, int B, int mb, int nt,
    int K, int W, int G, int m_local, int t0, int TS, void* stream) {
  if (t0 < 0 || TS < 1 || t0 + T > TS || (nt != 1 && nt != TS))
    return (int)cudaErrorInvalidValue;
  const int ntc = nt == 1 ? 1 : T;   // the chunk's masks
  Plan p;
  cudaError_t err = plan_sweep(T, B, mb, ntc, K, W, stamps != nullptr, &p);
  if (err != cudaSuccess) return (int)err;
  const size_t m_pad = (size_t)nblocks * B, quad = (size_t)4 * B * B;
  const size_t tm = (size_t)t0 * m_pad, tp = (size_t)t0 * 4 * mb;
  const size_t tg = (size_t)t0 * G;
  SweepArgs a;
  a.bed = (const uint8_t*)bed;
  a.blkidx = (const int*)blkidx;
  a.win = (const int*)win;
  a.gram = (const float*)gram + (nt == 1 ? 0 : (size_t)t0 * quad);
  a.eps = (float*)eps + tp;
  a.na = (const float*)na + (nt == 1 ? 0 : tp);
  a.mave = (const float*)mave + tm;
  a.msig = (const float*)msig + tm;
  a.beta_old = (const float*)beta_old + tm;
  a.comp_old = (const int*)comp_old + tm;
  a.acum_old = (const float*)acum_old + tm;
  a.grp = (const int*)grp;
  a.u = (const float*)u + (size_t)t0 * B;
  a.z = (const float*)z + (size_t)t0 * B;
  a.sigmag = (const float*)sigmag + tg;
  a.lc = (const float*)lc + tg;
  a.rd = (const float*)rd + tg;
  a.sqb = (const float*)sqb + tg;
  a.i2se = (const float*)i2se + t0;
  a.nonas = (const float*)nonas + t0;
  a.beta_new = (float*)beta_new + tm;
  a.comp_new = (int*)comp_new + tm;
  a.acum_new = (float*)acum_new + tm;
  const Scratch s = scratch_layout(
      p.grid - 1, T, B, make_layout(T, B, W, K, ntc, p.S, p.flags).gs_tot);
  float* f = (float*)scratch;
  a.part = f + s.part;
  a.gpart = f + s.gpart;
  a.gsbuf = f + s.gsbuf;
  a.dbuf = f + s.dbuf;
  a.sync = (unsigned*)(f + s.sync);
  a.stamps = (unsigned long long*)stamps;
  a.nblocks = nblocks;
  a.T = T;
  a.B = B;
  a.mb = mb;
  a.nt = ntc;
  a.K = K;
  a.W = W;
  a.G = G;
  a.m_local = m_local;
  a.S = p.S;
  a.flags = p.flags;
  a.TS = TS;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(p.kernel, dim3(p.grid), dim3(THREADS),
                                    args, (size_t)p.smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
