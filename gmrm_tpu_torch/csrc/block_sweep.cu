// One block step of the marker-sharded wave-mode sweep (W > 1) for all of a
// process's local shards in one launch.  Every shard sweeps its own natural
// block against the one residual eps; the launch sums the shards' residual
// deltas in shard order and either writes that local sum (out mode: the
// caller sums it over processes and adds it into eps) or adds it into eps
// itself (in-place mode: no process group, so the sum over processes is the
// identity).
//
// For local shard s, natural block blk = blk_s[step], marker rows
// blk*B + win_s[step, i], i the processing position:
//   (1) c[t, i] = msig (A_i . eps_t - mave B_i . eps_t) over all individuals,
//       base = c + beta_old (nonas - 1);
//   (2) the block's cached raw Gram quadrants gathered through win and scaled
//       (sweep_math.cuh);
//   (3) B/W waves of the mixture scan with the rank-W fold of corr;
//   (4) d_s[t, k, n] = na[t, k, n] sum_i dbeta msig (a_i - mave b_i);
//   (5) beta, comp, acum of the block updated in place, in their natural
//       slots.
// Then sum = ((d_0 + d_1) + d_2) + ..., onto the previous launch's sum when
// one step of many shards is split into several launches, and
// out = sum (every element written) or eps = eps + sum.
//
// Replaces _block_sweep_kernel (gmrm_tpu/ops/sweep_kernel.py:961, call :1082,
// wrapper block_sweep_pallas :1104), which runs one shard's block per call;
// the shards of one device there are the devices of a mesh.  Not carried
// over: the one-hot matrix permute of the bed rows (here an index load), the
// bf16 hi/lo splits, the lane tiling and the B <= 512 / G <= 256 ceilings.
//
// Bound on the H100: latency.  One shard's block moves ~1 MB (the bed rows,
// the raw Gram, eps and the delta) and does ~42 Mflop, under a microsecond
// of either; what a step costs is its chain of hand-offs: the c-dot's
// reduction over N, a scan that one CTA runs, and the update.  So, one CTA
// of 512 threads an SM, as csrc/sweep_blocks.cu has it:
//   - column CTAs: CTA g owns byte columns [g*span, (g+1)*span) of the
//     residual for every local shard, span the fewest bytes, a multiple of
//     4, that spread the residual over the SMs left beside the scan CTAs
//     (20 at the anchor: 128 CTAs).  It takes them in tiles of C columns,
//     C the widest that leaves every shard's slices of a tile in shared
//     memory (one tile, C = span, unless the panel is wide).  For each tile
//     it stages every shard's B bed rows, their statistics and the slices
//     of eps and na in one round of cp.async copies and adds each shard's
//     centred c-dot partial of the tile to its sums; then it sends the
//     partials of all shards up a fixed-order two-level tree of int tickets
//     at once (block_passes.cuh: the last CTA of a group of GROUP sums the
//     group in CTA order; the last group tells the scan), and builds its
//     share of every shard's scaled Gram, the entries (j, i) that the fold
//     reads (i in a later wave than j), which do not depend on eps;
//   - scan CTAs, one per local shard, on other SMs at the same time.  While
//     the column CTAs work, a scan CTA loads its shard's marker state, draws
//     and per-marker tables; then it waits for its shard's groups, sums them
//     in group order into c and base, and draws the waves as sweep_blocks.cu
//     does, publishing each wave's dbeta under a flag as soon as it is
//     drawn.  The scaled Gram is first read by the fold of the first wave:
//     only there does the scan CTA wait for it, and copy it into shared
//     memory where it fits;
//   - each column CTA applies each wave of every shard as it arrives into a
//     per-shard accumulator of its last tile, the one left staged, so that
//     after the last wave only that wave's update is left, then sums the
//     shards in shard order and writes the sum or adds it into eps.  Its
//     other tiles, on a wide panel, are staged again (from L2) once every
//     wave is in and take the same passes.  A column CTA is the only reader
//     and writer of its eps columns within the launch, and the next block
//     step is the next launch.
//   - from 256 / T byte columns a tile (and from 128 at any T: mma_passes,
//     kernel 7/8's rule), the column passes (1) and (4) run on the tensor
//     cores, an instance of their own (column_cta_mma), in kernel 7/8's
//     form: mma.sync m16n8k16 with bf16 inputs and float32 accumulators,
//     the bed's 2-bit codes decoded straight into genotype fragments by
//     byte permutes (a in {0, 1, 2}, b in {0, 1}: exact in bf16), the
//     float operand (eps in (1), msig dbeta and mave msig dbeta in (4))
//     split into three bf16 parts whose sum is the float exactly (split3),
//     so every product is exact and only the float32 sums round; the traits
//     in the product's N, so that each code is decoded once for all traits;
//     the three parts' sums added in a fixed order.  eps is new at every
//     step (the sum over processes comes between launches), so a column
//     CTA splits its slice as it stages it.  Only (1) reads the parts and
//     (4) reads no eps, so each shard's delta accumulates over the waves in
//     the bytes the parts held, and nothing float of eps or na is staged:
//     the sum's write reads na, and in place eps, from global memory.  That
//     keeps the UK Biobank shard's 768 columns a column CTA in one tile.
//     Below the rule, where each warp's share is too short a chain to pay,
//     the passes run on the CUDA cores as described above;
// No grid-wide barrier, and nothing for the host to reset: each ticket's
// last arrival zeroes it, and the last CTA to finish zeroes the flags, so
// the next launch, or a replay of a captured one, finds the scratch as the
// first launch found it.  The readers spin, so every CTA must be resident: a
// cooperative launch on a grid checked against occupancy; a hand-off that
// has not come in 4 s traps instead of hanging.  No float atomics and every
// sum in a fixed order: a step, and with it a chain, is reproducible bit for
// bit, and a step split over several launches gives the bits of one launch.
// _rn intrinsics and IEEE expf in the draw and the Gram scaling, so comp
// equals the plain version's.  The scan is a copy of csrc/sweep_blocks.cu's,
// not shared with it: moving the draw into a shared header once changed the
// schedule of wave_scan.cu and nearly doubled its time (see sweep_math.cuh).
// The tensor-core helpers (decode_pairs, split3, tile_sums, mma_bf16,
// part_plane) are copies of csrc/sweep_blocks.cu's for the same reason.
// With a stamp buffer, thread 0 of every CTA records %globaltimer at the
// events of BLOCK_STEP_STAMPS (ops/sweep_kernel.py), in a separate
// instantiation.
// Any K: a K above 16 takes the instances of bound GMRM_ANY_K, as in
// csrc/sweep_blocks.cu.
// A launch takes at most MAX_T traits.  A run with more takes a block step
// in launches of trait chunks (ops/trait_chunks.py), as csrc/sweep_blocks.cu
// does a sweep: the entry point offsets every operand to the chunk's first
// trait t0 and keeps the run's trait count TS as the stride of u, z, the
// tables and a per-trait Gram cache.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>

#include "block_passes.cuh"
#include "sweep_math.cuh"

namespace {

constexpr int MAX_SHARDS = 16;  // shards of one launch (kernel parameters)
constexpr int BS_THREADS = 512;
constexpr int NWARPS = BS_THREADS / 32;
constexpr int BS_NST = 6;       // %globaltimer stamps per CTA
// What the scan CTAs keep in shared memory: the scaled Gram, the per-marker
// copies of the group tables.
enum { GS_SMEM = 1, TAB_SMEM = 2 };
enum { ACCUMULATE = 1, IN_PLACE = 2 };  // mode bits of a launch
// Sync words of a shard's slot of the scratch, each on its own line: the
// top ticket, the c flag (the groups' sums are in), the dbeta flag (the
// waves published); in slot 0 only, the exit ticket and the count of
// column CTAs that have built their share of the scaled Grams; then one
// ticket per group.
enum { SYNC_TOP = 0, SYNC_C = 1, SYNC_DBETA = 2, SYNC_DONE = 3, SYNC_GS = 4,
       SYNC_GROUPS = 5 };

// One shard's operands, as the host's table holds them.
struct ShardOps {
  const int* blk;       // (nblocks,) natural block of each step
  const int* win;       // (nblocks, B) row order of each step
  const uint8_t* bed;   // (nb*B, mb) natural order
  const float* gram;    // (nb, nt, 2B, 2B)
  const float* mave;    // (T, nb*B) natural order, as msig, beta, comp,
  const float* msig;    //   acum and grp (nb*B,)
  float* beta;          // the block's slots are updated in place
  int* comp;
  float* acum;
  const int* grp;
  const float* u;       // (nblocks, T, B) processing order
  const float* z;
  const int* m_loc;     // (1,) real marker count on the device, or null
  int nb;               // natural blocks in the operands
  int m_local;          // the real marker count when m_loc is null
};

struct StepArgs {
  ShardOps sh[MAX_SHARDS];
  float* eps;           // (T, 4, mb): read; written in IN_PLACE mode
  const float* na;      // (nt, 4, mb)
  float* out;           // (T, 4, mb) the local sum: written unless
                        //   IN_PLACE, read with ACCUMULATE
  const float* sigmag;  // (T, G)
  const float* lc;      // (K, T, G)
  const float* rd;
  const float* sqb;
  const float* i2se;    // (T,)
  const float* nonas;   // (T,)
  unsigned* scratch;    // one slot per shard of the launch
  unsigned long long* stamps;  // (grid, BS_NST) or null
  size_t slot_words;
  int step, ns, mode;
  int T, B, mb, nt, K, W, G, C, span, cap, vec, flags, ncol, ngroups,
      gs_tot;
  int vec16;  // every shard's bed rows start on 16 bytes (mb % 16 == 0)
  int TS;   // the run's traits: the stride of u, z (nblocks, TS, B), the
            //   tables (K, TS, G) and a Gram cache of a mask a trait
            //   (nb, TS, 2B, 2B), each offset to the chunk's first trait
};

// The packed scaled Gram, as csrc/sweep_blocks.cu keeps it: per trait, wave
// after wave, W rows of B - (w+1)W floats (the markers after the wave).
__host__ __device__ inline int gs_wave_offset(int B, int W, int w) {
  return W * (w * B - W * (w * (w + 1) / 2));
}

// A flag of the plan beside GS_SMEM and TAB_SMEM: the column passes on the
// tensor cores (column_cta_mma), C a multiple of 32.
enum { MMA_PASSES = 4 };

// Shared memory offsets in bytes.  Scan CTAs and column CTAs lay out the
// same allocation differently; total is the larger of the two.
struct Layout {
  // column CTAs; per shard of the launch: row, win, mave, msig, bed, acc.
  // On the tensor cores eps holds eps's bf16 parts for (1), then acc the
  // shards' deltas in the same bytes, and dm the wave's operand parts.
  size_t row, win, mave, msig, bed, eps, na, red, acc, dm, last;
  // scan CTAs
  size_t s_row, s_grp, s_beta, s_acum, s_comp, s_flag, s_u, s_z, s_x0,
      s_x1, s_wdb, s_lc, s_rd, s_sqb, s_gs;
  size_t total;
  int SP;  // bed row stride in bytes: an odd number of words (tensor
           //   cores: 4 past a multiple of 8, so rows start on 16 bytes)
  int P;   // column parts of the c-dot (threads per marker row; tensor
           //   cores: warps per m16 tile of marker rows)
  int WP;  // words of a part
  int RP;  // row parts of a wave in the update (accumulators per shard)
  int QS;  // tensor cores: bf16 values per part plane of eps, 4 C + 16
  int QW;  // tensor cores: bf16 values per part plane of the wave's operand
};

// ns shards in a launch of a plan that takes `cap`: the parts P and RP
// depend on the plan only, so that every launch of a step sums in the same
// order; each is as small as keeps the CTA's threads busy at `cap`
// shards, which keeps the partials and the accumulators small.
__host__ __device__ inline Layout make_layout(int T, int B, int W, int K,
                                              int nt, int C, int ns,
                                              int flags, int cap) {
  Layout L;
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  };
  const size_t tb = (size_t)T * B * 4;
  const size_t plane = (size_t)T * 4 * C * 4;
  L.QS = 4 * C + 16;
  L.QW = (W + 15) / 16 * 16 + 8;
  if (flags & MMA_PASSES) {
    // Rows 4 words past a multiple of 8: the fragments' loads of a warp
    // (rows g, g + 8 at word q; rows 2q + m at word g) fall in 32 banks.
    L.SP = C + 16;
    // Warps per m16 tile of every shard's marker rows at `cap` shards.
    const int tiles = cap * ((B + 15) / 16);
    L.P = tiles >= BS_THREADS / 32 ? 1 : BS_THREADS / 32 / tiles;
    L.WP = 0;
    L.RP = 1;
    L.row = take((size_t)ns * B * 4);
    L.win = take((size_t)ns * B * 4);
    L.mave = take(ns * tb);
    L.msig = take(ns * tb);
    L.bed = take((size_t)ns * B * L.SP);
    // eps's parts (3T planes of QS), later the shards' deltas.
    const size_t parts = (size_t)3 * T * L.QS * 2;
    L.eps = take(parts > ns * plane ? parts : ns * plane);
    L.acc = L.eps;
    L.na = off;
    L.red = take((size_t)ns * L.P * 2 * tb);
    L.dm = take((size_t)ns * 6 * T * L.QW * 2);
    L.last = take((size_t)ns * 4);
  } else {
    L.SP = ((C / 4) % 2 == 0) ? C + 4 : C;
    const int p_busy = (BS_THREADS + cap * B - 1) / (cap * B);
    L.P = C / 4 < 8 ? C / 4 : 8;
    if (p_busy < L.P) L.P = p_busy;
    L.WP = (C / 4 + L.P - 1) / L.P;
    // The update: a thread per shard, row part, plane and word (4
    // columns), at most one round of the CTA's threads where the columns
    // allow.
    const int r_fit = BS_THREADS / (cap * C);
    L.RP = r_fit < 1 ? 1 : (r_fit < 8 ? r_fit : 8);
    if (L.RP > W) L.RP = W;
    L.row = take((size_t)ns * B * 4);
    L.win = take((size_t)ns * B * 4);
    L.mave = take(ns * tb);
    L.msig = take(ns * tb);
    L.bed = take((size_t)ns * B * L.SP);
    L.eps = take(plane);
    L.na = take((size_t)nt * 4 * C * 4);
    L.red = take((size_t)ns * L.P * 2 * tb);
    L.acc = take((size_t)ns * L.RP * plane);
    L.dm = take((size_t)ns * T * W * 8);
    L.last = take((size_t)ns * 4);
  }
  const size_t col_total = off;
  off = 0;
  L.s_row = take((size_t)B * 4);
  L.s_grp = take((size_t)B * 4);
  L.s_beta = take(tb);
  L.s_acum = take(tb);
  L.s_comp = take(tb);
  L.s_flag = take(tb);
  L.s_u = take(tb);
  L.s_z = take(tb);
  L.s_x0 = take(tb);  // msig, then base
  L.s_x1 = take(tb);  // corr
  L.s_wdb = take((size_t)2 * T * W * 4);
  const size_t tab = (flags & TAB_SMEM) ? (size_t)K * tb : 0;
  L.s_lc = take(tab);
  L.s_rd = take(tab);
  L.s_sqb = take(tab);
  L.s_gs = take((flags & GS_SMEM)
                    ? (size_t)T * gs_wave_offset(B, W, B / W - 1) * 4
                    : 0);
  L.total = off > col_total ? off : col_total;
  return L;
}

// A shard's slot of the scratch in 32-bit words, each piece on its own
// line: the sync words, the column CTAs' partials (ncol, T, B), the groups'
// sums (ngroups, T, B), dbeta (T, B) and the packed scaled Gram (T, gs_tot),
// which the scan CTA copies into shared memory where it fits.
struct Slot {
  size_t part, gpart, dbuf, gs, total;
};

__host__ __device__ inline Slot slot_layout(int ncol, int ngroups, int T,
                                            int B, int gs_tot) {
  Slot s;
  size_t off = (size_t)(SYNC_GROUPS + ngroups) * LINE;
  auto take = [&off](size_t words) {
    const size_t o = off;
    off += (words + LINE - 1) / LINE * LINE;
    return o;
  };
  const size_t tb = (size_t)T * B;
  s.part = take((size_t)ncol * tb);
  s.gpart = take((size_t)ngroups * tb);
  s.dbuf = take(tb);
  s.gs = take((size_t)T * gs_tot);
  s.total = off;
  return s;
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

// The calling thread returns once *p >= target (a launch takes tens of
// microseconds: 4 s means a lost hand-off, and the kernel traps).
__device__ __forceinline__ void spin_geq(const unsigned* p, unsigned target) {
  if (ld_acquire(p) < target) {
    const unsigned long long t0 = global_ns();
    while (ld_acquire(p) < target)
      if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

// Every thread of the CTA returns once *p >= target.
__device__ __forceinline__ void wait_geq(const unsigned* p, unsigned target) {
  if (threadIdx.x == 0) spin_geq(p, target);
  __syncthreads();
}

template <bool ST>
__device__ __forceinline__ void stamp(const StepArgs& a, int e) {
  if (ST && threadIdx.x == 0)
    a.stamps[(size_t)blockIdx.x * BS_NST + e] = global_ns();
}

// The natural block of a shard's step and its offset in the operands.
__device__ __forceinline__ int shard_block(const ShardOps& s, int step) {
  const int blk = s.blk[step];
  // A block outside the operands would read and write out of bounds.
  if (s.nb > 1 && (blk < 0 || blk >= s.nb)) __trap();
  return blk;
}

// ---- the column CTAs -------------------------------------------------------
template <int MT, bool ST>
__device__ __forceinline__ void column_cta(const StepArgs& a, const Layout& L,
                                           unsigned char* sm) {
  const int T = a.T, B = a.B, W = a.W, C = a.C, mb = a.mb, ns = a.ns;
  const int TB = T * B, T4C = T * 4 * C;
  const int nw = B / W;
  const int tid = threadIdx.x;
  const int g = blockIdx.x - ns;
  // The CTA's columns [own0, own1), in tiles of C: the last tile's bed
  // rows stay in shared memory for the waves, the others are streamed.
  const int own0 = g * a.span;
  const int own1 = min(own0 + a.span, mb);
  const int ntile = (own1 - own0 + C - 1) / C;
  const int C4 = C / 4;
  const int group = g / GROUP;
  const int gsize = min(GROUP, a.ncol - group * GROUP);
  const Slot so = slot_layout(a.ncol, a.ngroups, T, B, a.gs_tot);
  int* srow = (int*)(sm + L.row);           // (ns, B) rows in the operands
  int* swin = (int*)(sm + L.win);           // (ns, B) rows in the block
  float* smave = (float*)(sm + L.mave);     // (ns, T, B) processing order
  float* smsig = (float*)(sm + L.msig);
  uint8_t* sbed = sm + L.bed;               // (ns, B, SP)
  float* seps = (float*)(sm + L.eps);       // (T*4, C)
  float* sna = (float*)(sm + L.na);         // (nt*4, C)
  float* sred = (float*)(sm + L.red);       // (P, 2T, B)
  float* sacc = (float*)(sm + L.acc);       // (ns, T*4, C)
  float2* sdm = (float2*)(sm + L.dm);       // (T, W): d, mave * d
  int* slast = (int*)(sm + L.last);         // (ns,) last of its group/top
  auto slot = [&](int q) { return a.scratch + (size_t)q * a.slot_words; };
  stamp<ST>(a, 0);

  // The slices of eps and na and every shard's B bed rows of the tile at
  // col0 (zeros, and the pad byte 0x55 with a = b = 0, past the CTA's
  // columns), in one round of cp.async copies; with `stats`, also every
  // shard's statistics in processing order.
  auto stage = [&](int col0, bool stats) {
#pragma unroll 1
    for (int pl = 0; pl < 2; ++pl) {
      const float* src = pl == 0 ? a.eps : a.na;
      float* dst = pl == 0 ? seps : sna;
      const int np = (pl == 0 ? T : a.nt) * 4;
      if (a.vec) {
        for (int y = tid; y < np * C4; y += BS_THREADS) {
          const int p = y / C4, c = 4 * (y % C4);
          float* d = dst + p * C + c;
          if (col0 + c < own1)
            cp_async16(d, src + (size_t)p * mb + col0 + c);
          else
            *(float4*)d = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int y = tid; y < np * C; y += BS_THREADS) {
          const int p = y / C, c = y % C;
          dst[y] = col0 + c < own1 ? src[(size_t)p * mb + col0 + c] : 0.f;
        }
      }
    }
#pragma unroll 1
    for (int q = 0; q < ns; ++q) {
      const ShardOps& s = a.sh[q];
      const int* rq = srow + q * B;
      uint8_t* bq = sbed + (size_t)q * B * L.SP;
      if (a.vec) {
        for (int x = tid; x < B * C4; x += BS_THREADS) {
          const int i = x / C4, c = 4 * (x % C4);
          uint8_t* d = bq + (size_t)i * L.SP + c;
          if (col0 + c < own1)
            cp_async4(d, s.bed + (size_t)rq[i] * mb + col0 + c);
          else
            *(uint32_t*)d = 0x55555555u;
        }
      } else {
        for (int x = tid; x < B * C; x += BS_THREADS) {
          const int i = x / C, c = x % C;
          bq[(size_t)i * L.SP + c] =
              col0 + c < own1 ? s.bed[(size_t)rq[i] * mb + col0 + c] : 0x55;
        }
      }
      if (stats) {
        const size_t m_in = (size_t)s.nb * B;
        for (int x = tid; x < TB; x += BS_THREADS) {
          const size_t o = (size_t)(x / B) * m_in + rq[x % B];
          cp_async4(smave + q * TB + x, s.mave + o);
          cp_async4(smsig + q * TB + x, s.msig + o);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  };

  // ---- staging: the rows first, then the tiles ----------------------------
#pragma unroll 1
  for (int x = tid; x < ns * B; x += BS_THREADS) {
    const ShardOps& s = a.sh[x / B];
    const int blk = shard_block(s, a.step);
    const int w = s.win[(size_t)a.step * B + x % B];
    swin[x] = w;
    srow[x] = (s.nb > 1 ? blk * B : 0) + w;
  }
  __syncthreads();

  // ---- (1) every shard's centred partial of the CTA's columns -------------
  // Tile by tile, the last one left staged.  Thread (q, i, h): shard q,
  // marker row i, part h of the tile's columns, its sums kept in sred
  // from tile to tile.
  const int P = L.P;
  const int cw = 4 * L.WP;                     // columns a part
#pragma unroll 1
  for (int tile = 0; tile < ntile; ++tile) {
    if (tile > 0) __syncthreads();             // the last tile's reads done
    stage(own0 + tile * C, tile == 0);
    if (tile == 0) stamp<ST>(a, 1);
#pragma unroll 1
    for (int x = tid; x < ns * B * P; x += BS_THREADS) {
      const int q = x / (B * P), i = x % B, h = (x / B) % P;
      const uint8_t* rp = sbed + ((size_t)q * B + i) * L.SP;
      const int c1 = min(C, (h + 1) * cw);
      float sa[MT], sb[MT];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        sa[t] = 0.0f;
        sb[t] = 0.0f;
      }
#pragma unroll 1
      for (int c = h * cw; c < c1; c += 4) {
        const uint32_t word = *(const uint32_t*)(rp + c);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float af[4], bf[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            decode_f(word >> (8 * r), k, af[r], bf[r]);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            if (t < T) {
              const float4 e = *(const float4*)(seps + (t * 4 + k) * C + c);
              sa[t] = fmaf(af[3], e.w, fmaf(af[2], e.z, fmaf(af[1], e.y,
                           fmaf(af[0], e.x, sa[t]))));
              sb[t] = fmaf(bf[3], e.w, fmaf(bf[2], e.z, fmaf(bf[1], e.y,
                           fmaf(bf[0], e.x, sb[t]))));
            }
          }
        }
      }
      float* red = sred + ((size_t)q * P + h) * 2 * TB;
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t < T) {
          float* ra = red + (2 * t) * B + i;
          float* rb = red + (2 * t + 1) * B + i;
          *ra = tile == 0 ? sa[t] : __fadd_rn(*ra, sa[t]);
          *rb = tile == 0 ? sb[t] : __fadd_rn(*rb, sb[t]);
        }
      }
    }
  }
#pragma unroll 1
  for (int x = tid; x < ns * L.RP * T4C; x += BS_THREADS)
    sacc[x] = 0.0f;
  __syncthreads();
#pragma unroll 1
  for (int x = tid; x < ns * TB; x += BS_THREADS) {
    const int q = x / TB, o = x % TB;
    const int t = o / B, i = o % B;
    const float* red = sred + (size_t)q * P * 2 * TB;
    float s_a = red[(2 * t) * B + i], s_b = red[(2 * t + 1) * B + i];
#pragma unroll 1
    for (int h = 1; h < P; ++h) {
      s_a += red[((size_t)h * 2 * T + 2 * t) * B + i];
      s_b += red[((size_t)h * 2 * T + 2 * t + 1) * B + i];
    }
    float* mine = (float*)slot(q) + so.part + (size_t)g * TB;
    mine[o] = __fsub_rn(s_a, __fmul_rn(smave[x], s_b));
  }
  __syncthreads();

  // ---- the tree, every shard's tickets at once (thread q: shard q) --------
  if (tid < ns) {
    unsigned* gcount = slot(tid) + (size_t)(SYNC_GROUPS + group) * LINE;
    const bool is_last = atom_add_acq_rel(gcount, 1) == (unsigned)gsize - 1;
    if (is_last) *gcount = 0;
    slast[tid] = is_last;
  }
  __syncthreads();
  bool any_last = false;
#pragma unroll 1
  for (int q = 0; q < ns; ++q) {
    if (!slast[q]) continue;
    any_last = true;
    // The group's partials in CTA order.
    const float* src =
        (const float*)slot(q) + so.part + (size_t)group * GROUP * TB;
    float* gpart = (float*)slot(q) + so.gpart;
#pragma unroll 1
    for (int o = tid; o < TB; o += BS_THREADS)
      gpart[(size_t)group * TB + o] = sum_in_order(src + o, gsize, TB);
  }
  if (any_last) {
    __syncthreads();
    // The last group to arrive tells the shard's scan CTA.
    if (tid < ns && slast[tid]) {
      unsigned* top = slot(tid) + SYNC_TOP * LINE;
      if (atom_add_acq_rel(top, 1) == (unsigned)a.ngroups - 1) {
        *top = 0;
        st_release(slot(tid) + SYNC_C * LINE, 1u);
      }
    }
  }
  stamp<ST>(a, 2);

  // ---- (2) the CTA's share of every shard's scaled Gram, packed ------------
  // The entries are dealt to the threads of all column CTAs, each thread's
  // four gathered loads made once.
  {
    const int B2 = 2 * B;
    const size_t quad = (size_t)B2 * B2;
    const int per = T * a.gs_tot;
#pragma unroll 1
    for (int e = g * BS_THREADS + tid; e < ns * per;
         e += a.ncol * BS_THREADS) {
      const int q = e / per;
      const int t = (e % per) / a.gs_tot;
      int rem = e % a.gs_tot;
      int w = 0;
      while (rem >= W * (B - (w + 1) * W)) {
        rem -= W * (B - (w + 1) * W);
        ++w;
      }
      const int len = B - (w + 1) * W;
      const int j = w * W + rem / len;
      const int i = (w + 1) * W + rem % len;
      const ShardOps& s = a.sh[q];
      const int blk = s.nb > 1 ? s.blk[a.step] : 0;
      const float* gq =
          s.gram + ((size_t)blk * (a.nt == 1 ? 1 : a.TS) +
                    (a.nt == 1 ? 0 : t)) * quad;
      const int wj = swin[q * B + j], wi = swin[q * B + i];
      const float* mq = smave + q * TB + t * B;
      const float* sq = smsig + q * TB + t * B;
      float* out = (float*)slot(q) + so.gs;
      out[e % per] = gmrm_scale_gram(
          __ldg(gq + (size_t)wj * B2 + wi),
          __ldg(gq + (size_t)(B + wj) * B2 + wi),
          __ldg(gq + (size_t)wj * B2 + B + wi),
          __ldg(gq + (size_t)(B + wj) * B2 + B + wi), mq[i], mq[j], sq[i],
          sq[j]);
    }
    __syncthreads();
    if (tid == 0) red_release(a.scratch + SYNC_GS * LINE, 1);
  }

  // ---- (4) wave w of every shard into the shards' accumulators of the
  // staged tile.  Thread (q, r, k, v): shard q, part r of the wave's rows,
  // phase plane k and the four byte columns of word v of the tile, every
  // trait.  Wave -1 applies zeros (+0 stays +0).
  auto apply_wave = [&](int w) {
    const int wr = w < 0 ? 0 : w;
#pragma unroll 1
    for (int x = tid; x < ns * T * W; x += BS_THREADS) {
      const int q = x / (T * W), r = x % (T * W);
      const int o = q * TB + (r / W) * B + wr * W + r % W;
      const float* dbuf = (const float*)slot(q) + so.dbuf;
      const float dv =
          w < 0 ? 0.0f : __fmul_rn(smsig[o], __ldcg(dbuf + o - q * TB));
      sdm[x] = make_float2(dv, __fmul_rn(smave[o], dv));
    }
    __syncthreads();
#pragma unroll 1
    for (int x = tid; x < ns * L.RP * C; x += BS_THREADS) {
      const int q = x / (L.RP * C);
      const int r = (x / C) % L.RP;
      const int k = (x / C4) % 4, v = x % C4;
      const int j0 = r * W / L.RP, j1 = (r + 1) * W / L.RP;
      const uint8_t* bq = sbed + ((size_t)q * B + wr * W) * L.SP + 4 * v;
      const float2* dm = sdm + (size_t)q * T * W;
      float s[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.0f;
#pragma unroll 2
      for (int j = j0; j < j1; ++j) {
        const uint32_t word = *(const uint32_t*)(bq + (size_t)j * L.SP);
        float af[4], bf[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) decode_f(word >> (8 * e), k, af[e], bf[e]);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          if (t < T) {
            const float2 d = dm[t * W + j];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[t][e] = fmaf(-d.y, bf[e], fmaf(d.x, af[e], s[t][e]));
          }
        }
      }
      // The part's accumulator, plane t*4 + k of shard q, four columns.
      float* acc = sacc + ((size_t)q * L.RP + r) * T4C + k * C + 4 * v;
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t < T) {
          float4* a4 = (float4*)(acc + t * 4 * C);
          float4 o = *a4;
          o.x += s[t][0];
          o.y += s[t][1];
          o.z += s[t][2];
          o.w += s[t][3];
          *a4 = o;
        }
      }
    }
    __syncthreads();
  };

  // The shards' deltas of the staged tile at col0 summed in shard order,
  // then written or added into eps.
  const bool acc_in = a.mode & ACCUMULATE;
  const bool in_place = a.mode & IN_PLACE;
  auto write_tile = [&](int col0) {
    const int n = min(C, own1 - col0);
#pragma unroll 1
    for (int y = tid; y < T4C; y += BS_THREADS) {
      const int p = y / C, c = y % C;
      if (c >= n) continue;
      const float nav = sna[((a.nt == 1 ? 0 : p >> 2) * 4 + (p & 3)) * C + c];
      const size_t o = (size_t)p * mb + col0 + c;
      float tot = acc_in ? a.out[o] : 0.0f;
#pragma unroll 1
      for (int q = 0; q < ns; ++q) {
        // Shard q's delta: its row parts in order, masked.
        const float* acc = sacc + (size_t)q * L.RP * T4C + y;
        float d = acc[0];
#pragma unroll 1
        for (int r = 1; r < L.RP; ++r) d += acc[(size_t)r * T4C];
        d = __fmul_rn(nav, d);
        tot = (q == 0 && !acc_in) ? d : __fadd_rn(tot, d);
      }
      if (in_place)
        a.eps[o] = __fadd_rn(seps[y], tot);
      else
        a.out[o] = tot;
    }
  };

  // The staged tile takes every wave of every shard as it arrives: a dry
  // pass first (it runs the pass's code once while the first wave is
  // drawn, so that the instructions are cached when the waves come).
#pragma unroll 1
  for (int w = -1; w < nw; ++w) {
    // Thread q waits for shard q's wave: one round trip for all shards.
    if (w >= 0 && tid < ns)
      spin_geq(slot(tid) + SYNC_DBETA * LINE, (unsigned)(w + 1));
    __syncthreads();
    apply_wave(w);
    if (w == 0) stamp<ST>(a, 3);
  }
  stamp<ST>(a, 4);
  write_tile(own0 + (ntile - 1) * C);
  // The streamed tiles, once every wave is in: staged again (from L2),
  // every wave applied, written.
#pragma unroll 1
  for (int tile = 0; tile + 1 < ntile; ++tile) {
    __syncthreads();
    stage(own0 + tile * C, false);
#pragma unroll 1
    for (int x = tid; x < ns * L.RP * T4C; x += BS_THREADS)
      sacc[x] = 0.0f;
    __syncthreads();
#pragma unroll 1
    for (int w = 0; w < nw; ++w) apply_wave(w);
    write_tile(own0 + tile * C);
  }
  stamp<ST>(a, 5);
}

// ---- the column passes on the tensor cores ---------------------------------
// Copies of csrc/sweep_blocks.cu's helpers (the file header says why).
constexpr uint32_t PAD_WORD = 0x55555555u;  // four pad bytes: a = b = 0
// The bf16 bits of a (0x4000 = 2, 0x3F80 = 1) and of b for codes 0..3, as
// byte tables for a permute: the low bytes of codes 0..3, then the high.
constexpr uint32_t A_LO = 0x00800000u, A_HI = 0x003F0040u;
constexpr uint32_t B_LO = 0x80800080u, B_HI = 0x3F3F003Fu;

// Code k (bits 2k, 2k+1) of each byte of w as bf16 pairs: a01 holds a of
// bytes 0 and 1 (byte 0 in the low half), a23 of bytes 2 and 3, b01 and
// b23 likewise.  A byte's selector nibbles become (code, code + 4): its
// value's low byte, then its high byte.
__device__ __forceinline__ void decode_pairs(uint32_t w, int k,
                                             uint32_t& a01, uint32_t& a23,
                                             uint32_t& b01, uint32_t& b23) {
  const uint32_t v = ((w >> (2 * k)) & 0x03030303u) * 0x11u + 0x40404040u;
  a01 = __byte_perm(A_LO, A_HI, v);
  a23 = __byte_perm(A_LO, A_HI, v >> 16);
  b01 = __byte_perm(B_LO, B_HI, v);
  b23 = __byte_perm(B_LO, B_HI, v >> 16);
}

// x as three bf16 parts, each the top 16 bits of what the parts before it
// leave: 8 + 8 + 8 significant bits.  Both subtractions are exact, so
// hi + mid + lo == x for every finite x whose last part stays in bf16's
// normal range (|x| >= 2^-103), and a genotype times a part is exact.
__device__ __forceinline__ void split3(float x, uint16_t& hi, uint16_t& mid,
                                       uint16_t& lo) {
  const uint32_t xb = __float_as_uint(x);
  const float r = x - __uint_as_float(xb & 0xFFFF0000u);
  const uint32_t rb = __float_as_uint(r);
  const float l = r - __uint_as_float(rb & 0xFFFF0000u);
  hi = (uint16_t)(xb >> 16);
  mid = (uint16_t)(rb >> 16);
  lo = (uint16_t)(__float_as_uint(l) >> 16);
}

// A tile's trait sums, (hi + mid) + lo, spread over the lanes: d[x] for
// trait t0 + (x & 1) at row r0 + (x >> 1) (0: g, 1: g + 8), x < nx.  At
// MT = 8 a lane holds every part of its traits 2q, 2q + 1: both rows.  At
// MT = 4 lanes q and q ^ 2 hold a trait's parts between them (hi and lo
// at q < 2, mid at q + 2) and exchange them so that each takes one row:
// lane q < 2 row g, lane q + 2 row g + 8.
template <int MT, int NTL>
__device__ __forceinline__ void tile_sums(const float (&acc)[NTL][4], int tq,
                                          float (&d)[4], int& t0, int& r0,
                                          int& nx) {
  if constexpr (MT == 4) {
    const bool up = tq < 2;
    float got[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // up sends hi, hi, lo, lo of row g + 8; the partner mid of row g.
      const float v = up ? acc[i < 2 ? 0 : 1][2 + (i & 1)] : acc[0][i & 1];
      got[i] = __shfl_xor_sync(0xffffffffu, v, 2);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
      d[e] = up ? __fadd_rn(__fadd_rn(acc[0][e], got[e]), acc[1][e])
                : __fadd_rn(__fadd_rn(got[e], acc[0][2 + e]), got[2 + e]);
    t0 = 2 * (tq & 1);
    r0 = up ? 0 : 1;
    nx = 2;
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x)
      d[x] = __fadd_rn(__fadd_rn(acc[0][x], acc[1][x]), acc[2][x]);
    t0 = 2 * tq;
    r0 = 0;
    nx = 4;
  }
}

// c += A B on one m16n8k16 tile: A's four registers (rows g and g + 8 at
// k = 2q, 2q + 1, then at k = 2q + 8, 2q + 9, for lane 4g + q), B's two.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The part plane that column n of an N tile holds: part p = n / MT of trait
// t = n % MT; plane 0 for the columns past 3T, whose sums are never read.
template <int MT>
__device__ __forceinline__ int part_plane(int n, int T) {
  const int p = n / MT, t = n % MT;
  return p < 3 && t < T ? p * T + t : 0;
}

// The column CTAs on the tensor cores: column_cta's protocol (stamps,
// tickets, the scaled Gram's share, waves as they arrive, tiles), with
// (1) [A; B]^T eps over the tile's individuals and (4) X_w [dv; -mdv] over
// each wave's markers as kernel 7/8's tensor-core passes compute them.  C
// is a multiple of 32; every shard's bed rows and eps's parts of a tile
// are staged whole, zeros and pad bytes past the CTA's columns.
template <int MT, bool ST>
__device__ __forceinline__ void column_cta_mma(const StepArgs& a,
                                               const Layout& L,
                                               unsigned char* sm) {
  const int T = a.T, B = a.B, W = a.W, C = a.C, mb = a.mb, ns = a.ns;
  const int TB = T * B, T4C = T * 4 * C;
  const int nw = B / W;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;  // the fragments' row and column
  const int g = blockIdx.x - ns;
  const int own0 = g * a.span;
  const int own1 = min(own0 + a.span, mb);
  const int ntile = (own1 - own0 + C - 1) / C;
  const int C4 = C / 4, C16 = C / 16;
  const int group = g / GROUP;
  const int gsize = min(GROUP, a.ncol - group * GROUP);
  const int SP = L.SP, QS = L.QS, QW = L.QW, KH = L.P;
  constexpr int NTL = MT == 4 ? 2 : 3;   // N tiles of 8: 3 parts x MT traits
  const Slot so = slot_layout(a.ncol, a.ngroups, T, B, a.gs_tot);
  int* srow = (int*)(sm + L.row);           // (ns, B) rows in the operands
  int* swin = (int*)(sm + L.win);           // (ns, B) rows in the block
  float* smave = (float*)(sm + L.mave);     // (ns, T, B) processing order
  float* smsig = (float*)(sm + L.msig);
  uint8_t* sbed = sm + L.bed;               // (ns, B, SP)
  // eps's parts for (1): plane p*T + t (part p of trait t), code k at
  // k * C, QS a plane; then, in the same bytes, the shards' deltas.
  uint16_t* spl = (uint16_t*)(sm + L.eps);
  float* sacc = (float*)(sm + L.acc);       // (ns, T*4, C)
  float* sred = (float*)(sm + L.red);       // (ns, KH, 2T, B)
  // The wave's (4) operand: dv = msig dbeta and -mdv = -(mave dv) as three
  // bf16 parts, plane ((q*2 + v)*3 + p)*T + t (v = 0 dv, 1 -mdv), QW a plane.
  uint16_t* sdv = (uint16_t*)(sm + L.dm);
  int* slast = (int*)(sm + L.last);         // (ns,) last of its group/top
  auto slot = [&](int q) { return a.scratch + (size_t)q * a.slot_words; };
  stamp<ST>(a, 0);

  // Every shard's B bed rows of the tile at col0 (the pad byte 0x55 past
  // the CTA's columns) in one round of cp.async copies; with `stats`,
  // every shard's statistics in processing order; with `parts`, eps's
  // three parts of the tile (0 past the CTA's columns), split as loaded.
  auto stage = [&](int col0, bool stats, bool parts) {
#pragma unroll 1
    for (int q = 0; q < ns; ++q) {
      const ShardOps& s = a.sh[q];
      const int* rq = srow + q * B;
      uint8_t* bq = sbed + (size_t)q * B * SP;
#pragma unroll 1
      for (int x = tid; x < B * C16; x += BS_THREADS) {
        const int i = x / C16, c = 16 * (x % C16);
        uint8_t* d = bq + (size_t)i * SP + c;
        const uint8_t* src = s.bed + (size_t)rq[i] * mb + col0 + c;
        const int n = own1 - (col0 + c);
        if (n >= 16 && a.vec16) {
          cp_async16(d, src);
          continue;
        }
#pragma unroll 1
        for (int j = 0; j < 16; j += 4) {
          if (n - j >= 4 && a.vec) {
            cp_async4(d + j, src + j);
          } else {
            uint32_t w = PAD_WORD;
            for (int e = 0; e < 4 && j + e < n; ++e)
              w = (w & ~(0xFFu << (8 * e))) | ((uint32_t)src[j + e] << (8 * e));
            *(uint32_t*)(d + j) = w;
          }
        }
      }
      if (stats) {
        const size_t m_in = (size_t)s.nb * B;
        for (int x = tid; x < TB; x += BS_THREADS) {
          const size_t o = (size_t)(x / B) * m_in + rq[x % B];
          cp_async4(smave + q * TB + x, s.mave + o);
          cp_async4(smsig + q * TB + x, s.msig + o);
        }
      }
    }
    if (parts) {
      // Four words of a thread's loads in flight before their splits.
      constexpr int NB = 4;
      const int n4 = T * 4 * C4;
#pragma unroll 1
      for (int y0 = tid; y0 < n4; y0 += NB * BS_THREADS) {
        float4 e[NB];
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int y = y0 + u * BS_THREADS;
          e[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          const int p = y / C4, c = 4 * (y % C4), col = col0 + c;
          const float* src = a.eps + (size_t)p * mb + col;
          if (y >= n4 || col >= own1) continue;
          if (a.vec) {
            e[u] = __ldcg((const float4*)src);
          } else {
            e[u].x = __ldcg(src);
            if (col + 1 < own1) e[u].y = __ldcg(src + 1);
            if (col + 2 < own1) e[u].z = __ldcg(src + 2);
            if (col + 3 < own1) e[u].w = __ldcg(src + 3);
          }
        }
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int y = y0 + u * BS_THREADS;
          if (y >= n4) break;
          const int p = y / C4, c = 4 * (y % C4);
          uint16_t h[4], m[4], l[4];
          split3(e[u].x, h[0], m[0], l[0]);
          split3(e[u].y, h[1], m[1], l[1]);
          split3(e[u].z, h[2], m[2], l[2]);
          split3(e[u].w, h[3], m[3], l[3]);
          uint16_t* o = spl + (size_t)(p >> 2) * QS + (p & 3) * C + c;
          *(uint2*)o = make_uint2(h[0] | (uint32_t)h[1] << 16,
                                  h[2] | (uint32_t)h[3] << 16);
          *(uint2*)(o + (size_t)T * QS) =
              make_uint2(m[0] | (uint32_t)m[1] << 16,
                         m[2] | (uint32_t)m[3] << 16);
          *(uint2*)(o + (size_t)2 * T * QS) =
              make_uint2(l[0] | (uint32_t)l[1] << 16,
                         l[2] | (uint32_t)l[3] << 16);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  };

  // ---- staging: the rows first, then the tiles ----------------------------
#pragma unroll 1
  for (int x = tid; x < ns * B; x += BS_THREADS) {
    const ShardOps& s = a.sh[x / B];
    const int blk = shard_block(s, a.step);
    const int w = s.win[(size_t)a.step * B + x % B];
    swin[x] = w;
    srow[x] = (s.nb > 1 ? blk * B : 0) + w;
  }
  __syncthreads();

  // ---- (1) every shard's centred partial of the CTA's columns -------------
  // Per m16 tile of a shard's marker rows, the a plane and the b plane
  // against eps's part planes, reduced over the tile's individuals.  A unit
  // of a warp is a shard, a marker tile and part h of the tile's 16-column
  // chunks; in a chunk lane 4g + q reads the word of columns 4q .. 4q + 3
  // of rows g and g + 8, and k step k takes code k of its four bytes.  The
  // sums of part h go to sred[((q KH + h) 2T + 2t + v) B + i] (v = 0 a,
  // 1 b), added tile by tile.
  const int mtiles = (B + 15) / 16;
  auto partials = [&](int tile) {
    int pl[NTL];
#pragma unroll
    for (int j = 0; j < NTL; ++j) pl[j] = part_plane<MT>(8 * j + gr, T);
#pragma unroll 1
    for (int u = warp; u < ns * mtiles * KH; u += BS_THREADS / 32) {
      const int q = u / (mtiles * KH), r = u % (mtiles * KH);
      const int mt = r % mtiles, h = r / mtiles;
      const int ch0 = h * C16 / KH, ch1 = (h + 1) * C16 / KH;
      const int i0 = mt * 16 + gr, i1 = i0 + 8;
      const uint8_t* rp[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = x ? i1 : i0;
        rp[x] = i < B ? sbed + ((size_t)q * B + i) * SP + 4 * tq : nullptr;
      }
      float acc[2][NTL][4];
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[v][j][e] = 0.0f;
      // Chunks in batches of CB, the next batch's words loaded before this
      // one's products.
      constexpr int CB = 4;
      uint32_t nx[CB][2];
      auto fetch = [&](int c0, uint32_t (&wd)[CB][2]) {
#pragma unroll
        for (int cc = 0; cc < CB; ++cc)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            wd[cc][x] = rp[x] != nullptr && c0 + cc < ch1
                            ? *(const uint32_t*)(rp[x] + 16 * (c0 + cc))
                            : PAD_WORD;
      };
      fetch(ch0, nx);
#pragma unroll 1
      for (int c0 = ch0; c0 < ch1; c0 += CB) {
        uint32_t cw[CB][2];
#pragma unroll
        for (int cc = 0; cc < CB; ++cc) {
          cw[cc][0] = nx[cc][0];
          cw[cc][1] = nx[cc][1];
        }
        if (c0 + CB < ch1) fetch(c0 + CB, nx);
#pragma unroll
        for (int cc = 0; cc < CB; ++cc) {
          if (c0 + cc >= ch1) break;
          const int c = 16 * (c0 + cc) + 4 * tq;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            uint32_t bf[NTL][2];
#pragma unroll
            for (int j = 0; j < NTL; ++j) {
              const uint2 v = *(const uint2*)(spl + (size_t)pl[j] * QS +
                                              k * C + c);
              bf[j][0] = v.x;
              bf[j][1] = v.y;
            }
            uint32_t a0, a1, a2, a3, b0, b1, b2, b3;
            decode_pairs(cw[cc][0], k, a0, a2, b0, b2);
            decode_pairs(cw[cc][1], k, a1, a3, b1, b3);
#pragma unroll
            for (int j = 0; j < NTL; ++j) {
              mma_bf16(acc[0][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
              mma_bf16(acc[1][j], b0, b1, b2, b3, bf[j][0], bf[j][1]);
            }
          }
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        float d[4];
        int t0, r0, nx_;
        tile_sums<MT, NTL>(acc[v], tq, d, t0, r0, nx_);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = t0 + (x & 1), i = r0 + (x >> 1) ? i1 : i0;
          if (x < nx_ && t < T && i < B) {
            float* o = sred + (((size_t)q * KH + h) * 2 * T + 2 * t + v) * B
                       + i;
            *o = tile == 0 ? d[x] : __fadd_rn(*o, d[x]);
          }
        }
      }
    }
  };

  // Tile by tile, the last one left staged.
#pragma unroll 1
  for (int tile = 0; tile < ntile; ++tile) {
    if (tile > 0) __syncthreads();             // the last tile's reads done
    stage(own0 + tile * C, tile == 0, true);
    if (tile == 0) stamp<ST>(a, 1);
    partials(tile);
  }
  __syncthreads();
  // eps's parts are read: their bytes take the shards' deltas.
#pragma unroll 1
  for (int x = tid; x < ns * T4C / 4; x += BS_THREADS)
    ((float4*)sacc)[x] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int x = tid; x < ns * TB; x += BS_THREADS) {
    const int q = x / TB, o = x % TB;
    const int t = o / B, i = o % B;
    const float* red = sred + (size_t)q * KH * 2 * TB;
    float s_a = red[(2 * t) * B + i], s_b = red[(2 * t + 1) * B + i];
#pragma unroll 1
    for (int h = 1; h < KH; ++h) {
      s_a += red[((size_t)h * 2 * T + 2 * t) * B + i];
      s_b += red[((size_t)h * 2 * T + 2 * t + 1) * B + i];
    }
    float* mine = (float*)slot(q) + so.part + (size_t)g * TB;
    mine[o] = __fsub_rn(s_a, __fmul_rn(smave[x], s_b));
  }
  __syncthreads();

  // ---- the tree, every shard's tickets at once (thread q: shard q) --------
  if (tid < ns) {
    unsigned* gcount = slot(tid) + (size_t)(SYNC_GROUPS + group) * LINE;
    const bool is_last = atom_add_acq_rel(gcount, 1) == (unsigned)gsize - 1;
    if (is_last) *gcount = 0;
    slast[tid] = is_last;
  }
  __syncthreads();
  bool any_last = false;
#pragma unroll 1
  for (int q = 0; q < ns; ++q) {
    if (!slast[q]) continue;
    any_last = true;
    const float* src =
        (const float*)slot(q) + so.part + (size_t)group * GROUP * TB;
    float* gpart = (float*)slot(q) + so.gpart;
#pragma unroll 1
    for (int o = tid; o < TB; o += BS_THREADS)
      gpart[(size_t)group * TB + o] = sum_in_order(src + o, gsize, TB);
  }
  if (any_last) {
    __syncthreads();
    if (tid < ns && slast[tid]) {
      unsigned* top = slot(tid) + SYNC_TOP * LINE;
      if (atom_add_acq_rel(top, 1) == (unsigned)a.ngroups - 1) {
        *top = 0;
        st_release(slot(tid) + SYNC_C * LINE, 1u);
      }
    }
  }
  stamp<ST>(a, 2);

  // ---- (2) the CTA's share of every shard's scaled Gram, packed ------------
  {
    const int B2 = 2 * B;
    const size_t quad = (size_t)B2 * B2;
    const int per = T * a.gs_tot;
#pragma unroll 1
    for (int e = g * BS_THREADS + tid; e < ns * per;
         e += a.ncol * BS_THREADS) {
      const int q = e / per;
      const int t = (e % per) / a.gs_tot;
      int rem = e % a.gs_tot;
      int w = 0;
      while (rem >= W * (B - (w + 1) * W)) {
        rem -= W * (B - (w + 1) * W);
        ++w;
      }
      const int len = B - (w + 1) * W;
      const int j = w * W + rem / len;
      const int i = (w + 1) * W + rem % len;
      const ShardOps& s = a.sh[q];
      const int blk = s.nb > 1 ? s.blk[a.step] : 0;
      const float* gq =
          s.gram + ((size_t)blk * (a.nt == 1 ? 1 : a.TS) +
                    (a.nt == 1 ? 0 : t)) * quad;
      const int wj = swin[q * B + j], wi = swin[q * B + i];
      const float* mq = smave + q * TB + t * B;
      const float* sq = smsig + q * TB + t * B;
      float* out = (float*)slot(q) + so.gs;
      out[e % per] = gmrm_scale_gram(
          __ldg(gq + (size_t)wj * B2 + wi),
          __ldg(gq + (size_t)(B + wj) * B2 + wi),
          __ldg(gq + (size_t)wj * B2 + B + wi),
          __ldg(gq + (size_t)(B + wj) * B2 + B + wi), mq[i], mq[j], sq[i],
          sq[j]);
    }
    __syncthreads();
    if (tid == 0) red_release(a.scratch + SYNC_GS * LINE, 1);
  }

  // ---- (4) wave w of every shard into the shards' deltas of the staged
  // tile.  Per m16 tile, 16 individuals x 8 part columns, reduced over the
  // wave's markers, the a plane against dv and the b plane against -mdv.
  // A unit of a warp is a shard, a super-tile of 32 byte columns (lane
  // group g owns columns 4g .. 4g + 3), one half h of them and a group of
  // codes: tile (h, k) holds individual (column 4g + 2h, code k) in row g
  // and (column 4g + 2h + 1, code k) in row g + 8.  Wave -1 applies zeros
  // (+0 stays +0).
  const int W16 = QW - 8;
  const int KW = W16 / 16;
  const int nst = C / 32;
  int KS = 1;  // code groups: enough units for the warps on a narrow slice
  while (KS < 4 && ns * nst * 2 * KS < BS_THREADS / 32) KS *= 2;
  const int CPU = 4 / KS, per_q = nst * 2 * KS, units = ns * per_q;
  auto apply_wave = [&](int w) {
    const int wr = w < 0 ? 0 : w;
#pragma unroll 1
    for (int x = tid; x < ns * T * W16; x += BS_THREADS) {
      const int q = x / (T * W16), r = x % (T * W16);
      const int t = r / W16, i = r % W16;
      float dv = 0.0f, mdv = 0.0f;
      if (w >= 0 && i < W) {
        const int o = t * B + wr * W + i;
        const float* dbuf = (const float*)slot(q) + so.dbuf;
        dv = __fmul_rn(smsig[q * TB + o], __ldcg(dbuf + o));
        mdv = __fmul_rn(smave[q * TB + o], dv);
      }
      uint16_t* d = sdv + ((size_t)q * 6 * T + t) * QW + i;
      split3(dv, d[0], d[(size_t)T * QW], d[(size_t)2 * T * QW]);
      d += (size_t)3 * T * QW;
      split3(-mdv, d[0], d[(size_t)T * QW], d[(size_t)2 * T * QW]);
    }
    __syncthreads();
    // This lane's bed words of unit u for k steps s0, s0 + 1: [s][pair][m],
    // marker 16 s + 2q + 8 pair + m of the wave, columns 4g .. 4g + 3 of
    // the unit's super-tile.
    auto load_words = [&](int u, int s0, uint32_t (&wd)[2][2][2]) {
      const int q = u / per_q;
      const uint8_t* bw = sbed + ((size_t)q * B + wr * W) * SP +
                          (u % per_q) / (2 * KS) * 32 + 4 * gr;
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int i = 16 * (s0 + s) + 2 * tq + 8 * pr + m;
            wd[s][pr][m] =
                i < W ? *(const uint32_t*)(bw + (size_t)i * SP) : PAD_WORD;
          }
    };
    // The B fragments of shard q for k steps s0, s0 + 1: [s][dv or
    // -mdv][tile][pair], column g of each tile.
    auto load_frags = [&](int q, int s0, uint32_t (&bq)[2][2][NTL][2]) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int j = 0; j < NTL; ++j)
#pragma unroll
            for (int pr = 0; pr < 2; ++pr)
              bq[s][v][j][pr] = *(const uint32_t*)(
                  sdv + (((size_t)q * 2 + v) * 3 * T +
                         part_plane<MT>(8 * j + gr, T)) * QW +
                  16 * (s0 + s) + 2 * tq + 8 * pr);
    };
    // Code k of the two markers of each pair, their bytes of columns 4g +
    // 2h and + 1 interleaved ([m0 c, m1 c, m0 c+1, m1 c+1]), into acc.
    auto products = [&](const uint32_t (&xw)[2][2],
                        const uint32_t (&bq)[2][2][NTL][2], int s0, int k,
                        float (&acc)[NTL][4]) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s0 + s >= KW) break;
        uint32_t a0, a1, a2, a3, b0, b1, b2, b3;
        decode_pairs(xw[s][0], k, a0, a1, b0, b1);
        decode_pairs(xw[s][1], k, a2, a3, b2, b3);
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          mma_bf16(acc[j], a0, a1, a2, a3, bq[s][0][j][0], bq[s][0][j][1]);
          mma_bf16(acc[j], b0, b1, b2, b3, bq[s][1][j][0], bq[s][1][j][1]);
        }
      }
    };
    auto interleave = [&](const uint32_t (&wd)[2][2][2], int h,
                          uint32_t (&xw)[2][2]) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr)
          xw[s][pr] = __byte_perm(wd[s][pr][0], wd[s][pr][1],
                                  h ? 0x7362 : 0x5140);
    };
    // k steps 0 and 1 (the whole wave at W <= 32): a shard's fragments
    // loaded when a warp's units reach it, and each unit's words loaded
    // while the unit before computes.
    uint32_t bq[2][2][NTL][2];
    int q_frags = -1;
    uint32_t wd[2][2][2];
    if (warp < units) load_words(warp, 0, wd);
#pragma unroll 1
    for (int u = warp; u < units; u += BS_THREADS / 32) {
      const int q = u / per_q, uq = u % per_q;
      const int h = (uq / KS) % 2, k0 = (uq % KS) * CPU;
      const int col = uq / (2 * KS) * 32 + 4 * gr;
      if (q != q_frags) {
        load_frags(q, 0, bq);
        q_frags = q;
      }
      uint32_t xw[2][2];
      interleave(wd, h, xw);
      if (u + BS_THREADS / 32 < units)
        load_words(u + BS_THREADS / 32, 0, wd);
      float* accq = sacc + (size_t)q * T4C;
#pragma unroll 1
      for (int k = k0; k < k0 + CPU; ++k) {
        float acc[NTL][4];
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
        products(xw, bq, 0, k, acc);
#pragma unroll 1
        for (int s0 = 2; s0 < KW; s0 += 2) {  // W > 32
          uint32_t wg[2][2][2], xg[2][2], bg[2][2][NTL][2];
          load_words(u, s0, wg);
          interleave(wg, h, xg);
          load_frags(q, s0, bg);
          products(xg, bg, s0, k, acc);
        }
        // The shard's delta += the wave's, for the lane's outputs.
        float d[4];
        int t0, r0, nx;
        tile_sums<MT, NTL>(acc, tq, d, t0, r0, nx);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = t0 + (x & 1), c = col + 2 * h + r0 + (x >> 1);
          if (x < nx && t < T) {
            float* o = accq + (size_t)(t * 4 + k) * C + c;
            *o = __fadd_rn(*o, d[x]);
          }
        }
      }
    }
    __syncthreads();
  };

  // The shards' deltas of the staged tile at col0, each masked, summed in
  // shard order, then written or added into eps (na, eps and a previous
  // launch's sum read from global memory).
  const bool acc_in = a.mode & ACCUMULATE;
  const bool in_place = a.mode & IN_PLACE;
  auto write_tile = [&](int col0) {
    const int n = min(C, own1 - col0);
#pragma unroll 1
    for (int y = tid; y < T * 4 * C4; y += BS_THREADS) {
      const int p = y / C4, c = 4 * (y % C4);
      if (c >= n) continue;
      const int ne = min(4, n - c);
      const bool v4 = a.vec && ne == 4;
      const size_t o = (size_t)p * mb + col0 + c;
      const float* nap =
          a.na + (size_t)((a.nt == 1 ? 0 : p >> 2) * 4 + (p & 3)) * mb +
          col0 + c;
      auto load = [&](const float* src, float (&v)[4]) {
        if (v4) {
          const float4 x = __ldcg((const float4*)src);
          v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
        } else {
          for (int e = 0; e < ne; ++e) v[e] = __ldcg(src + e);
        }
      };
      float nv[4], tot[4], ev[4];
      load(nap, nv);
      if (acc_in) load(a.out + o, tot);
      if (in_place) load(a.eps + o, ev);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= ne) break;
#pragma unroll 1
        for (int q = 0; q < ns; ++q) {
          // Shard q's delta, masked.
          const float d =
              __fmul_rn(nv[e], sacc[(size_t)q * T4C + p * C + c + e]);
          tot[e] = (q == 0 && !acc_in) ? d : __fadd_rn(tot[e], d);
        }
        if (in_place) tot[e] = __fadd_rn(ev[e], tot[e]);
      }
      float* dst = in_place ? a.eps + o : a.out + o;
      if (v4)
        *(float4*)dst = make_float4(tot[0], tot[1], tot[2], tot[3]);
      else
        for (int e = 0; e < ne; ++e) dst[e] = tot[e];
    }
  };

  // The staged tile takes every wave of every shard as it arrives: a dry
  // pass first (it runs the pass's code once while the first wave is
  // drawn, so that the instructions are cached when the waves come).
#pragma unroll 1
  for (int w = -1; w < nw; ++w) {
    // Thread q waits for shard q's wave: one round trip for all shards.
    if (w >= 0 && tid < ns)
      spin_geq(slot(tid) + SYNC_DBETA * LINE, (unsigned)(w + 1));
    __syncthreads();
    apply_wave(w);
    if (w == 0) stamp<ST>(a, 3);
  }
  stamp<ST>(a, 4);
  write_tile(own0 + (ntile - 1) * C);
  // The other tiles, once every wave is in: their bed rows staged again
  // (from L2), every wave applied, written.
#pragma unroll 1
  for (int tile = 0; tile + 1 < ntile; ++tile) {
    __syncthreads();
    stage(own0 + tile * C, false, false);
#pragma unroll 1
    for (int x = tid; x < ns * T4C / 4; x += BS_THREADS)
      ((float4*)sacc)[x] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
#pragma unroll 1
    for (int w = 0; w < nw; ++w) apply_wave(w);
    write_tile(own0 + tile * C);
  }
  stamp<ST>(a, 5);
}

// ---- the scan CTAs: one per shard of the launch ----------------------------
template <int MK, bool ST>
__device__ __forceinline__ void scan_cta(const StepArgs& a, const Layout& L,
                                         unsigned char* sm) {
  const int T = a.T, B = a.B, W = a.W, K = a.K, G = a.G;
  const int TB = T * B;
  const int nw = B / W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = blockIdx.x;
  const ShardOps& s = a.sh[q];
  unsigned* sync = a.scratch + (size_t)q * a.slot_words;
  const Slot so = slot_layout(a.ncol, a.ngroups, T, B, a.gs_tot);
  const float* gpart = (const float*)sync + so.gpart;
  float* dbuf = (float*)sync + so.dbuf;
  const float* ggs = (const float*)sync + so.gs;
  const bool gs_s = a.flags & GS_SMEM;
  const bool tab_s = a.flags & TAB_SMEM;
  int* srow = (int*)(sm + L.s_row);
  int* sgrp = (int*)(sm + L.s_grp);
  float* sbeta = (float*)(sm + L.s_beta);
  float* sacum = (float*)(sm + L.s_acum);
  int* scomp = (int*)(sm + L.s_comp);
  int* sflag = (int*)(sm + L.s_flag);    // bit 0 live, bit 1 zerob
  float* su = (float*)(sm + L.s_u);
  float* sz = (float*)(sm + L.s_z);
  float* smsig = (float*)(sm + L.s_x0);  // msig, then base
  float* sbase = (float*)(sm + L.s_x0);
  float* scorr = (float*)(sm + L.s_x1);
  float* swdb = (float*)(sm + L.s_wdb);  // (2, T, W) two waves' dbeta
  float* slc = (float*)(sm + L.s_lc);    // (K, T, B) per-marker tables
  float* srd = (float*)(sm + L.s_rd);
  float* ssqb = (float*)(sm + L.s_sqb);
  float* sgs = (float*)(sm + L.s_gs);
  stamp<ST>(a, 0);

  // ---- the block's marker state, draws and flags: none depends on eps ------
  const int blk = shard_block(s, a.step);
  const int off = s.nb > 1 ? blk * B : 0;
  const size_t m_in = (size_t)s.nb * B;
  const int m_local = s.m_loc != nullptr ? *s.m_loc : s.m_local;
#pragma unroll 1
  for (int i = tid; i < B; i += BS_THREADS) {
    const int w = s.win[(size_t)a.step * B + i];
    if (w < 0 || w >= B) __trap();   // not a row of the block
    srow[i] = off + w;
    sgrp[i] = s.grp[off + w];
  }
  __syncthreads();
  // Every load of an element before its first store (sweep_blocks.cu).
#pragma unroll 1
  for (int x = tid; x < TB; x += BS_THREADS) {
    const int t = x / B, i = x % B;
    const size_t o = (size_t)t * m_in + srow[i];
    const size_t d = ((size_t)a.step * a.TS + t) * B + i;
    const int tg = t * G + sgrp[i];
    const float v_msig = s.msig[o];
    const float v_beta = s.beta[o], v_acum = s.acum[o];
    const int v_comp = s.comp[o];
    const float v_u = s.u[d], v_z = s.z[d];
    const bool adav = a.sigmag[tg] == 0.0f;
    // Any K (MK = GMRM_ANY_K): the tables are staged below, in chunks.
    constexpr int MR = MK == GMRM_ANY_K ? GMRM_MAX_K : MK;
    float tl[MR], tr[MR], ts[MR];
#pragma unroll
    for (int k = 0; k < MK; ++k) {
      if (tab_s && k < K) {
        const size_t e = (size_t)k * a.TS * G + tg;
        tl[k] = a.lc[e];
        tr[k] = a.rd[e];
        ts[k] = a.sqb[e];
      }
    }
    const bool valid = blk * B + (srow[i] - off) < m_local;
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
            const size_t e = (size_t)(k0 + k) * a.TS * G + tg;
            tl[k] = a.lc[e];
            tr[k] = a.rd[e];
            ts[k] = a.sqb[e];
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
  __syncthreads();
  stamp<ST>(a, 1);

  // ---- (3), (5): the waves -------------------------------------------------
  // Whether the last warp draws nothing and can publish each wave, and
  // whether warps are left between the drawing warps and it to fold in the
  // background (sweep_blocks.cu).
  const int draw_warps = (T * W + 31) / 32;
  const bool pub_warp = draw_warps < NWARPS;
  const bool bg_fold = draw_warps < NWARPS - 1;
  const int folders = pub_warp ? BS_THREADS - 32 : BS_THREADS;
  int any_prev = 0;
  // A barrier of the threads that fold: the publishing warp may still wait
  // on its release, and draws nothing.
  auto folders_sync = [&]() {
    if (pub_warp)
      asm volatile("bar.sync 1, %0;" ::"r"(BS_THREADS - 32) : "memory");
    else
      __syncthreads();
  };

  // Fold wave w's rank-W correction (its dbeta in swdb half w & 1) into
  // corr of the later waves' markers i in [i0, i1) (counted from the first
  // marker after wave w), on `nthr` threads from warp `warp0` on; `split`
  // neighbouring lanes share an output, each a fixed slice of the W terms
  // summed in order, then a shuffle tree.
  auto fold = [&](int w, int i0, int i1, int warp0, int nthr) {
    const int rest = B - (w + 1) * W;
    const int cols = i1 - i0;
    const int goff = gs_wave_offset(B, W, w);
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
      float sum = 0.0f;
      if (x < n) {
        const int j0 = h * jw, j1 = min(W, j0 + jw);
        const int go = t * a.gs_tot + goff + i;
        const float* dw = sw + t * W;
        if (gs_s) {
          const float* gp = sgs + go;
#pragma unroll 4
          for (int j = j0; j < j1; ++j) sum += dw[j] * gp[j * rest];
        } else {
          const float* gp = ggs + go;
#pragma unroll 4
          for (int j = j0; j < j1; ++j) sum += dw[j] * __ldcg(gp + j * rest);
        }
      }
      for (int d = 1; d < split; d <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, d);
      if (x < n && h == 0) scorr[t * B + (w + 1) * W + i] += sum;
    }
  };

  // Wave -1 is a dry run of the first wave's draw and fold on made-up
  // numbers while the column CTAs compute c: it writes nothing that
  // outlives it (corr is zeroed below), and it brings the code of the
  // draw and the fold into the instruction cache before the chain needs
  // it.
#pragma unroll 1
  for (int w = -1; w < nw; ++w) {
    const bool dry = w < 0;
    if (w == 0) {
      // ---- c and base, once the groups' sums are in -----------------------
      wait_geq(sync + SYNC_C * LINE, 1u);
      stamp<ST>(a, 2);
#pragma unroll 1
      for (int x = tid; x < TB; x += BS_THREADS) {
        const int t = x / B;
        const float v = sum_in_order(gpart + x, a.ngroups, TB);
        const float c = __fmul_rn(smsig[x], v);
        sbase[x] =
            __fadd_rn(c, __fmul_rn(sbeta[x], __fsub_rn(a.nonas[t], 1.0f)));
        scorr[x] = 0.0f;
      }
      __syncthreads();
      stamp<ST>(a, 3);
    }
    const int w0 = dry ? 0 : w * W;
    float* sw = swdb + (w & 1) * T * W;  // this wave's dbeta, (T, W)
    int moved = 0;
#pragma unroll 1
    for (int x = tid; x < T * W; x += BS_THREADS) {
      const int t = x / W;
      const int i = w0 + x % W;
      const int o = t * B + i;
      const float num = dry ? 0.0f : __fadd_rn(sbase[o], scorr[o]);
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
      const size_t nat = (size_t)t * m_in + srow[i];
      if (!dry) {
        s.beta[nat] = lv ? dr.samp : (zb ? 0.0f : bo);
        s.comp[nat] = lv ? dr.comp : scomp[o];
        s.acum[nat] = lv ? dr.acum : (zb ? 1.0f : sacum[o]);
        dbuf[o] = db;
      }
      sw[x] = db;
      moved |= (db != 0.0f);
    }
    // Meanwhile the warps that draw nothing fold the wave before into the
    // waves after this one.
    if (bg_fold && warp >= draw_warps && warp < NWARPS - 1 && w >= 1 &&
        any_prev && w + 1 < nw)
      fold(w - 1, W, B - w0, draw_warps, BS_THREADS - 32 * (draw_warps + 1));
    const bool any = __syncthreads_or(moved) && !dry;
    if (w == 0) stamp<ST>(a, 4);
    // Publish the wave to the column CTAs, which apply it while the later
    // waves are drawn: the last warp when it draws nothing, off the chain.
    const unsigned epoch = (unsigned)(w + 1);
    if (pub_warp && warp == NWARPS - 1) {
      if (lane == 0 && !dry) st_release(sync + SYNC_DBETA * LINE, epoch);
      continue;
    }
    if (!pub_warp && tid == 0 && !dry)
      st_release(sync + SYNC_DBETA * LINE, epoch);
    if (w == 0) {
      // The scaled Gram, once every column CTA has built its share: the
      // first fold is its first reader.
      if (tid == 0) spin_geq(a.scratch + SYNC_GS * LINE, (unsigned)a.ncol);
      folders_sync();
      const int gs_n = T * a.gs_tot;
      if (gs_s && gs_n % 4 == 0) {
        for (int x = tid; x < gs_n / 4; x += folders)
          ((float4*)sgs)[x] = __ldcg((const float4*)ggs + x);
      } else if (gs_s) {
        for (int x = tid; x < gs_n; x += folders) sgs[x] = __ldcg(ggs + x);
      }
      folders_sync();
    }
    if ((any || dry) && w0 + W < B)
      fold(w < 0 ? 0 : w, 0, bg_fold ? W : B - w0 - W, 0, folders);
    folders_sync();
    any_prev = any;
  }
  stamp<ST>(a, 5);
}

// MMA: the column passes on the tensor cores (the plan's MMA_PASSES), an
// instance of its own, so that neither design's registers or code weigh on
// the other's.
template <int MT, int MK, bool ST, bool MMA>
__global__ void __launch_bounds__(BS_THREADS, 1)
block_sweep_kernel(const __grid_constant__ StepArgs a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Layout L =
      make_layout(a.T, a.B, a.W, a.K, a.nt, a.C, a.ns, a.flags, a.cap);
  if ((int)blockIdx.x < a.ns)
    scan_cta<MK, ST>(a, L, sm);
  else if constexpr (MMA)
    column_cta_mma<MT, ST>(a, L, sm);
  else
    column_cta<MT, ST>(a, L, sm);
  // The last CTA to finish zeroes the flags: every CTA is past its last
  // wait (and every scan CTA past its last release) when it arrives.
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* done = a.scratch + SYNC_DONE * LINE;
    if (atom_add_acq_rel(done, 1) == gridDim.x - 1) {
      *done = 0;
      a.scratch[SYNC_GS * LINE] = 0;
      for (int q = 0; q < a.ns; ++q) {
        unsigned* sync = a.scratch + (size_t)q * a.slot_words;
        sync[SYNC_C * LINE] = 0;
        sync[SYNC_DBETA * LINE] = 0;
      }
    }
  }
}

struct Plan {
  int cap;      // shards a launch takes at most
  int C;        // byte columns of a tile (a column CTA's staged columns)
  int mma;      // the column passes on the tensor cores
  int span;     // byte columns a column CTA owns, in tiles of C
  int ncol;     // column CTAs
  int flags;
  int smem;     // dynamic shared memory bytes (for `cap` shards)
  int ngroups;
  int gs_tot;
  size_t slot_words;
  const void* kernels[2];  // plain, stamped
};

template <bool ST, bool MMA>
const void* pick_kernel(int T, int K) {
  // Register arrays sized for T <= 4 or 8 traits and K <= 4, 8 or 16
  // mixture components; any larger K takes the instances of GMRM_ANY_K.
  const void* kernels[2][4] = {
      {(const void*)block_sweep_kernel<4, 4, ST, MMA>,
       (const void*)block_sweep_kernel<4, 8, ST, MMA>,
       (const void*)block_sweep_kernel<4, GMRM_MAX_K, ST, MMA>,
       (const void*)block_sweep_kernel<4, GMRM_ANY_K, ST, MMA>},
      {(const void*)block_sweep_kernel<MAX_T, 4, ST, MMA>,
       (const void*)block_sweep_kernel<MAX_T, 8, ST, MMA>,
       (const void*)block_sweep_kernel<MAX_T, GMRM_MAX_K, ST, MMA>,
       (const void*)block_sweep_kernel<MAX_T, GMRM_ANY_K, ST, MMA>}};
  return kernels[T <= 4 ? 0 : 1]
                 [K <= 4 ? 0 : K <= 8 ? 1 : K <= GMRM_MAX_K ? 2 : 3];
}

// Whether a tile of C byte columns runs the column passes of T traits on
// the tensor cores (MMA_PASSES), else on the CUDA cores: kernel 7/8's rule
// (csrc/sweep_blocks.cu mma_passes, measured there), from 256 / T byte
// columns and from 128 at any T.  The CUDA cores' work grows with T x C,
// the tensor cores' with C alone.
constexpr int MMA_TRAIT_COLS = 256;
constexpr int MMA_ALL_COLS = 128;
inline bool mma_passes(int T, int C) {
  return C >= MMA_ALL_COLS || T * C >= MMA_TRAIT_COLS;
}

// Whether a grid of ncol + ns CTAs with `smem` bytes each is resident at
// once in both instantiations (the readers spin on other CTAs).
cudaError_t fits(const Plan& p, int ns, int smem, int sms, int optin,
                 bool* ok) {
  *ok = false;
  if (smem > optin) return cudaSuccess;
  for (const void* k : p.kernels) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, BS_THREADS,
                                                        (size_t)smem);
    if (err != cudaSuccess) return err;
    if ((long long)per_sm * sms < p.ncol + ns) return cudaSuccess;
  }
  *ok = true;
  return cudaSuccess;
}

// span: the fewest byte columns, a multiple of 4, that spread the residual
// over the SMs left beside the scan CTAs of `want` shards (one CTA an SM).
// Then, keeping as much in the scan CTAs' shared memory as fits, the most
// shards, up to `want` and MAX_SHARDS, that a resident grid takes with a
// tile of at least min(span, MIN_TILE) columns, and for them the fewest
// tiles a span: so a panel of any width takes at least one shard.  On the
// tensor cores where mma_passes takes the span, tiles of a multiple of 32
// columns, as long as mma_passes takes the tile too; else on the CUDA
// cores.
constexpr int MIN_TILE = 64;

cudaError_t plan_uncached(int T, int B, int mb, int nt, int K, int W,
                          int want, Plan* p) {
  if (T < 1 || T > MAX_T || K < 1 || W < 2 || B < W ||
      B % W != 0 || mb < 1 || (nt != 1 && nt != T) || want < 1)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  p->gs_tot = gs_wave_offset(B, W, B / W - 1);
  if (want > MAX_SHARDS) want = MAX_SHARDS;
  if (want >= sms) return cudaErrorCooperativeLaunchTooLarge;
  const int span4 = 4 * ((mb + 4 * (sms - want) - 1) / (4 * (sms - want)));
  for (int mma = mma_passes(T, span4) ? 1 : 0; mma >= 0; --mma) {
    // On the tensor cores a multiple of 16 columns, so that every tile
    // starts on 16 bytes of a bed row.
    const int span = mma ? (span4 + 15) / 16 * 16 : span4;
    const int min_tile = span < MIN_TILE ? span : MIN_TILE;
    p->span = span;
    p->ncol = (mb + span - 1) / span;
    p->ngroups = (p->ncol + GROUP - 1) / GROUP;
    p->mma = mma;
    p->kernels[0] = mma ? pick_kernel<false, true>(T, K)
                        : pick_kernel<false, false>(T, K);
    p->kernels[1] = mma ? pick_kernel<true, true>(T, K)
                        : pick_kernel<true, false>(T, K);
    // Tiles of a multiple of `step` columns.
    const int step = mma ? 32 : 4;
    const int design = mma ? (int)MMA_PASSES : 0;
    for (int flags : {GS_SMEM | TAB_SMEM, (int)GS_SMEM, (int)TAB_SMEM, 0}) {
      for (int ns = want; ns >= 1; --ns) {
        auto smem_of = [&](int C) {
          return make_layout(T, B, W, K, nt, C, ns, flags | design, ns)
              .total;
        };
        // The widest tile that fits, then the fewest tiles of even width.
        int C = (span + step - 1) / step * step;
        while (C > min_tile && smem_of(C) > (size_t)optin) C -= step;
        if (C < min_tile || smem_of(C) > (size_t)optin) continue;
        const int ntile = (span + C - 1) / C;
        C = step * ((span + step * ntile - 1) / (step * ntile));
        if (mma && !mma_passes(T, C)) continue;
        const int smem = (int)smem_of(C);
        bool ok = false;
        err = fits(*p, ns, smem, sms, optin, &ok);
        if (err != cudaSuccess) return err;
        if (!ok) continue;
        p->cap = ns;
        p->C = C;
        p->flags = flags | design;
        p->smem = smem;
        p->slot_words =
            slot_layout(p->ncol, p->ngroups, T, B, p->gs_tot).total;
        // Both instantiations take the plan's shared memory size.
        for (const void* k : p->kernels) {
          err = cudaFuncSetAttribute(
              k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
          if (err != cudaSuccess) return err;
        }
        return cudaSuccess;
      }
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

// A sweep launches the same shapes at every block step, so plans are kept,
// a few shapes at once: planning asks the runtime a dozen questions.  Plans
// of different shapes may share an instantiation, so each plan handed out
// sets its kernels' shared memory size where the last plan left another.
cudaError_t plan_step(int T, int B, int mb, int nt, int K, int W, int want,
                      Plan* p) {
  constexpr int NKEEP = 8;
  static std::mutex lock;
  static int keys[NKEEP][8];
  static Plan kept[NKEEP];
  static int used = 0, next = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int k[8] = {T, B, mb, nt, K, W, want, dev};
  static const void* set_for[NKEEP] = {};  // the plan last set, per
  static int set_smem[NKEEP] = {};         //   instantiation seen
  std::lock_guard<std::mutex> guard(lock);
  int e = 0;
  while (e < used) {
    bool hit = true;
    for (int i = 0; i < 8; ++i) hit = hit && keys[e][i] == k[i];
    if (hit) break;
    ++e;
  }
  if (e == used) {
    Plan fresh;
    err = plan_uncached(T, B, mb, nt, K, W, want, &fresh);
    if (err != cudaSuccess) return err;
    e = next;
    for (int i = 0; i < 8; ++i) keys[e][i] = k[i];
    kept[e] = fresh;
    next = (next + 1) % NKEEP;
    if (used < NKEEP) ++used;
  }
  *p = kept[e];
  for (const void* kern : p->kernels) {
    int slot = 0;
    while (slot < NKEEP && set_for[slot] != nullptr && set_for[slot] != kern)
      ++slot;
    if (slot == NKEEP) slot = 0;
    if (set_for[slot] == kern && set_smem[slot] == p->smem) continue;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
    if (err != cudaSuccess) return err;
    set_for[slot] = kern;
    set_smem[slot] = p->smem;
  }
  return cudaSuccess;
}

}  // namespace

// out: shards a launch takes (0 when not even one shard's grid is resident
// at these shapes), C, column CTAs, flags (1 the scaled Gram, 2 the scan
// tables in shared memory, 4 the column passes on the tensor cores),
// dynamic shared memory bytes, groups of the tree, packed scaled-Gram
// floats per trait, scratch words per shard, the span, the column passes'
// design (0 CUDA cores, 1 tensor cores).  No launch.
extern "C" int gmrm_block_sweep_plan(int T, int B, int mb, int nt, int K,
                                     int W, int want, int* out) {
  Plan p;
  const cudaError_t err = plan_step(T, B, mb, nt, K, W, want, &p);
  if (err == cudaErrorCooperativeLaunchTooLarge) {
    for (int i = 0; i < 10; ++i) out[i] = 0;
    return 0;
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = p.cap;
  out[1] = p.C;
  out[2] = p.ncol;
  out[3] = p.flags;
  out[4] = p.smem;
  out[5] = p.ngroups;
  out[6] = p.gs_tot;
  out[7] = (int)p.slot_words;
  out[8] = p.span;
  out[9] = p.mma;
  return 0;
}

// One launch: shards s0 .. s0 + ns - 1 of the host table `table` (ShardOps
// records), block step `step`.  mode: 1 add onto `out` (a previous launch's
// sum), 2 add the sum into eps instead of writing `out`.  want: the shards
// of the whole step, which fix the plan, and with it the columns every
// partial sums over, for all of the step's launches.  The scratch holds
// the plan's slots, zeroed before its first launch; every launch leaves it
// so.  Traits t0 .. t0 + T - 1 of a run of TS traits (t0 = 0, T = TS: the
// whole run): the table's and the other operands are the run's (nt = 1 or
// TS masks), and the launch reads and writes the chunk's traits only.
extern "C" int gmrm_block_sweep(
    const void* table, int s0, int ns, int step, int mode,
    void* eps, const void* na, void* out, const void* sigmag, const void* lc,
    const void* rd, const void* sqb, const void* i2se, const void* nonas,
    void* scratch, void* stamps, int T, int B, int mb, int nt, int K, int W,
    int G, int want, int t0, int TS, void* stream) {
  if (t0 < 0 || TS < 1 || t0 + T > TS || (nt != 1 && nt != TS))
    return (int)cudaErrorInvalidValue;
  const int ntc = nt == 1 ? 1 : T;   // the chunk's masks
  Plan p;
  cudaError_t err = plan_step(T, B, mb, ntc, K, W, want, &p);
  if (err != cudaSuccess) return (int)err;
  if (ns < 1 || ns > p.cap || s0 < 0 || step < 0 ||
      (mode & ~(ACCUMULATE | IN_PLACE)) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t quad = (size_t)4 * B * B, tp = (size_t)t0 * 4 * mb;
  const size_t tg = (size_t)t0 * G;
  StepArgs a;
  const ShardOps* tab = (const ShardOps*)table;
  for (int q = 0; q < ns; ++q) {
    ShardOps& o = a.sh[q];
    o = tab[s0 + q];
    const size_t tm = (size_t)t0 * o.nb * B;
    o.gram += nt == 1 ? 0 : (size_t)t0 * quad;
    o.mave += tm;
    o.msig += tm;
    o.beta += tm;
    o.comp += tm;
    o.acum += tm;
    o.u += (size_t)t0 * B;
    o.z += (size_t)t0 * B;
  }
  a.eps = (float*)eps + tp;
  a.na = (const float*)na + (nt == 1 ? 0 : tp);
  a.out = out ? (float*)out + tp : nullptr;
  a.sigmag = (const float*)sigmag + tg;
  a.lc = (const float*)lc + tg;
  a.rd = (const float*)rd + tg;
  a.sqb = (const float*)sqb + tg;
  a.i2se = (const float*)i2se + t0;
  a.nonas = (const float*)nonas + t0;
  a.scratch = (unsigned*)scratch;
  a.stamps = (unsigned long long*)stamps;
  a.slot_words = p.slot_words;
  a.step = step;
  a.ns = ns;
  a.mode = mode;
  a.T = T;
  a.B = B;
  a.mb = mb;
  a.nt = ntc;
  a.TS = TS;
  a.K = K;
  a.W = W;
  a.G = G;
  a.C = p.C;
  a.span = p.span;
  a.cap = p.cap;
  const uintptr_t al16 = (uintptr_t)eps | (uintptr_t)na;
  a.vec = mb % 4 == 0 && al16 % 16 == 0;
  a.vec16 = mb % 16 == 0 && p.span % 16 == 0 && p.C % 16 == 0;
  for (int q = 0; q < ns; ++q) {
    a.vec = a.vec && (uintptr_t)a.sh[q].bed % 4 == 0;
    a.vec16 = a.vec16 && (uintptr_t)a.sh[q].bed % 16 == 0;
  }
  a.flags = p.flags;
  a.ncol = p.ncol;
  a.ngroups = p.ngroups;
  a.gs_tot = p.gs_tot;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(p.kernels[stamps != nullptr ? 1 : 0],
                                    dim3(p.ncol + ns), dim3(BS_THREADS), args,
                                    (size_t)p.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
