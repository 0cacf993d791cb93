// Within-block Gibbs scan in waves of W markers (the W co-scheduled
// shards relaxation, gmrm_tpu/ops/scan_kernel_wave.py), in float (kernel 3)
// and double (kernel E, a --dtype float64 --wave-size W run).
//
// With base = c + beta_old (nonas - 1), per wave, for every trait t and
// marker j of the wave:
//   num = base + corr,  q = num^2 / (2 sigmaE),  L_k = lc_k + q rd_k,
//   cdf_i = sum_{k<=i} E_k / S with E_k = exp(L_k - Lmax), S = sum_k E_k,
//   a term zeroed when |L_k - L_i| > 700 for some k >= i (suffix max/min),
//   comp = the smallest i with u <= cdf_i (else K-1),
//   beta = comp ? num rd_comp + sqb_comp z : 0, under the live/zerob masks;
// then the wave's rank-W fold corr[t, i] += sum_j dbeta[t, j] gs[t, j, i]
// into the markers i of the later waves (only those are read again).
// Outputs dbeta, d = msig dbeta, beta_new, comp_new and acum_new.
//
// Replaces _wave_kernel (gmrm_tpu/ops/scan_kernel_wave.py:57, built by
// _build_call :176, wrapper make_block_scan_wave :196); in double, what it
// would compute at float64 (the JAX wrapper casts a float64 run's operands
// to float32 and back, :208, :269-272; the double instance does not).  The
// TPU kernel
// takes the Gram wave-stacked to (T*B, B) for its lane layout and folds
// with one block-diagonal MXU dot into all B columns; here gs keeps its
// (T, B, B) layout and each wave folds into the later waves' columns.
//
// Bound on the H100: latency.  The B/W waves are a serial chain of small
// steps (T*W draws, then a T*W-by-W fold), so a CTA of 512 threads runs
// the block (its traits' part) and its time is the chain of dependent
// steps and barriers.
// The design follows the scan CTA of the whole-sweep kernel
// (sweep_blocks.cu):
//   - every per-marker operand of the block (c, the marker state, the
//     draws, the masks and, while they fit, the per-marker tables) is
//     staged into shared memory at entry, so no global load sits on a
//     wave's chain; the kernel forms base itself, in the draw.  Float: a
//     bulk copy (the tensor memory accelerator) per array.  Double: 16-byte
//     cp.async copies of every thread, each array named (a list indexed at
//     run time sits in local memory: kernel 3's 216-byte stack frame since
//     its trait groups), so that they do not queue behind the Gram rows'
//     bulk copies either;
//   - the scaled Gram is staged too, packed wave by wave: wave w's W rows
//     by the columns of the later waves only, T W (B - (w+1) W) values
//     (96 KB of the 256 KB Gram at T=4, B=128, W=32 in float), a bulk copy
//     per row issued by the warps that draw nothing, at entry in float and
//     once the operands are in in double.  In float, wave 0's rows
//     complete one mbarrier, waited for before the first fold, the others
//     a second, waited for before the second; in double, waves 0 .. 5 an
//     mbarrier each, waited for before each one's own fold (nbar).  A packed row's stride is padded to 8 floats past a multiple
//     of 32 (2 doubles past a multiple of 16), so the fold's lanes hit at
//     most two to a bank.  The waves that do not fit beside the operands
//     (large T B in float; B >= 256 in double) are read from global
//     memory (wave_plan in ops/scan_kernel_wave.py).  Where an address is
//     not on 16 bytes (B or W not a multiple of 4, or an unaligned view)
//     value-sized cp.async copies take the bulk copies' place;
//   - the fold of wave w into wave w + 1's columns runs on the chain, on
//     every thread; its fold into the waves after that runs on the warps
//     that draw nothing while wave w + 1 draws.  Each corr still receives
//     its folds in wave order;
//   - each fold term's W-long sum is split over up to 8 neighbouring lanes,
//     lane h taking the terms h, h + split, ... in order, then a fixed
//     shuffle tree, so two launches on the same inputs write the same bits.
// A launch is a grid of trait groups, TG traits a CTA: the traits' chains
// are independent, so a CTA takes its traits' slice of every operand and
// runs the block as above.  In float the grid is one CTA of every trait
// unless their state does not fit; in double (kernel E) the traits are
// spread over CTAs until each stages the tables and every wave's rows
// (launch_plan: one trait a CTA at T=4, B=128, K=4, W=32, 74 KB where one
// CTA of four held 188 KB and folded waves 1 and 2 from L2), so no fold
// on the chain leaves shared memory and the block's staging is split over
// as many SMs (two and three traits a CTA ran slower on the card).
// Since the double fold's lane split depends on W alone, a trait gets the
// same bits at any TG.
// The draw is sweep_math.cuh's gmrm_wave_draw: every add and product uses
// the _rn intrinsics, exp is expf (float) or the library's exp written
// out (double) and 1 / S is the IEEE division, so comp agrees exactly with
// the plain PyTorch version; the tables' K is a template bound (4, 8 or
// 16) so the per-candidate arrays stay in registers, and a larger K takes
// the instances of bound GMRM_ANY_K, whose draw (gmrm_wave_draw_any) walks
// K in chunks with no such array, in the same order of roundings.
// The value type V is a template parameter of the whole kernel; every
// shared-memory offset below counts values of V (the mbarriers, the int
// arrays and the waves' offsets take value-sized slots), and every copy's
// byte count is its element size times its length.  The float instance's
// arithmetic is kernel 3's as it was, operation for operation.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_math.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int SMEM_CAP = 232448;   // dynamic shared memory of one CTA
constexpr int NSTATE = 10;         // staged (T, B) arrays

template <typename V>
struct WaveArgs {
  const V* c;             // (T, B); base itself when nm1 is null
  const V* nm1;           // (T,) nonas - 1, or null
  const V* lc;            // (K, T, B) per-marker tables
  const V* rd;
  const V* sqb;
  const V* gs;            // (T, B, B) scaled Gram in processing order
  const V* beta_old;      // (T, B), as acum_old, u, z, msig
  const int* comp_old;    // (T, B), as live, zerob
  const V* acum_old;
  const V* u;
  const V* z;
  const int* live;
  const int* zerob;
  const V* msig;          // or null (then d is null too)
  const V* i2se;          // (T,)
  V* dbeta;               // (T, B) outputs
  V* d;
  V* beta_new;
  int* comp_new;
  V* acum_new;
  unsigned long long* stamps;  // (2 + 2 nw,) or null: CTA 0's
  int T, B, K, W, tab, gsw, vec;  // T: the CTA's traits (after wave_group)
  int TK;  // the launch's traits: the k stride of the tables in traits
  int TG;  // traits a CTA
};

// CTA blockIdx.x's traits t0 = blockIdx.x TG .. (TG of them, fewer in the
// last CTA): every (T, ..) operand offset to them; the tables keep the
// launch's k stride.  One CTA of every trait (TG = T) is unchanged.
template <typename V>
__device__ __forceinline__ WaveArgs<V> wave_group(const WaveArgs<V>& a0) {
  WaveArgs<V> a = a0;
  const int t0 = blockIdx.x * a0.TG;
  const size_t o = (size_t)t0 * a0.B;
  a.T = min(a0.TG, a0.T - t0);
  a.c += o;
  if (a.nm1) a.nm1 += t0;
  a.lc += o;
  a.rd += o;
  a.sqb += o;
  a.gs += o * a0.B;
  a.beta_old += o;
  a.comp_old += o;
  a.acum_old += o;
  a.u += o;
  a.z += o;
  a.live += o;
  a.zerob += o;
  if (a.msig) {
    a.msig += o;
    a.d += o;
  }
  a.i2se += t0;
  a.dbeta += o;
  a.beta_new += o;
  a.comp_new += o;
  a.acum_new += o;
  return a;
}

__host__ __device__ constexpr int al4(int x) { return (x + 3) & ~3; }

// Per trait, the packed offset of wave w's rows: W rows of B - (w'+1) W
// values for every earlier wave w'.
__host__ __device__ inline int gs_wave_offset(int B, int W, int w) {
  return W * (w * B - W * (w * (w + 1) / 2));
}

// The stride of a packed row of `rest` values in shared memory, so that
// the lanes of a fold, which read rows 1 .. 7 apart at neighbouring
// columns, hit at most two to a bank: floats padded to 8 past a multiple
// of 32; doubles (two banks each, a warp's 8-byte loads served a half-warp
// at a time) to 2 past a multiple of 16, where the 8 rows of the 2 columns
// of a half-warp at a split of 8 fall on 16 distinct bank pairs.  Both keep
// a row on 16 bytes for its bulk copy.
template <typename V>
__host__ __device__ inline int row_stride(int rest) {
  if (sizeof(V) == 8) return rest + (18 - rest % 16) % 16;
  return rest + (40 - rest % 32) % 32;
}

// Per trait, the shared-memory offset of wave w's packed rows.
template <typename V>
__host__ __device__ inline int gs_smem_offset(int B, int W, int w) {
  int o = 0;
  for (int v = 0; v < w; ++v) o += W * row_stride<V>(B - (v + 1) * W);
  return o;
}

constexpr int NBAR = 3;  // the float instance's mbarriers: operands,
                         // wave 0's rows, the rest

// The mbarriers of the instance: the operands' (0, used by the float
// instance only), then the staged waves' rows, wave w on barrier
// 1 + min(w, nbar - 2).  The float instance
// waits for wave 0's rows before the first fold and for the rest before
// the second; the double instance, whose barrier slots (al4(2 NBAR)
// values) hold 8, gives waves 0 .. 5 a barrier each, so that each of
// those folds waits for its own wave only, and the rest barrier 7.
template <typename V>
__host__ __device__ constexpr int nbar() {
  return sizeof(V) == 8 ? 8 : NBAR;
}

// Shared memory offsets in values of V; the mbarriers (8 bytes each) come
// first.
struct Layout {
  int c, corr, beta, acum, u, z, msig, comp, live, zerob, i2se, nm1, wdb;
  int goff, lc, rd, sqb, gs, words;
};

template <typename V>
__host__ __device__ inline Layout make_layout(int T, int B, int K, int W,
                                              int tab, int gsw) {
  Layout L;
  const int tb = al4(T * B);
  int o = al4(2 * NBAR);
  int* state[NSTATE] = {&L.c, &L.corr, &L.beta, &L.acum, &L.u,
                        &L.z,    &L.msig, &L.comp, &L.live, &L.zerob};
  for (int k = 0; k < NSTATE; ++k) {
    *state[k] = o;
    o += tb;
  }
  L.i2se = o;
  o += al4(T);
  L.nm1 = o;
  o += al4(T);
  L.wdb = o;                       // two waves' dbeta, (2, T, W)
  o += al4(2 * T * W);
  L.goff = o;                      // gs_smem_offset of every wave
  o += al4(B / W + 1);
  const int ktb = tab ? al4(K * T * B) : 0;
  L.lc = o;
  L.rd = o + ktb;
  L.sqb = o + 2 * ktb;
  o += 3 * ktb;
  L.gs = o;
  o += al4(T * gs_smem_offset<V>(B, W, gsw));
  L.words = o;
  return L;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// N (4 or 8) bytes from global to shared memory, in the current copy group.
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   smem_u32(smem)), "l"(gmem), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(smem_u32(bar)) : "memory");
}

// nbytes (a multiple of 16) from global to shared memory, both on 16 bytes,
// by the tensor memory accelerator; completion is counted on the barrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t nbytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(nbytes),
      "r"(smem_u32(bar)) : "memory");
}

// Copy k of a list: n 4-byte words from src to dst.  With vec (every
// address on 16 bytes, n a multiple of 4) one bulk copy, issued by the lane
// `by` of warp `by / 32` and counted on bar; else 4-byte cp.async copies by
// every thread of [tid0, THREADS), in the current copy group.
__device__ __forceinline__ void copy_words(void* dst, const void* src, int n,
                                           bool vec, uint64_t* bar, int by,
                                           int tid0) {
  if (vec) {
    if ((int)threadIdx.x == by) bulk_copy(dst, src, 4u * n, bar);
    return;
  }
  if ((int)threadIdx.x < tid0) return;
  for (int x = threadIdx.x - tid0; x < n; x += THREADS - tid0)
    cp_async<4>((uint32_t*)dst + x, (const uint32_t*)src + x);
}

// n 4-byte words from src to dst by cp.async copies of every thread: 16
// bytes each with vec (both on 16 bytes, n a multiple of 4), else 4.
__device__ __forceinline__ void copy_threads(void* dst, const void* src,
                                             int n, bool vec) {
  if (vec) {
    for (int x = threadIdx.x; x < n / 4; x += THREADS)
      cp_async<16>((uint4*)dst + x, (const uint4*)src + x);
    return;
  }
  for (int x = threadIdx.x; x < n; x += THREADS)
    cp_async<4>((uint32_t*)dst + x, (const uint32_t*)src + x);
}

// Wave w's packed Gram rows in value-sized cp.async copies by the threads
// tid0 .. THREADS - 1: for each trait t and row j of the wave, the columns
// of the later waves, into dst[(t W + j) row_stride + i].
template <typename V>
__device__ __forceinline__ void stage_gs_wave(V* dst, const V* gs, int T,
                                              int B, int W, int w,
                                              int tid0) {
  const int rest = B - (w + 1) * W, rs = row_stride<V>(rest);
  const int n = T * W * rest;
  for (int x = threadIdx.x - tid0; x < n; x += THREADS - tid0) {
    const int row = x / rest, col = x % rest;
    const int t = row / W, j = row % W;
    cp_async<sizeof(V)>(
        dst + row * rs + col,
        gs + ((size_t)t * B + w * W + j) * B + (w + 1) * W + col);
  }
}

template <typename V, int MK, bool TAB, bool ST>
__global__ void __launch_bounds__(THREADS)
wave_scan_kernel(const WaveArgs<V> a0) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  V* sm = reinterpret_cast<V*>(smem_bytes);
  const WaveArgs<V> a = wave_group(a0);
  const int T = a.T, B = a.B, K = a.K, W = a.W;
  const int TB = T * B, TW = T * W;
  const int nw = B / W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec = a.vec != 0;
  const Layout L = make_layout<V>(T, B, K, W, TAB ? 1 : 0, a.gsw);
  V* sc = sm + L.c;
  V* scorr = sm + L.corr;
  V* sbeta = sm + L.beta;
  V* sacum = sm + L.acum;
  V* su = sm + L.u;
  V* sz = sm + L.z;
  V* smsig = sm + L.msig;
  int* scomp = (int*)(sm + L.comp);
  int* slive = (int*)(sm + L.live);
  int* szerob = (int*)(sm + L.zerob);
  V* si2se = sm + L.i2se;
  V* snm1 = sm + L.nm1;
  int* goff = (int*)(sm + L.goff);
  V* swdb = sm + L.wdb;
  V* sgs = sm + L.gs;
  // The tables' k stride: the staged copy's, or the launch's in global
  // memory.
  const size_t tstride = TAB ? (size_t)TB : (size_t)a.TK * B;
  const V* lcp = TAB ? sm + L.lc : a.lc;
  const V* rdp = TAB ? sm + L.rd : a.rd;
  const V* sqbp = TAB ? sm + L.sqb : a.sqb;
  int ev = 0;
  auto stamp = [&]() {
    if (ST && tid == 0 && blockIdx.x == 0) a.stamps[ev] = global_ns();
    ++ev;
  };
  stamp();

  // The per-marker operands first, so that they arrive at the memory
  // system's full rate: in float a bulk copy of each array (one lane
  // each), in double cp.async copies of every thread (below); 4-byte
  // cp.async copies where an address is not on 16 bytes.
  uint64_t* bars = (uint64_t*)sm;
  constexpr int NB = nbar<V>();
  static_assert(8 * NB <= sizeof(V) * al4(2 * NBAR), "barrier slots");
  if (tid == 0) {
    for (int q = 0; q < NB; ++q) bar_init(bars + q);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    goff[0] = 0;
    for (int w = 0; w < nw; ++w)
      goff[w + 1] = goff[w] + T * W * row_stride<V>(B - (w + 1) * W);
  }
  __syncthreads();
  // A value of V is vw 4-byte words.
  constexpr int vw = sizeof(V) / 4;
  // Each table is one copy of its K planes when the CTA has every trait,
  // a copy a plane when its traits are a slice of each plane.
  const int tp = a.TK == T ? 1 : K;
  const int ktb = al4(K * TB);
  if constexpr (sizeof(V) == 8) {
    // Kernel E: every array by cp.async copies of every thread (16 bytes
    // where vec), named one by one, so that the operands do not queue in
    // the SM's bulk-copy unit behind the Gram rows' many small copies and
    // no list of them indexed at run time sits in local memory.
    copy_threads(sc, a.c, vw * TB, vec);
    copy_threads(sbeta, a.beta_old, vw * TB, vec);
    copy_threads(sacum, a.acum_old, vw * TB, vec);
    copy_threads(su, a.u, vw * TB, vec);
    copy_threads(sz, a.z, vw * TB, vec);
    copy_threads(scomp, a.comp_old, TB, vec);
    copy_threads(slive, a.live, TB, vec);
    copy_threads(szerob, a.zerob, TB, vec);
    if (a.msig) copy_threads(smsig, a.msig, vw * TB, vec);
    if (TAB) {
      for (int k = 0; k < 3 * tp; ++k) {
        const int q = k / tp, p = k % tp;
        const V* tab = q == 0 ? a.lc : q == 1 ? a.rd : a.sqb;
        copy_threads(sm + L.lc + q * ktb + p * TB,
                     tab + (size_t)p * a.TK * B,
                     vw * (tp == 1 ? K * TB : TB), vec);
      }
    }
  } else {
    // n: the piece's length in 4-byte words.
    struct Piece {
      void* dst;
      const void* src;
      int n;
    };
    const Piece state[] = {
        {sc, a.c, vw * TB},           {sbeta, a.beta_old, vw * TB},
        {sacum, a.acum_old, vw * TB}, {su, a.u, vw * TB},
        {sz, a.z, vw * TB},           {scomp, a.comp_old, TB},
        {slive, a.live, TB},          {szerob, a.zerob, TB},
        {smsig, a.msig, a.msig ? vw * TB : 0}};
    constexpr int NSTATE_OPS = sizeof(state) / sizeof(state[0]);
    const int nops = NSTATE_OPS + (TAB ? 3 * tp : 0);
    auto piece = [&](int k) -> Piece {
      if (k < NSTATE_OPS) return state[k];
      const int q = (k - NSTATE_OPS) / tp, p = (k - NSTATE_OPS) % tp;
      const V* tab = q == 0 ? a.lc : q == 1 ? a.rd : a.sqb;
      return {sm + L.lc + q * ktb + p * TB, tab + (size_t)p * a.TK * B,
              vw * (tp == 1 ? K * TB : TB)};
    };
    if (vec && tid == 0) {
      uint32_t bytes = 0;
      for (int k = 0; k < nops; ++k) bytes += 4u * piece(k).n;
      bar_arrive_tx(bars, bytes);
    }
    for (int k = 0; k < nops; ++k) {
      const Piece pc = piece(k);
      if (pc.n) copy_words(pc.dst, pc.src, pc.n, vec, bars, k, 0);
    }
  }
  // The packed Gram rows of the staged waves, issued by the warps that
  // draw nothing (by all when every warp draws), in wave order, a bulk
  // copy per row and trait (one lane each).  Float: at entry beside the
  // operands; wave 0's rows count on barrier 1, waited for before the
  // first fold, the other waves' on barrier 2, waited for before the
  // second.  Double: once the operands are in (issued at entry, the
  // bulk copies held the operands' barrier back by ~0.6 us a block),
  // wave w's rows on barrier 1 + min(w, NB - 2) (nbar), waited for before
  // the fold of the first wave on it.  Where an address is not on 16
  // bytes: value-sized cp.async copies once the operands are in, copy
  // group 0 for wave 0, 1 for the rest.
  const int draw_warps = (TW + 31) / 32;
  const bool bg_fold = draw_warps < NWARPS;
  const int tid0 = bg_fold ? 32 * draw_warps : 0;
  if (sizeof(V) == 4 && vec && tid == tid0 && a.gsw > 0) {
    bar_arrive_tx(bars + 1, (uint32_t)sizeof(V) * TW * (B - W));
    if (a.gsw > 1)
      bar_arrive_tx(bars + 2, (uint32_t)sizeof(V) * T *
                                  (gs_wave_offset(B, W, a.gsw) - W * (B - W)));
  }
  if (sizeof(V) == 4 && vec && tid >= tid0) {
    // Row r = t W + j of wave w.
    for (int x = tid - tid0; x < TW * a.gsw; x += THREADS - tid0) {
      const int w = x / TW, r = x % TW;
      const int t = r / W, j = r % W, rest = B - (w + 1) * W;
      bulk_copy(sgs + goff[w] + r * row_stride<V>(rest),
                a.gs + ((size_t)t * B + w * W + j) * B + (w + 1) * W,
                (uint32_t)sizeof(V) * rest, bars + (w == 0 ? 1 : 2));
    }
  }
  for (int t = tid; t < T; t += THREADS) {
    si2se[t] = a.i2se[t];
    snm1[t] = a.nm1 != nullptr ? a.nm1[t] : V(0);
  }
  for (int x = tid; x < TB; x += THREADS) scorr[x] = V(0);
  if (vec && sizeof(V) == 4) {
    bar_wait(bars);
  } else {
    // A wait covers committed copy groups only: commit the operands'.
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  stamp();
  if constexpr (sizeof(V) == 8) {
    if (vec && tid == tid0) {
      // Barrier q counts waves q - 1 .. wb - 1 (the last, every wave left).
      for (int q = 1; q < NB && q <= a.gsw; ++q) {
        const int wb = q == NB - 1 ? a.gsw : q;
        bar_arrive_tx(bars + q, (uint32_t)sizeof(V) * T *
                                    (gs_wave_offset(B, W, wb) -
                                     gs_wave_offset(B, W, q - 1)));
      }
    }
    if (vec && tid >= tid0) {
      for (int x = tid - tid0; x < TW * a.gsw; x += THREADS - tid0) {
        const int w = x / TW, r = x % TW;
        const int t = r / W, j = r % W, rest = B - (w + 1) * W;
        bulk_copy(sgs + goff[w] + r * row_stride<V>(rest),
                  a.gs + ((size_t)t * B + w * W + j) * B + (w + 1) * W,
                  (uint32_t)sizeof(V) * rest, bars + 1 + min(w, NB - 2));
      }
    }
  }
  if (!vec && tid >= tid0) {
    for (int w = 0; w < a.gsw; ++w) {
      stage_gs_wave<V>(sgs + goff[w], a.gs, T, B, W, w, tid0);
      if (w == 0) cp_async_commit();
    }
    cp_async_commit();
  }

  // Fold wave w's rank-W correction (its dbeta in swdb half w & 1) into
  // corr of the later waves' markers i in [i0, i1) (counted from the first
  // marker after wave w), on `nthr` threads from warp `warp0` on.  `split`
  // neighbouring lanes share an output, lane h summing the terms h,
  // h + split, ... in order, then a shuffle tree.  In float, split is the
  // largest power of two up to 8 that keeps the fold to one pass; in
  // double, the largest up to 8 and W, in as many passes as the outputs
  // need, so that a trait's bits do not depend on the CTA's traits or
  // threads (the plan's TG).  Whole warps run the loop, so every shuffle
  // has all its lanes.
  auto fold = [&](int w, int i0, int i1, int warp0, int nthr) {
    const int rs = row_stride<V>(B - (w + 1) * W);
    const int cols = i1 - i0;
    const V* sw = swdb + (w & 1) * TW;
    const bool staged = w < a.gsw;
    const V* gw = sgs + goff[w];
    int ls = 0;                                 // split = 1 << ls
    if constexpr (sizeof(V) == 8) {
      while (ls < 3 && (2 << ls) <= W) ++ls;
    } else {
      while (ls < 3 && T * cols * (2 << ls) <= nthr) ++ls;
    }
    const int split = 1 << ls;
    const int n = T * cols * split;
#pragma unroll 1
    for (int x0 = (warp - warp0) * 32; x0 < n; x0 += nthr) {
      const int x = x0 + lane;
      const int o = x >> ls, h = x & (split - 1);
      const int t = o / cols, i = i0 + o - t * cols;
      V s = V(0);
      if (x < n) {
        // Lane h of an output takes the terms j = h, h + split, ...
        const V* dw = sw + t * W;
        if (staged) {
          const V* g = gw + (size_t)t * W * rs + i;
#pragma unroll 4
          for (int j = h; j < W; j += split) s += dw[j] * g[j * rs];
        } else {
          const V* g =
              a.gs + ((size_t)t * B + w * W) * B + (w + 1) * W + i;
#pragma unroll 4
          for (int j = h; j < W; j += split)
            s += dw[j] * __ldg(g + (size_t)j * B);
        }
      }
      for (int dd = 1; dd < split; dd <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, dd);
      if (x < n && h == 0) scorr[t * B + (w + 1) * W + i] += s;
    }
  };

  const bool has_nm1 = a.nm1 != nullptr;
  int any_prev = 0;
#pragma unroll 1
  for (int w = 0; w < nw; ++w) {
    const int w0 = w * W;
    V* sw = swdb + (w & 1) * TW;         // this wave's dbeta, (T, W)
    int moved = 0;
#pragma unroll 1
    for (int x = tid; x < TW; x += THREADS) {
      const int t = x / W;
      const int o = t * B + w0 + x % W;
      // base = c + beta_old * (nonas - 1), rounded as the plain expression.
      const V base =
          has_nm1 ? add_rn(sc[o], mul_rn(sbeta[o], snm1[t])) : sc[o];
      const V num = add_rn(base, scorr[o]);
      const GmrmDrawT<V> dr = gmrm_draw<MK>(
          num, si2se[t], lcp + o, rdp + o, sqbp + o, tstride, K, su[o],
          sz[o]);
      const bool lv = slive[o] != 0;
      const bool zb = szerob[o] != 0;
      const V bo = sbeta[o];
      const V db = lv ? sub_rn(bo, dr.samp) : V(0);
      a.dbeta[o] = db;
      if (a.d != nullptr) a.d[o] = mul_rn(smsig[o], db);
      a.beta_new[o] = lv ? dr.samp : (zb ? V(0) : bo);
      a.comp_new[o] = lv ? dr.comp : scomp[o];
      a.acum_new[o] = lv ? dr.acum : (zb ? V(1) : sacum[o]);
      sw[x] = db;
      moved |= (db != V(0));
    }
    // Meanwhile the warps that draw nothing fold the wave before into the
    // waves after this one.
    if (bg_fold && warp >= draw_warps && w >= 1 && any_prev && w + 1 < nw)
      fold(w - 1, W, B - w0, draw_warps, THREADS - 32 * draw_warps);
    // The Gram rows the next fold reads: wave w's, where it is the first
    // wave on its barrier (or its copy group).
    if (sizeof(V) == 8 && vec) {
      if (w < a.gsw && w < NB - 1) bar_wait(bars + 1 + w);
    } else if (w == 0 && a.gsw > 0) {
      if (vec)
        bar_wait(bars + 1);
      else
        cp_async_wait<1>();
    } else if (w == 1 && a.gsw > 1) {
      if (vec)
        bar_wait(bars + 2);
      else
        cp_async_wait<0>();
    }
    const int any = __syncthreads_or(moved);
    stamp();
    // The fold the next wave's draw waits for: this wave into the next
    // one (into every later one when no warp is free to fold in the
    // background).
    if (any && w + 1 < nw) fold(w, 0, bg_fold ? W : B - w0 - W, 0, THREADS);
    __syncthreads();
    stamp();
    any_prev = any;
  }
  cp_async_wait<0>();
}

template <typename V, int MK, bool TAB, bool ST>
int launch_kernel(const WaveArgs<V>& a, size_t smem, cudaStream_t s) {
  // The attribute is set once per device, to the most a CTA can have.
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(wave_scan_kernel<V, MK, TAB, ST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_CAP);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) raised[dev] = true;
  }
  wave_scan_kernel<V, MK, TAB, ST><<<(a.T + a.TG - 1) / a.TG, THREADS,
                                     smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename V, int MK>
int launch(const WaveArgs<V>& a, size_t smem, cudaStream_t s) {
  const bool st = a.stamps != nullptr;
  if (a.tab)
    return st ? launch_kernel<V, MK, true, true>(a, smem, s)
              : launch_kernel<V, MK, true, false>(a, smem, s);
  return st ? launch_kernel<V, MK, false, true>(a, smem, s)
            : launch_kernel<V, MK, false, false>(a, smem, s);
}

template <typename V>
int run(const void* c, const void* nm1, const void* lc, const void* rd,
        const void* sqb, const void* gs, const void* beta_old,
        const void* comp_old, const void* acum_old, const void* u,
        const void* z, const void* live, const void* zerob, const void* msig,
        const void* i2se, void* dbeta, void* d, void* beta_new,
        void* comp_new, void* acum_new, void* stamps, int b, int bc, int bg,
        int T, int B, int K, int W, int tab, int gsw, int TG, void* stream) {
  if (K < 1 || T < 1 || B < 1 || W < 1 || B % W != 0 ||
      b < 0 || bc < 0 || bg < 0 || tab < 0 || tab > 1 || gsw < 0 ||
      gsw > B / W || (msig == nullptr) != (d == nullptr) || TG < 1 ||
      TG > T || (T + TG - 1) / TG > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t tb = (size_t)b * T * B, ktb = (size_t)b * K * T * B;
  WaveArgs<V> a;
  a.c = (const V*)c + (size_t)bc * T * B;
  a.nm1 = (const V*)nm1;
  a.lc = (const V*)lc + ktb;
  a.rd = (const V*)rd + ktb;
  a.sqb = (const V*)sqb + ktb;
  a.gs = (const V*)gs + (size_t)bg * T * B * B;
  a.beta_old = (const V*)beta_old + tb;
  a.comp_old = (const int*)comp_old + tb;
  a.acum_old = (const V*)acum_old + tb;
  a.u = (const V*)u + tb;
  a.z = (const V*)z + tb;
  a.live = (const int*)live + tb;
  a.zerob = (const int*)zerob + tb;
  a.msig = msig ? (const V*)msig + tb : nullptr;
  a.i2se = (const V*)i2se;
  a.dbeta = (V*)dbeta + tb;
  a.d = d ? (V*)d + tb : nullptr;
  a.beta_new = (V*)beta_new + tb;
  a.comp_new = (int*)comp_new + tb;
  a.acum_new = (V*)acum_new + tb;
  a.stamps = (unsigned long long*)stamps;
  a.T = T;
  a.B = B;
  a.K = K;
  a.W = W;
  a.tab = tab;
  a.gsw = gsw;
  a.TK = T;
  a.TG = TG;
  const void* ptrs[] = {a.c,    a.lc,       a.rd,       a.sqb, a.gs,
                        a.beta_old, a.comp_old, a.acum_old, a.u, a.z,
                        a.live, a.zerob,    a.msig};
  int vec = B % 4 == 0 && W % 4 == 0;
  for (const void* p : ptrs) vec &= ((uintptr_t)p % 16 == 0);
  a.vec = vec;
  const size_t smem =
      sizeof(V) * (size_t)make_layout<V>(TG, B, K, W, tab, gsw).words;
  if (smem > (size_t)SMEM_CAP) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 4) return launch<V, 4>(a, smem, s);
  if (K <= 8) return launch<V, 8>(a, smem, s);
  if (K <= GMRM_MAX_K) return launch<V, 16>(a, smem, s);
  return launch<V, GMRM_ANY_K>(a, smem, s);
}

}  // namespace

// The sweep's arrays: beta_old, acum_old, u, z, msig, dbeta, d, beta_new,
// acum_new (nb, T, B) float32; comp_old, live, zerob, comp_new (nb, T, B)
// int32; lc, rd, sqb (nb, K, T, B); block b of them is scanned.  c (nc, T,
// B), row bc; gs (nr, T, B, B), Gram bg.  nm1, msig and d null: c is base
// itself and d is not written (the one-block interface).  tab, gsw: the
// plan of ops/scan_kernel_wave.wave_plan at TG traits (tables staged; the
// waves whose Gram rows are staged).  TG: traits a CTA, ceil(T / TG) CTAs
// (TG = T: one CTA).  stamps: (2 + 2 nw) int64 or null, %globaltimer at
// ops/scan_kernel_wave.wave_stamp_names' events, by thread 0 of CTA 0.
extern "C" int gmrm_wave_scan(
    const void* c, const void* nm1, const void* lc, const void* rd,
    const void* sqb, const void* gs, const void* beta_old,
    const void* comp_old, const void* acum_old, const void* u, const void* z,
    const void* live, const void* zerob, const void* msig, const void* i2se,
    void* dbeta, void* d, void* beta_new, void* comp_new, void* acum_new,
    void* stamps, int b, int bc, int bg, int T, int B, int K, int W, int tab,
    int gsw, int TG, void* stream) {
  return run<float>(c, nm1, lc, rd, sqb, gs, beta_old, comp_old, acum_old, u,
                    z, live, zerob, msig, i2se, dbeta, d, beta_new, comp_new,
                    acum_new, stamps, b, bc, bg, T, B, K, W, tab, gsw, TG,
                    stream);
}

// The same in float64 (kernel E): every float array float64; tab, gsw, TG
// from ops/scan_kernel_wave.launch_plan at 8-byte values (any plan that
// fits gives each trait the same bits).
extern "C" int gmrm_wave_scan_f64(
    const void* c, const void* nm1, const void* lc, const void* rd,
    const void* sqb, const void* gs, const void* beta_old,
    const void* comp_old, const void* acum_old, const void* u, const void* z,
    const void* live, const void* zerob, const void* msig, const void* i2se,
    void* dbeta, void* d, void* beta_new, void* comp_new, void* acum_new,
    void* stamps, int b, int bc, int bg, int T, int B, int K, int W, int tab,
    int gsw, int TG, void* stream) {
  return run<double>(c, nm1, lc, rd, sqb, gs, beta_old, comp_old, acum_old,
                     u, z, live, zerob, msig, i2se, dbeta, d, beta_new,
                     comp_new, acum_new, stamps, b, bc, bg, T, B, K, W, tab,
                     gsw, TG, stream);
}
