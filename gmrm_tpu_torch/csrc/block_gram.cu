// Scaled Grams of a run of blocks of the exact-serial (W=1) sweep, whose
// uniform shuffle changes block membership every iteration, so the Gram
// cannot be cached.  For block n of the run, with ab = [A; B] of its
// marker rows rows[n, 0..B-1] (2B x 4mb) and mask nt (0 when NT = 1, else
// the trait t):
//   g1[j, i]  = sum_n na a_j a_i,  g2t[j, i] = sum_n na a_j b_i,
//   g3[j, i]  = sum_n na b_j b_i,  g2[j, i]  = sum_n na b_j a_i,
//   gs[n, t, j, i] = (msig_j msig_i) * (g1 - m_i g2t - m_j g2 + (m_j m_i) g3)
//
// Replaces the Gram half of _gram_kernel (gmrm_tpu/ops/pallas_kernels.py:135,
// built by _build_gram_call :205, wrapper block_gram_scaled_pallas :238);
// the residual dot products c of that kernel are the c-dot kernel
// (block_cdot.cu).  The Gram does not depend on the residual, so the sweep
// builds the Grams of all its blocks (or of a run of them, under a byte
// budget) before the serial block loop: one launch per run.
//
// Bound on the H100: int8 multiply-adds (the products the function needs:
// g1 and g3 symmetric, g2t whole, over the individuals) at 1,979 TOP/s, or
// the gs written once (T B^2 elements a block: 82 MB of float64 a sweep at
// the anchor, 0.025 ms), whichever is longer.
//
// Design: one persistent launch, warp-specialised, on the int8 wgmma.
// - Work item: one block n, one mask, a band J of 64 rows (markers) and a
//   tile I of 128 columns.  Its CTA holds all four raw terms of its
//   outputs: consumer warpgroup w takes the columns I0 + 64w .. + 63 and
//   runs two m64n128k32 wgmma's a k-step, a_J . [a_Iw; b_Iw]^T (g1 and
//   g2t) and b_J . [a_Iw; b_Iw]^T (g2 and g3), 128 int32 accumulators a
//   thread.  g1, g2t, g2 and g3 of an output (j, i) land in one thread, so
//   the scaling runs in the epilogue straight from the accumulators, for
//   every trait the mask serves, and gs is written once, in whole 32-byte
//   sectors; no raw Gram touches global memory and no second pass runs.
//   g2 is computed (4/3 of the three quadrants' products) instead of
//   transposed.
// - Two producer warpgroups stage the operands for 128 individuals (32
//   bed bytes a row; a thread takes 16 bytes of a row) at a time into a
//   ring of stages guarded by mbarriers (full: the producers' 256
//   arrivals; empty: the 8 consumer warps').  Each producer thread copies
//   its bytes with cp.async into a raw ring three stages ahead of its
//   decode, across items.  Two groups, because one warp an SM
//   sub-partition issues the dependent decode too slowly to feed the
//   wgmma's.  The bytes are masked and decoded with bit operations, 16
//   individuals of a bed word at once, into int8 panels of 64 rows x 128
//   bytes in the 128-byte swizzle that the wgmma descriptors read (both
//   operands K-major: each marker's individuals are contiguous).  The K
//   order inside a group of 16 individuals is transposed (word q of a
//   chunk holds code q of four bytes): the sum is order-free, since every
//   term is an exact integer, and both operands use the same order.
//   Masked individuals decode to 0 on both planes, so keep * keep = keep.
// - The tile I is decoded once per item; a band J inside it (every item
//   when B <= 128) is read from the I panels by descriptor, so those
//   items decode each bed byte of the block once per plane.  A band
//   outside it gets two panels of its own.
// - The keep bits (one word per 4 bed columns) are built by the producers
//   into shared memory from the 0/1 float mask when a CTA's mask changes
//   (items run mask by mask), in segments of 16,384 columns on wider rows.
// - setmaxnreg gives the consumers 184 registers and the producers 72.
// - The grid is one CTA an SM (up to the number of items); CTA c takes
//   items c, c + grid, ...  The host plans the launch (panels a stage,
//   stages, grid: ops/block_gram.gram_plan); the launcher checks it.
// Every raw entry is an exact count below 2^24, and the scaling uses the
// _rn intrinsics in the plain expression's order (sweep_math.cuh), so gs
// is bit-equal to the plain PyTorch version on the card.
//
// Float64 (kernel A, gmrm_block_gram_f64): the same kernel with the
// scaling instantiated at double (mave, msig and gs float64; the NA mask
// stays float32 0/1), bit-equal to the plain version at float64 too.  It
// replaces the float64 side of kernel 5: on a float64 run the JAX package
// takes the XLA einsum of _block_gram_wide (gmrm_tpu/ops/blockops.py:131,
// through pallas_kernels.py:251-254).
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_mma.cuh"
#include "sweep_math.cuh"

namespace {

constexpr int BAND = 64;              // markers of a panel
constexpr int ITILE = 2 * BAND;       // markers of a tile I
constexpr int NBY = 32;               // bed bytes (128 individuals) a stage
constexpr int PANEL = BAND * 128;     // bytes of a panel in one stage
constexpr int PRODUCERS = 256;        // two producer warpgroups
constexpr int THREADS = PRODUCERS + 256;  // and two consumer warpgroups
constexpr int RAW_SLOTS = 4;          // stages of raw bed bytes in flight
constexpr int RAW_AHEAD = 3;          // stages copied ahead of the decode
constexpr int KEEP_WORDS = 4096;      // keep words staged (16,384 columns)
constexpr int KEEP_COLS = 4 * KEEP_WORDS;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_CAP = 232448;      // dynamic shared memory of one CTA
// Alignment slack, keep words, barriers, the epilogue's staged statistics,
// the raw ring.
constexpr int SMEM_FIXED = 1024 + 4 * KEEP_WORDS + 2 * MAX_STAGES * 8 +
                           2 * 256 * 8 + RAW_SLOTS * PRODUCERS * 32;
// Stamps a CTA: start, main loops', epilogues', end, the consumers' waits
// for a full stage and the producers' for an empty one (ns).
constexpr int NSTAMP = 6;

template <typename V>
struct GramArgs {
  const uint8_t* bed;
  const int* rows;
  const float* na;
  const V* mave;
  const V* msig;
  V* gs;
  long long* stamps;
  int T, B, mb, nt, nb, bands, tiles, panels, stages;
  long long items;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// The arrival of one thread of a warp (the predicate in the instruction,
// not a branch: the consumers' loop around the wgmma's stays uniform).
__device__ __forceinline__ void bar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)pred) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

// wgmma descriptor of a K-major panel in the 128-byte swizzle: 8-row groups
// 1,024 bytes apart; the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads across the waits.
__device__ __forceinline__ void pin(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A . B^T over 32 individuals: A 64 rows, B 128 rows, int8, K-major.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Item q -> (mask m, block n, band jb, tile ip); items run mask by mask.
__device__ __forceinline__ void item_of(long long q, int nb, int bands,
                                        int tiles, int& m, int& n, int& jb,
                                        int& ip) {
  ip = (int)(q % tiles);
  q /= tiles;
  jb = (int)(q % bands);
  q /= bands;
  n = (int)(q % nb);
  m = (int)(q / nb);
}

// Byte offset of 16-byte chunk c of row r in a panel (128-byte swizzle).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((c ^ (r & 7)) << 4);
}

// One bed word w (16 codes) under its keep word kw (bit 2j: code j counts)
// into a 16-byte chunk of each plane: word q holds code q of bytes 0..3,
// a in {0, 1, 2}, b in {0, 1}, as int8 (decode.cuh's map; a masked code
// gives 0 on both).
__device__ __forceinline__ void decode_chunk(uint32_t w, uint32_t kw,
                                             uint4& a, uint4& b) {
  const uint32_t lo = w & 0x55555555u, hi = (w >> 1) & 0x55555555u;
  const uint32_t av = ((~(lo | hi) & kw) << 1) | (hi & ~lo & kw);
  const uint32_t bv = (hi | ~lo) & kw;
  a = make_uint4(av & 0x03030303u, (av >> 2) & 0x03030303u,
                 (av >> 4) & 0x03030303u, (av >> 6) & 0x03030303u);
  b = make_uint4(bv & 0x01010101u, (bv >> 2) & 0x01010101u,
                 (bv >> 4) & 0x01010101u, (bv >> 6) & 0x01010101u);
}

// 16 bed bytes (4 chunks from chunk c0) of row r into panels pa (a) and
// pb (b).
__device__ __forceinline__ void stage_row(uint8_t* pa, uint8_t* pb, int r,
                                          int c0, uint4 by, uint4 kw) {
  const uint32_t bw[4] = {by.x, by.y, by.z, by.w};
  const uint32_t kk[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    uint4 a, b;
    decode_chunk(bw[v], kk[v], a, b);
    const uint32_t o = swz(r, c0 + v);
    *reinterpret_cast<uint4*>(pa + o) = a;
    *reinterpret_cast<uint4*>(pb + o) = b;
  }
}

// Keep words of bed columns col0 .. col0 + KEEP_COLS - 1 (as far as the
// stages reach; none past mb) of mask (4, mb), by the producers.
__device__ __forceinline__ void build_keep(uint32_t* keep,
                                           const float* __restrict__ na,
                                           int mb, int col0, int p) {
  const int ncols = min(KEEP_COLS, (mb + NBY - 1) / NBY * NBY - col0);
  for (int x = p; x < ncols / 4; x += PRODUCERS) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = col0 + 4 * x + b;
      if (col < mb) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (na[(size_t)k * mb + col] != 0.0f) w |= 1u << (8 * b + 2 * k);
      }
    }
    keep[x] = w;
  }
}

// 16 bytes from global to shared memory, completed per thread by
// cp.async.wait_group.
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

template <typename V, bool VEC>
__device__ __forceinline__ void producer(const GramArgs<V>& a,
                                         uint8_t* stages, uint32_t* keep,
                                         uint8_t* raw, uint64_t* full,
                                         uint64_t* empty) {
  const int p = threadIdx.x;                 // 0..PRODUCERS-1
  const int nst = (a.mb + NBY - 1) / NBY;
  const int stage_bytes = a.panels * PANEL;
  const bool segmented = a.mb > KEEP_COLS;
  // Row it of the tile I (panels ipa, ipa + 1), half ih of its 32 bytes;
  // the first group also takes a band outside the tile: row jr, 16 bytes
  // from chunk jc.
  const int it = p % ITILE, ih = p / ITILE;
  const int ir = it % BAND, ipa = 2 * (it / BAND);
  const int jr = (p >> 1) % BAND, jc = 4 * (p & 1);
  const uint4 pad = make_uint4(0x55555555u, 0x55555555u, 0x55555555u,
                               0x55555555u);
  const int mine = (int)((a.items - blockIdx.x + gridDim.x - 1) / gridDim.x);
  // This thread's raw bytes of a stage in ring slot r: h = 0 its I row's
  // 16, h = 1 its band row's (the threads' 16 bytes side by side); only
  // this thread writes and reads them.
  auto raw_at = [&](int r, int h) {
    return reinterpret_cast<uint4*>(raw) + (2 * r + h) * PRODUCERS + p;
  };
  // The bytes of the stages RAW_AHEAD before their decode, item after
  // item: 16-byte cp.async copies (pad rows and columns past mb: 0x55), or
  // loads and stores where the rows are not on 16 bytes.  One commit
  // group a stage, empty past the CTA's last.
  int pf_k = 0, pf_s = 0, pf_r = 0;
  const uint8_t* pf_irow = nullptr;
  const uint8_t* pf_jrow = nullptr;
  bool pf_j = false;
  auto prefetch = [&]() {
    if (pf_k < mine) {
      if (pf_s == 0) {
        int m, n, jb, ip;
        item_of(blockIdx.x + (long long)pf_k * gridDim.x, a.nb, a.bands,
                a.tiles, m, n, jb, ip);
        const int I0 = ip * ITILE, J0 = jb * BAND;
        const int* rows = a.rows + (size_t)n * a.B;
        pf_j = !(J0 >= I0 && J0 < I0 + ITILE) && p < ITILE;
        pf_irow =
            I0 + it < a.B ? a.bed + (size_t)rows[I0 + it] * a.mb : nullptr;
        pf_jrow = pf_j && J0 + jr < a.B
                      ? a.bed + (size_t)rows[J0 + jr] * a.mb
                      : nullptr;
      }
      const int col0 = pf_s * NBY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !pf_j) break;
        const uint8_t* row = h == 0 ? pf_irow : pf_jrow;
        const int col = col0 + (h == 0 ? 16 * ih : 4 * jc);
        uint4* dst = raw_at(pf_r, h);
        if (!VEC)
          *dst = gmma_load16(row, col, a.mb, false);
        else if (row != nullptr && col < a.mb)
          cp16(dst, row + col);
        else
          *dst = pad;
      }
      if (++pf_s == nst) {
        pf_s = 0;
        ++pf_k;
      }
      pf_r = (pf_r + 1) % RAW_SLOTS;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int g = 0; g < RAW_AHEAD; ++g) prefetch();

  int km = -1, slot = 0, r = 0;
  uint32_t phase = 0;
  const bool stamp = a.stamps != nullptr && p == 0;
  unsigned long long wait_ns = 0;
  for (int k = 0; k < mine; ++k) {
    int m, n, jb, ip;
    item_of(blockIdx.x + (long long)k * gridDim.x, a.nb, a.bands, a.tiles, m,
            n, jb, ip);
    const int I0 = ip * ITILE, J0 = jb * BAND;
    const bool jwork = !(J0 >= I0 && J0 < I0 + ITILE) && p < ITILE;
    for (int s = 0; s < nst; ++s) {
      prefetch();
      // This stage's copies have landed once RAW_AHEAD groups are left.
      asm volatile("cp.async.wait_group %0;\n" ::"n"(RAW_AHEAD) : "memory");
      const int col0 = s * NBY;
      if (col0 % KEEP_COLS == 0 && (segmented || m != km)) {
        asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
        build_keep(keep, a.na + (size_t)m * 4 * a.mb, a.mb, col0, p);
        asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
        km = m;
      }
      const uint32_t* kp = keep + (col0 % KEEP_COLS) / 4;
      const uint4 b0 = *raw_at(r, 0);
      const uint4 b1 = jwork ? *raw_at(r, 1) : b0;
      r = (r + 1) % RAW_SLOTS;
      if (stamp) {
        const unsigned long long t_w = global_ns();
        bar_wait(&empty[slot], phase ^ 1);
        wait_ns += global_ns() - t_w;
      } else {
        bar_wait(&empty[slot], phase ^ 1);
      }
      uint8_t* sb = stages + (size_t)slot * stage_bytes;
      stage_row(sb + ipa * PANEL, sb + (ipa + 1) * PANEL, ir, 4 * ih, b0,
                *reinterpret_cast<const uint4*>(kp + 4 * ih));
      if (jwork)
        stage_row(sb + 4 * PANEL, sb + 5 * PANEL, jr, jc, b1,
                  *reinterpret_cast<const uint4*>(kp + jc));
      // The panels are read by the wgmma's (the async proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(&full[slot]);
      if (++slot == a.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
  if (stamp) a.stamps[(size_t)blockIdx.x * NSTAMP + 5] = (long long)wait_ns;
}

// Two neighbouring outputs in one store (o on 2 elements: B even).
__device__ __forceinline__ void store2(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(double* o, double v0, double v1) {
  *reinterpret_cast<double2*>(o) = make_double2(v0, v1);
}

// A raw count (0 <= x < 2^31) as V: float32 counts were converted in
// place once per item (exact below 2^24); a double is made from the
// integer bits, 2^52 + x minus 2^52, one add instead of a conversion
// (which issues at a quarter of the add rate).  Both exact.
__device__ __forceinline__ float count_of(int x, float) {
  return __int_as_float(x);
}
__device__ __forceinline__ double count_of(int x, double) {
  return __dsub_rn(__hiloint2double(0x43300000, x), 4503599627370496.0);
}

// gs of this thread's outputs of the item from its accumulators: rows
// r0 + 8h of the band (r0 = 16 warp + lane / 4), columns c0 + 8g and
// c0 + 8g + 1 of the group's 64 (c0 = 2 (lane % 4)), g < 8.  Per trait,
// the group stages the band's and its columns' mave and msig in shared
// memory (st: 4 x 64 values), so the 16 outputs a row reads see no
// global latency.
template <typename V>
__device__ __forceinline__ void epilogue(const GramArgs<V>& a, int (&d0)[64],
                                         int (&d1)[64], int m, int n, int J0,
                                         int Iw, int w, int tid, V* st) {
  if (sizeof(V) == 4) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      d0[i] = __float_as_int((float)d0[i]);
      d1[i] = __float_as_int((float)d1[i]);
    }
  }
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int t0 = a.nt == 1 ? 0 : m, t1 = a.nt == 1 ? a.T : m + 1;
  const bool pairs = (a.B & 1) == 0;
  for (int t = t0; t < t1; ++t) {
    const size_t nt = (size_t)n * a.T + t;
    // st[0..63] mave, st[64..127] msig of the band; st[128..] the columns'.
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
#pragma unroll
    for (int x = tid; x < 256; x += 128) {
      const int k = (x < 128 ? J0 : Iw) + x % 64;
      const V* src = (x / 64) % 2 ? a.msig : a.mave;
      st[x] = k < a.B ? src[nt * a.B + k] : V(0);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
    V* out = a.gs + nt * a.B * a.B;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = J0 + r0 + 8 * h;
      if (j < a.B) {
        const V mc = st[r0 + 8 * h], sc = st[64 + r0 + 8 * h];
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int ci = c0 + 8 * g, i = Iw + ci;
          const int e = 4 * g + 2 * h;
          if (i < a.B) {
            const V v0 = gmrm_scale_gram(
                count_of(d0[e], V()), count_of(d1[e], V()),
                count_of(d0[32 + e], V()), count_of(d1[32 + e], V()),
                st[128 + ci], mc, st[192 + ci], sc);
            V* o = out + (size_t)j * a.B + i;
            if (i + 1 < a.B) {
              const V v1 = gmrm_scale_gram(
                  count_of(d0[e + 1], V()), count_of(d1[e + 1], V()),
                  count_of(d0[33 + e], V()), count_of(d1[33 + e], V()),
                  st[129 + ci], mc, st[193 + ci], sc);
              if (pairs) {
                store2(o, v0, v1);
              } else {
                o[0] = v0;
                o[1] = v1;
              }
            } else {
              o[0] = v0;
            }
          }
        }
      }
    }
  }
}

template <typename V>
__device__ __forceinline__ void consumer(const GramArgs<V>& a,
                                         uint8_t* stages, uint64_t* full,
                                         uint64_t* empty, V* st, int w) {
  const int tid = threadIdx.x - PRODUCERS - 128 * w;  // 0..127 in the group
  const int lane = tid % 32;
  const int nst = (a.mb + NBY - 1) / NBY;
  const uint32_t stage_bytes = a.panels * PANEL;
  const uint32_t sbase = smem_u32(stages);
  // Group 0 times itself (uniformly, so no branch splits the group);
  // its thread 0 writes the stamps.
  const bool stamp = a.stamps != nullptr && w == 0;
  const unsigned long long t_begin = stamp ? global_ns() : 0;
  unsigned long long loop_ns = 0, epi_ns = 0, wait_ns = 0;
  int slot = 0;
  uint32_t phase = 0;
  int d0[64] = {}, d1[64] = {};
  for (long long q = blockIdx.x; q < a.items; q += gridDim.x) {
    const unsigned long long t_item = stamp ? global_ns() : 0;
    int m, n, jb, ip;
    item_of(q, a.nb, a.bands, a.tiles, m, n, jb, ip);
    const int I0 = ip * ITILE, J0 = jb * BAND;
    const bool inside = J0 >= I0 && J0 < I0 + ITILE;
    const bool live = I0 + BAND * w < a.B;   // this group has columns
    const int pa = inside ? 2 * ((J0 - I0) / BAND) : 4;  // a_J; b_J: pa + 1
    const int pb = 2 * w;                                // [a_Iw; b_Iw]
    int prev = -1;
    for (int s = 0; s < nst; ++s) {
      if (stamp) {
        const unsigned long long t_w = global_ns();
        bar_wait(&full[slot], phase);
        wait_ns += global_ns() - t_w;
      } else {
        bar_wait(&full[slot], phase);
      }
      if (live) {
        const uint32_t sa = sbase + slot * stage_bytes;
        const uint64_t da = desc_sw128(sa + pa * PANEL);
        const uint64_t db = desc_sw128(sa + (pa + 1) * PANEL);
        const uint64_t di = desc_sw128(sa + pb * PANEL);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // 32 individuals further along the swizzled rows: +32 bytes.
          const int acc = (s | k) != 0;
          wgmma_s8_n128(d0, da + 2 * k, di + 2 * k, acc);
          wgmma_s8_n128(d1, db + 2 * k, di + 2 * k, acc);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0) bar_arrive_if(&empty[prev], lane == 0);
        prev = slot;
      } else {
        bar_arrive_if(&empty[slot], lane == 0);
      }
      if (++slot == a.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    if (!live) continue;
    wgmma_wait<0>();
    pin(d0);
    pin(d1);
    bar_arrive_if(&empty[prev], lane == 0);
    const unsigned long long t_loop = stamp ? global_ns() : 0;
    epilogue(a, d0, d1, m, n, J0, I0 + BAND * w, w, tid, st);
    if (stamp) {
      const unsigned long long t_end = global_ns();
      loop_ns += t_loop - t_item;
      epi_ns += t_end - t_loop;
    }
  }
  if (stamp && tid == 0) {
    long long* o = a.stamps + (size_t)blockIdx.x * NSTAMP;
    o[0] = (long long)t_begin;
    o[1] = (long long)loop_ns;
    o[2] = (long long)epi_ns;
    o[3] = (long long)global_ns();
    o[4] = (long long)wait_ns;
  }
}

template <typename V, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
block_gram_kernel(const GramArgs<V> a) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzled panels need 1,024-byte alignment.
  uint8_t* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint32_t* keep =
      reinterpret_cast<uint32_t*>(stages + a.stages * a.panels * PANEL);
  uint64_t* full = reinterpret_cast<uint64_t*>(keep + KEEP_WORDS);
  uint64_t* empty = full + MAX_STAGES;
  // Each consumer group's staged statistics (epilogue).
  V* st = reinterpret_cast<V*>(empty + MAX_STAGES);
  uint8_t* raw = reinterpret_cast<uint8_t*>(st + 2 * 256);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      bar_init(&full[s], PRODUCERS);
      bar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The warpgroup's index through a shuffle, so the compiler knows it is
  // uniform across the group (a wgmma in a branch it takes for divergent
  // would be serialized).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg < PRODUCERS / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    producer<V, VEC>(a, stages, keep, raw, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n");
    const int w = wg - PRODUCERS / 128;
    consumer(a, stages, full, empty, st + 256 * w, w);
  }
}

template <typename V>
int launch_gram(const void* bed, const void* rows, const void* na,
                const void* mave, const void* msig, void* gs, void* stamps,
                int nb, int T, int B, int mb, int nt, int panels, int stages,
                int grid, cudaStream_t s) {
  // A band outside its tile (B > ITILE) takes two panels of its own.
  if (nb < 1 || T < 1 || B < 1 || mb < 1 || (nt != 1 && nt != T) ||
      (panels != 4 && panels != 6) || (B > ITILE && panels != 6) ||
      stages < 2 || stages > MAX_STAGES || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = SMEM_FIXED + stages * panels * PANEL;
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  const bool vec = (mb % 16 == 0) && ((uintptr_t)bed % 16 == 0);
  void (*kernel)(const GramArgs<V>) =
      vec ? block_gram_kernel<V, true> : block_gram_kernel<V, false>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  GramArgs<V> a;
  a.bed = (const uint8_t*)bed;
  a.rows = (const int*)rows;
  a.na = (const float*)na;
  a.mave = (const V*)mave;
  a.msig = (const V*)msig;
  a.gs = (V*)gs;
  a.stamps = (long long*)stamps;
  a.T = T;
  a.B = B;
  a.mb = mb;
  a.nt = nt;
  a.nb = nb;
  a.bands = (B + BAND - 1) / BAND;
  a.tiles = (B + ITILE - 1) / ITILE;
  a.panels = panels;
  a.stages = stages;
  a.items = (long long)nb * nt * a.bands * a.tiles;
  kernel<<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// bed (m_pad, mb) uint8; rows (nb, B) int32; na (nt, 4, mb) float32 0/1;
// mave/msig (nb, T, B) float32; gs (nb, T, B, B) float32; stamps (grid,
// NSTAMP) int64 or null: per CTA its start, its main loops' and
// epilogues' ns summed over its items, its end (%globaltimer), and the ns
// its consumers (group 0) waited for full stages and its producers for
// empty ones.  panels (4, or 6 when B > 128), stages and grid: the plan
// (ops/block_gram.gram_plan).
extern "C" int gmrm_block_gram(const void* bed, const void* rows,
                               const void* na, const void* mave,
                               const void* msig, void* gs, void* stamps,
                               int nb, int T, int B, int mb, int nt,
                               int panels, int stages, int grid,
                               void* stream) {
  return launch_gram<float>(bed, rows, na, mave, msig, gs, stamps, nb, T, B,
                            mb, nt, panels, stages, grid,
                            (cudaStream_t)stream);
}

// Kernel A: as gmrm_block_gram, with mave/msig (nb, T, B) and gs
// (nb, T, B, B) float64 (na stays the float32 0/1 mask).
extern "C" int gmrm_block_gram_f64(const void* bed, const void* rows,
                                   const void* na, const void* mave,
                                   const void* msig, void* gs, void* stamps,
                                   int nb, int T, int B, int mb, int nt,
                                   int panels, int stages, int grid,
                                   void* stream) {
  return launch_gram<double>(bed, rows, na, mave, msig, gs, stamps, nb, T,
                             B, mb, nt, panels, stages, grid,
                             (cudaStream_t)stream);
}
