// The NA-masked integer Gram tile of 2-bit genotypes on the int8 tensor
// cores: a 128 x 128 tile of  sum_n keep[n] * x_r[n] * y_c[n]  over the
// individuals n, where x and y are the a (0/1/2) or b (0/1) decode of the
// bed rows of 128 markers each: the Gram cache's tile (gram_cache.cu).  The
// block Gram (block_gram.cu, on wgmma) takes its 16-byte row loader.
//
// Design for the H100:
// - The sum over individuals is order-free (every term is an exact
//   integer), so the reduction index is laid out however the hardware
//   likes it: one bed byte (4 individuals) decodes, with a handful of
//   bitwise operations on all four codes at once, into one 32-bit word of
//   four int8 values, which is exactly the unit of an
//   mma.sync.m16n8k32.s8 fragment register.  Both operands are "K-major"
//   (each marker's individuals are contiguous), so the A (row.) and the B
//   (.col) fragments are read from the same kind of tile.
// - The mask is 0/1, so keep = keep * keep: it is applied to the packed
//   byte before the decode (a masked individual becomes the missing code
//   01, whose a and b are 0), on both operands alike.  A diagonal tile
//   (same markers, same plane on both sides) is therefore staged once.
// - A CTA of 256 threads (8 warps, 4 x 2, each 32 x 64 outputs = 2 x 8
//   mma tiles, 64 int32 accumulators a thread) walks the individuals in
//   chunks of 32 bed bytes (128 individuals, 4 mma k-steps).  The next
//   chunk's bytes are loaded into registers before the current chunk's
//   mma's and decoded into shared memory after them.  Tile rows are 36
//   words apart (32 + 4), so the fragment loads (8 rows x 4 words a
//   request) and the 16-byte staging stores touch every bank once.
#pragma once

#include <stdint.h>

constexpr int GMMA_TILE = 128;      // markers per tile side
constexpr int GMMA_NBY = 32;        // bed bytes per chunk
constexpr int GMMA_STRIDE = 36;     // words between tile rows
constexpr int GMMA_THREADS = 256;
constexpr int GMMA_TILE_WORDS = GMMA_TILE * GMMA_STRIDE;

// The four 2-bit codes of a bed byte, one per byte of the result.
__device__ __forceinline__ uint32_t gmma_spread(uint32_t x) {
  return (x | (x << 6) | (x << 12) | (x << 18)) & 0x03030303u;
}

// Packed decode of four codes (decode.cuh: 00 -> a=2,b=1; 01 -> 0,0;
// 10 -> 1,1; 11 -> 0,1).  plane_b selects b, else a.
__device__ __forceinline__ uint32_t gmma_decode4(uint32_t byte, bool plane_b) {
  const uint32_t t = gmma_spread(byte);
  const uint32_t lo = t & 0x01010101u;
  const uint32_t hi = (t >> 1) & 0x01010101u;
  const uint32_t nlo = lo ^ 0x01010101u;
  const uint32_t nhi = hi ^ 0x01010101u;
  const uint32_t b = 0x01010101u ^ (lo & nhi);
  const uint32_t a = ((nlo & nhi) << 1) | (nlo & hi);
  return plane_b ? b : a;
}

// keep has both bits of code k set when individual k of the byte counts;
// the others become the missing code 01.
__device__ __forceinline__ uint32_t gmma_mask_byte(uint32_t byte,
                                                   uint32_t keep) {
  return (byte & keep) | (0x55u & ~keep);
}

// The keep byte of bed column j from the 0/1 float mask na (4, mb).
__device__ __forceinline__ uint32_t gmma_keep_of(const float* __restrict__ na,
                                                 int mb, int j) {
  uint32_t keep = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (na[(size_t)k * mb + j] != 0.0f) keep |= 3u << (2 * k);
  return keep;
}

__device__ __forceinline__ void gmma_mma_s8(int (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bed bytes of one marker row, bytes j .. j+15 (0x55, which decodes to
// 0, beyond mb or for a pad row).  vec: row pointers and mb are multiples
// of 16 bytes.
__device__ __forceinline__ uint4 gmma_load16(const uint8_t* __restrict__ row,
                                             int j, int mb, bool vec) {
  uint4 v = make_uint4(0x55555555u, 0x55555555u, 0x55555555u, 0x55555555u);
  if (row == nullptr || j >= mb) return v;
  if (vec) return *reinterpret_cast<const uint4*>(row + j);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const uint32_t byte = (j + q < mb) ? row[j + q] : 0x55u;
    w[q / 4] |= byte << (8 * (q % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Decode 16 masked bytes into 16 words of tile row `dst` (16-byte aligned).
__device__ __forceinline__ void gmma_store16(uint32_t* dst, uint4 bytes,
                                             uint4 keeps, bool plane_b) {
  const uint32_t bw[4] = {bytes.x, bytes.y, bytes.z, bytes.w};
  const uint32_t kw[4] = {keeps.x, keeps.y, keeps.z, keeps.w};
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t byte = (bw[v] >> (8 * q)) & 0xffu;
      const uint32_t keep = (kw[v] >> (8 * q)) & 0xffu;
      o[q] = gmma_decode4(gmma_mask_byte(byte, keep), plane_b);
    }
    *reinterpret_cast<uint4*>(dst + 4 * v) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The mma's of one staged chunk: acc[mt][nt][.] += rows x cols over the
// chunk's 128 individuals.  rs / cs: the row-side and column-side tiles
// (the same pointer on a diagonal tile).
__device__ __forceinline__ void gmma_chunk(const uint32_t* __restrict__ rs,
                                           const uint32_t* __restrict__ cs,
                                           int (&acc)[2][8][4], int warp_m,
                                           int warp_n, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < GMMA_NBY / 8; ++ks) {
    const int w0 = ks * 8 + tig;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint32_t* p = rs + (warp_m * 32 + mt * 16 + g) * GMMA_STRIDE + w0;
      a[mt][0] = p[0];
      a[mt][1] = p[8 * GMMA_STRIDE];
      a[mt][2] = p[4];
      a[mt][3] = p[8 * GMMA_STRIDE + 4];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t* p = cs + (warp_n * 64 + nt * 8 + g) * GMMA_STRIDE + w0;
      const uint32_t b0 = p[0], b1 = p[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        gmma_mma_s8(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0,
                    b1);
    }
  }
}

// One 128 x 128 Gram tile over all mb bed columns.
//   rrow / crow: this thread's staging row of the row-side / column-side
//     tile (thread -> tile row threadIdx.x / 2, bytes 16 * (threadIdx.x % 2)
//     of a chunk), nullptr for a pad row; row_b / col_b: the plane (b or a)
//     of each side; same: both sides are one tile (staged once);
//   na: the 0/1 float mask (4, mb); tiles: 2 * GMMA_TILE_WORDS words of
//     shared memory; keep: GMMA_KEEP_SEG bytes of shared memory.
// Every thread of the CTA calls it; acc must come in zeroed.
constexpr int GMMA_KEEP_SEG = 4096;  // bed columns whose keep bytes are staged at a time

__device__ __forceinline__ void gmma_gram_tile(
    const uint8_t* __restrict__ rrow, const uint8_t* __restrict__ crow,
    bool row_b, bool col_b, bool same, const float* __restrict__ na, int mb,
    bool vec, uint32_t* tiles, uint8_t* keep, int (&acc)[2][8][4]) {
  uint32_t* rs = tiles;
  uint32_t* cs = same ? tiles : tiles + GMMA_TILE_WORDS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 2, warp_n = warp % 2;
  const int srow = tid / 2, sby = (tid % 2) * 16;
  uint32_t* rdst = rs + srow * GMMA_STRIDE + sby;
  uint32_t* cdst = cs + srow * GMMA_STRIDE + sby;

  for (int seg0 = 0; seg0 < mb; seg0 += GMMA_KEEP_SEG) {
    const int seg1 = min(mb, seg0 + GMMA_KEEP_SEG);
    // Keep bytes of this segment; columns past mb keep nothing.
    __syncthreads();
    for (int x = tid; x < GMMA_KEEP_SEG; x += GMMA_THREADS)
      keep[x] = (seg0 + x < seg1) ? (uint8_t)gmma_keep_of(na, mb, seg0 + x)
                                  : (uint8_t)0;
    uint4 rb = gmma_load16(rrow, seg0 + sby, mb, vec);
    uint4 cb = same ? rb : gmma_load16(crow, seg0 + sby, mb, vec);
    __syncthreads();
    for (int j0 = seg0; j0 < seg1; j0 += GMMA_NBY) {
      // Stage the chunk whose bytes are in registers.
      const uint4 kp =
          *reinterpret_cast<const uint4*>(keep + (j0 - seg0) + sby);
      gmma_store16(rdst, rb, kp, row_b);
      if (!same) gmma_store16(cdst, cb, kp, col_b);
      __syncthreads();
      const int jn = j0 + GMMA_NBY;
      if (jn < seg1) {
        rb = gmma_load16(rrow, jn + sby, mb, vec);
        if (!same) cb = gmma_load16(crow, jn + sby, mb, vec);
      }
      gmma_chunk(rs, cs, acc, warp_m, warp_n, lane);
      __syncthreads();
    }
  }
}
