// One-time raw Gram cache: for every natural block of B markers and every
// NA mask nt,
//   out[blk, nt, r, c] = sum_i na_nt[i] * ab[r, i] * ab[c, i],
// where ab = [A; B] stacks the block's dosage planes (rows 0..B-1) over its
// present planes (rows B..2B-1), i runs over the 4*mb phase-plane
// individuals.
//
// Replaces _gram_cache_kernel (gmrm_tpu/ops/sweep_kernel.py:1158, built by
// _build_gram_cache_call :1205 and driven by build_gram_cache :1259).
//
// Bound on the H100: integer multiply-adds, 3 B^2 * 4mb per block and mask
// (the (b, a) quadrant is the transpose of (a, b)); the bed bytes (B * mb
// per block) and the float32 cache (4 (2B)^2 per block and mask) are small
// beside that.  Design: the int8 tensor-core tile of gram_mma.cuh
// (mma.sync.m16n8k32.s8 on the packed decode, the mask applied to the
// packed byte), as the block Gram of the W=1 sweep (block_gram.cu) uses
// it.  One CTA per 128 x 128 tile of one of three quadrants, block and
// mask, each over all individuals: g1 = a.a, g2t = a.b, g3 = b.b.  A
// diagonal tile of g1 or g3 is staged once; the tiles below the diagonal
// of g1 and g3 (B > 128 only) are made like the others, not mirrored.  The
// (b, a) quadrant is written from g2t's accumulators, transposed, so no
// fourth product is made.  A block's rows are its own (blk*B + r), so no
// row table is read.  The int32 sums are stored as float32 straight into
// the (nblocks, NT, 2B, 2B) layout of the JAX builder: every entry is an
// exact count below 2^24, so the cache is bit-equal to it whatever the
// summation order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_mma.cuh"

namespace {

__global__ void __launch_bounds__(GMMA_THREADS, 2)
gram_cache_kernel(const uint8_t* __restrict__ bed,
                  const float* __restrict__ na, float* __restrict__ out,
                  int B, int mb, int vec) {
  __shared__ __align__(16) uint32_t tiles[2 * GMMA_TILE_WORDS];
  __shared__ __align__(16) uint8_t keep[GMMA_KEEP_SEG];
  const int ntile = (B + GMMA_TILE - 1) / GMMA_TILE;
  const int q = blockIdx.x / (ntile * ntile);        // 0 g1, 1 g2t, 2 g3
  const int r0 = (blockIdx.x / ntile % ntile) * GMMA_TILE;
  const int c0 = (blockIdx.x % ntile) * GMMA_TILE;
  const int m = blockIdx.y, nt = gridDim.y, blk = blockIdx.z;
  const bool row_b = q == 2, col_b = q >= 1;
  const bool same = q != 1 && r0 == c0;

  const uint8_t* bed_blk = bed + (size_t)blk * B * mb;
  const int sr = threadIdx.x / 2;                    // staging tile row
  const uint8_t* rrow = r0 + sr < B ? bed_blk + (size_t)(r0 + sr) * mb
                                    : nullptr;
  const uint8_t* crow = c0 + sr < B ? bed_blk + (size_t)(c0 + sr) * mb
                                    : nullptr;

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  gmma_gram_tile(rrow, crow, row_b, col_b, same, na + (size_t)m * 4 * mb, mb,
                 vec != 0, tiles, keep, acc);

  // Quadrant q's entry (r, c) is out[ro + r, co + c]; g2t's also lands
  // transposed at out[B + c, r].
  const int B2 = 2 * B;
  float* o = out + ((size_t)blk * nt + m) * B2 * B2;
  const int ro = q == 2 ? B : 0, co = q == 0 ? 0 : B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const int c = c0 + (warp % 2) * 64 + nn * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + (warp / 2) * 32 + mt * 16 + g + 8 * h;
        if (r >= B) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= B) continue;
          const float v = (float)acc[mt][nn][2 * h + e];
          o[(size_t)(ro + r) * B2 + co + c + e] = v;
          // Eight neighbouring r of four rows a warp: whole 32-byte sectors.
          if (q == 1) o[(size_t)(B + c + e) * B2 + r] = v;
        }
      }
    }
  }
}

}  // namespace

// bed (nblocks * B, mb) uint8 in natural order; na (nt, 4, mb) float32 0/1;
// out (nblocks, nt, 2B, 2B) float32, every entry written.
extern "C" int gmrm_gram_cache(const void* bed, const void* na, void* out,
                               int nblocks, int B, int mb, int nt,
                               void* stream) {
  if (nblocks < 1 || nblocks > 65535 || nt < 1 || nt > 65535 || B < 1 ||
      mb < 1)
    return (int)cudaErrorInvalidValue;
  const int ntile = (B + GMMA_TILE - 1) / GMMA_TILE;
  const int vec = (mb % 16 == 0) && ((uintptr_t)bed % 16 == 0);
  gram_cache_kernel<<<dim3(3 * ntile * ntile, nt, nblocks), GMMA_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)bed, (const float*)na, (float*)out, B, mb, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* gmrm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
