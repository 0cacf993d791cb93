// Scaled Grams of a run of blocks of the exact-serial (W=1) sweep, whose
// uniform shuffle changes block membership every iteration, so the Gram
// cannot be cached.  For block n of the run, with ab = [A; B] of its
// marker rows rows[n, 0..B-1] (2B x 4mb) and mask nt (0 when NT = 1, else
// the trait t):
//   g1[j, i]  = sum_n na a_j a_i,  g2t[j, i] = sum_n na a_j b_i,
//   g3[j, i]  = sum_n na b_j b_i,  g2[j, i]  = g2t[i, j],
//   gs[n, t, j, i] = (msig_j msig_i) * (g1 - m_i g2t - m_j g2 + (m_j m_i) g3)
//
// Replaces the Gram half of _gram_kernel (gmrm_tpu/ops/pallas_kernels.py:135,
// built by _build_gram_call :205, wrapper block_gram_scaled_pallas :238);
// the residual dot products c of that kernel are the c-dot kernel
// (block_cdot.cu).  The Gram does not depend on the residual, so the sweep
// builds the Grams of all its blocks (or of a run of them, under a byte
// budget) before the serial block loop: one launch of the raw kernel and
// one of the scaling pass per run.
//
// Bound on the H100: integer multiply-adds, 3 B^2 * 4mb per block and mask
// (only the three quadrants the scaling reads; g2 is g2t transposed).
// Design: the raw quadrants come from the int8 tensor cores
// (mma.sync.m16n8k32.s8, the tile of gram_mma.cuh), one CTA per 128 x 128
// tile of a quadrant, block and mask, each over all individuals: with a
// run of blocks the grid fills the card without splitting the reduction,
// so there are no atomics and no memset, and the int32 sums stay in
// registers until the tile is written once.  Per-trait masks (NT = T) are
// taken as further grid entries (the whole product again per mask, on the
// tensor cores); subtracting a Gram over the few missing individuals from
// one unmasked Gram would need a data-dependent compaction first.
// Every raw entry is an exact count below 2^24, and the scaling pass uses
// the _rn intrinsics in the plain expression's order (sweep_math.cuh), so
// gs is bit-equal to the plain PyTorch version on the card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_mma.cuh"
#include "sweep_math.cuh"

namespace {

// raw: (nb, nt, 3, B, B) int32, quadrants g1, g2t, g3.
__global__ void __launch_bounds__(GMMA_THREADS, 2)
blocks_gram_raw_kernel(const uint8_t* __restrict__ bed,
                       const int* __restrict__ rows_all,
                       const float* __restrict__ na, int* __restrict__ raw,
                       int B, int mb, int vec) {
  __shared__ __align__(16) uint32_t tiles[2 * GMMA_TILE_WORDS];
  __shared__ __align__(16) uint8_t keep[GMMA_KEEP_SEG];
  const int ntile = (B + GMMA_TILE - 1) / GMMA_TILE;
  const int q = blockIdx.x / (ntile * ntile);        // quadrant
  const int r0 = (blockIdx.x / ntile % ntile) * GMMA_TILE;
  const int c0 = (blockIdx.x % ntile) * GMMA_TILE;
  const int m = blockIdx.y, nt = gridDim.y, n = blockIdx.z;
  const int* rows = rows_all + (size_t)n * B;
  const bool row_b = q == 2, col_b = q >= 1;
  const bool same = q != 1 && r0 == c0;

  const int sr = threadIdx.x / 2;                    // staging tile row
  const uint8_t* rrow =
      r0 + sr < B ? bed + (size_t)rows[r0 + sr] * mb : nullptr;
  const uint8_t* crow =
      c0 + sr < B ? bed + (size_t)rows[c0 + sr] * mb : nullptr;

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  gmma_gram_tile(rrow, crow, row_b, col_b, same, na + (size_t)m * 4 * mb, mb,
                 vec != 0, tiles, keep, acc);

  int* o = raw + (((size_t)n * nt + m) * 3 + q) * B * B;
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
        if (r < B) {
          if (c < B) o[(size_t)r * B + c] = acc[mt][nn][2 * h];
          if (c + 1 < B) o[(size_t)r * B + c + 1] = acc[mt][nn][2 * h + 1];
        }
      }
    }
  }
}

// gs[n, t, j, i] from the raw quadrants; one CTA per 32 x 32 tile (j, i),
// the transposed g2t tile through shared memory.
__global__ void __launch_bounds__(256)
blocks_gram_scale_kernel(const int* __restrict__ raw,
                         const float* __restrict__ mave,
                         const float* __restrict__ msig,
                         float* __restrict__ gs, int T, int B, int nt) {
  __shared__ int tr[32][33];
  const int nti = (B + 31) / 32;
  const int j0 = (blockIdx.x / nti) * 32, i0 = (blockIdx.x % nti) * 32;
  const int t = blockIdx.y, n = blockIdx.z;
  const int* g = raw + ((size_t)n * nt + (nt == 1 ? 0 : t)) * 3 * B * B;
  const int* g1 = g;
  const int* g2t = g + (size_t)B * B;
  const int* g3 = g + (size_t)2 * B * B;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  // tr[a][b] = g2t[i0 + a, j0 + b]
  for (int a = ty; a < 32; a += 8)
    tr[a][tx] = (i0 + a < B && j0 + tx < B)
                    ? g2t[(size_t)(i0 + a) * B + j0 + tx] : 0;
  __syncthreads();
  const float* mv = mave + ((size_t)n * T + t) * B;
  const float* ms = msig + ((size_t)n * T + t) * B;
  float* out = gs + ((size_t)n * T + t) * B * B;
  const int i = i0 + tx;
  if (i >= B) return;
  const float mr = mv[i], sr = ms[i];
  for (int a = ty; a < 32; a += 8) {
    const int j = j0 + a;
    if (j >= B) break;
    const size_t x = (size_t)j * B + i;
    out[x] = gmrm_scale_gram((float)g1[x], (float)tr[tx][a], (float)g2t[x],
                             (float)g3[x], mr, mv[j], sr, ms[j]);
  }
}

}  // namespace

// bed (m_pad, mb) uint8; rows (nb, B) int32; na (nt, 4, mb) float32 0/1;
// mave/msig (nb, T, B) float32; raw (nb, nt, 3, B, B) int32 scratch;
// gs (nb, T, B, B) float32.
extern "C" int gmrm_block_gram(const void* bed, const void* rows,
                               const void* na, const void* mave,
                               const void* msig, void* raw, void* gs, int nb,
                               int T, int B, int mb, int nt, void* stream) {
  if (nb < 1 || nb > 65535 || nt < 1 || nt > 65535 || T < 1 || T > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntile = (B + GMMA_TILE - 1) / GMMA_TILE;
  const int vec = (mb % 16 == 0) && ((uintptr_t)bed % 16 == 0);
  blocks_gram_raw_kernel<<<dim3(3 * ntile * ntile, nt, nb), GMMA_THREADS, 0,
                           s>>>((const uint8_t*)bed, (const int*)rows,
                                (const float*)na, (int*)raw, B, mb, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nti = (B + 31) / 32;
  blocks_gram_scale_kernel<<<dim3(nti * nti, T, nb), 256, 0, s>>>(
      (const int*)raw, (const float*)mave, (const float*)msig, (float*)gs, T,
      B, nt);
  return (int)cudaGetLastError();
}
