// Residual dot products and scaled Gram of one block of the exact-serial
// (W=1) sweep, whose uniform shuffle changes block membership every
// iteration, so the Gram cannot be cached:
//   raw[nt, r, c] = sum_i na_nt[i] * ab[r, i] * ab[c, i]   (ab = [A; B] of
//                   the block's marker rows rows[0..B-1], 2B x 4mb)
//   c[t, i]       = msig[t, i] * (A_i . eps_t - mave[t, i] * B_i . eps_t)
//   gs[t, j, i]   = (msig_j msig_i) * (g1 - m_i g2t - m_j g2 + (m_j m_i) g3)
// with the quadrants g1 = raw[j, i], g2 = raw[B+j, i], g2t = raw[j, B+i],
// g3 = raw[B+j, B+i] of mask nt (0 when NT = 1, else t).
//
// Replaces _gram_kernel (gmrm_tpu/ops/pallas_kernels.py:135, built by
// _build_gram_call :205, wrapper block_gram_scaled_pallas :238).  The TPU
// kernel splits eps into bf16 hi/lo for the MXU; here c is the full float32
// sum of the c-dot kernel (block_cdot.cu), launched from this entry point.
//
// Bound on the H100: integer multiply-adds, (2B)^2 * 4mb per block and
// mask (6.7e8 at B=128, mb=2560).  One block gives only (2B/64)^2 * NT
// output tiles (16 at B=128, NT=1), so the reduction over the 4mb
// individuals is split across CTAs as well: each CTA sums its byte range
// in int32 registers (the 64x64 tiling of gram_cache.cu) and adds its
// partial tile into an int32 scratch with atomicAdd.  Every raw entry is
// an exact count below 2^24, so the result is exact in any order.  The
// epilogue scales with _rn intrinsics in the plain expression's order
// (sweep_math.cuh), so gs is bit-equal to the plain PyTorch version on the
// card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"
#include "sweep_math.cuh"

extern "C" int gmrm_block_cdot(const void* bed, const void* rows,
                               const void* eps, const void* mave,
                               const void* msig, void* c, int T, int B,
                               int mb, void* stream);

namespace {

constexpr int TILE = 64;         // output tile edge
constexpr int NBY = 16;          // packed bytes per stage
constexpr int KC = 4 * NBY;      // individuals per stage
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int TARGET_CTAS = 264; // two per SM of the H100's 132

__global__ void __launch_bounds__(THREADS)
block_gram_raw_kernel(const uint8_t* __restrict__ bed,
                      const int* __restrict__ rows,
                      const float* __restrict__ na, int* __restrict__ raw,
                      int B, int mb, int chunk) {
  __shared__ int rs[KC][TILE];   // row side, masked by na
  __shared__ int cs[KC][TILE];   // column side
  const int B2 = 2 * B;
  const int ntile = (B2 + TILE - 1) / TILE;
  const int r0 = (blockIdx.x / ntile) * TILE;
  const int c0 = (blockIdx.x % ntile) * TILE;
  const int j_lo = blockIdx.y * chunk;
  const int j_hi = min(mb, j_lo + chunk);
  const int nt = blockIdx.z;
  const float* na_nt = na + (size_t)nt * 4 * mb;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  // Staging role: thread -> tile row/column sr, bytes sj0 .. sj0+3.
  const int sr = threadIdx.x / 4;
  const int sj0 = (threadIdx.x % 4) * 4;
  const int R = r0 + sr;
  const int C = c0 + sr;
  const uint8_t* rrow = R < B2 ? bed + (size_t)rows[R % B] * mb : nullptr;
  const uint8_t* crow = C < B2 ? bed + (size_t)rows[C % B] * mb : nullptr;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int j0 = j_lo; j0 < j_hi; j0 += NBY) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jb = sj0 + q;
      const int j = j0 + jb;
      const bool in = j < j_hi;
      const uint32_t rb = (in && rrow) ? rrow[j] : 0x55u;  // 0x55 decodes to 0
      const uint32_t cb = (in && crow) ? crow[j] : 0x55u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int nav = in ? (na_nt[(size_t)k * mb + j] != 0.0f) : 0;
        int a, b;
        gmrm_decode(rb, k, a, b);
        rs[jb * 4 + k][sr] = (R < B ? a : b) * nav;
        gmrm_decode(cb, k, a, b);
        cs[jb * 4 + k][sr] = (C < B ? a : b);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      int rv[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rv[i] = rs[kk][ty + 16 * i];
        cv[i] = cs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += rv[i] * cv[j];
    }
    __syncthreads();
  }

  int* o = raw + (size_t)nt * B2 * B2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < B2 && c < B2 && acc[i][j] != 0)
        atomicAdd(&o[(size_t)r * B2 + c], acc[i][j]);
    }
  }
}

__global__ void block_gram_scale_kernel(const int* __restrict__ raw,
                                        const float* __restrict__ mave,
                                        const float* __restrict__ msig,
                                        float* __restrict__ gs, int T, int B,
                                        int nt) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= T * B * B) return;
  const int t = x / (B * B);
  const int j = (x / B) % B;
  const int i = x % B;
  const int B2 = 2 * B;
  const int* g = raw + (size_t)(nt == 1 ? 0 : t) * B2 * B2;
  const float g1 = (float)g[(size_t)j * B2 + i];
  const float g2 = (float)g[(size_t)(B + j) * B2 + i];
  const float g2t = (float)g[(size_t)j * B2 + B + i];
  const float g3 = (float)g[(size_t)(B + j) * B2 + B + i];
  const float mr = mave[t * B + i], mc = mave[t * B + j];
  const float sr = msig[t * B + i], sc = msig[t * B + j];
  gs[x] = gmrm_scale_gram(g1, g2, g2t, g3, mr, mc, sr, sc);
}

}  // namespace

extern "C" int gmrm_block_gram(const void* bed, const void* rows,
                               const void* eps, const void* na,
                               const void* mave, const void* msig, void* raw,
                               void* c, void* gs, int T, int B, int mb,
                               int nt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int B2 = 2 * B;
  cudaError_t err =
      cudaMemsetAsync(raw, 0, (size_t)nt * B2 * B2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int ntile = (B2 + TILE - 1) / TILE;
  const int tiles = ntile * ntile * nt;
  const int nstage = (mb + NBY - 1) / NBY;
  const int want = max(1, (TARGET_CTAS + tiles - 1) / tiles);
  const int chunk = ((nstage + want - 1) / want) * NBY;   // bytes per CTA
  dim3 grid(ntile * ntile, (mb + chunk - 1) / chunk, nt);
  block_gram_raw_kernel<<<grid, THREADS, 0, s>>>(
      (const uint8_t*)bed, (const int*)rows, (const float*)na, (int*)raw, B,
      mb, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ec = gmrm_block_cdot(bed, rows, eps, mave, msig, c, T, B, mb,
                                 stream);
  if (ec != 0) return ec;
  const int n = T * B * B;
  block_gram_scale_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      (const int*)raw, (const float*)mave, (const float*)msig, (float*)gs, T,
      B, nt);
  return (int)cudaGetLastError();
}
