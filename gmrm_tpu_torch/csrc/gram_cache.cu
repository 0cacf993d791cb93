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
// Bound on the H100: integer multiply-adds, 2B * 2B * 4N per block and
// mask (about 1e11 at the anchor, N=10k, Mt=20k, B=128, NT=1); the bed
// bytes (B * mb per block) are small beside that.  Design: one CTA per
// 64x64 output tile, block and mask; each stage decodes 16 packed bytes of
// the tile's 64 row markers and 64 column markers (64 individuals) into
// shared memory, and each of 256 threads accumulates a 4x4 register tile
// in int32.  Every entry is an exact count below 2^24, so the float32
// store is bit-equal to the TPU builder whatever the summation order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int TILE = 64;        // output tile edge
constexpr int NBY = 16;         // packed bytes per stage
constexpr int KC = 4 * NBY;     // individuals per stage
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
gram_cache_kernel(const uint8_t* __restrict__ bed,
                  const float* __restrict__ na, float* __restrict__ out,
                  int B, int mb) {
  __shared__ int rs[KC][TILE];   // row side, masked by na
  __shared__ int cs[KC][TILE];   // column side
  const int B2 = 2 * B;
  const int ntile = (B2 + TILE - 1) / TILE;
  const int r0 = (blockIdx.x / ntile) * TILE;
  const int c0 = (blockIdx.x % ntile) * TILE;
  const int blk = blockIdx.y;
  const int nt = blockIdx.z;
  const uint8_t* bed_blk = bed + (size_t)blk * B * mb;
  const float* na_nt = na + (size_t)nt * 4 * mb;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  // Staging role: thread -> tile row/column sr, bytes sj0 .. sj0+3.
  const int sr = threadIdx.x / 4;
  const int sj0 = (threadIdx.x % 4) * 4;
  const int R = r0 + sr;
  const int C = c0 + sr;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int j0 = 0; j0 < mb; j0 += NBY) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jb = sj0 + q;
      const int j = j0 + jb;
      uint32_t rb = 0x55u, cb = 0x55u;   // all missing: decodes to 0
      if (j < mb) {
        if (R < B2) rb = bed_blk[(size_t)(R % B) * mb + j];
        if (C < B2) cb = bed_blk[(size_t)(C % B) * mb + j];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int nav = (j < mb) ? (na_nt[(size_t)k * mb + j] != 0.0f) : 0;
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

  float* o = out + ((size_t)blk * gridDim.z + nt) * B2 * B2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < B2 && c < B2) o[(size_t)r * B2 + c] = (float)acc[i][j];
    }
  }
}

}  // namespace

extern "C" int gmrm_gram_cache(const void* bed, const void* na, void* out,
                               int nblocks, int B, int mb, int nt,
                               void* stream) {
  const int ntile = (2 * B + TILE - 1) / TILE;
  dim3 grid(ntile * ntile, nblocks, nt);
  gram_cache_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bed, (const float*)na, (float*)out, B, mb);
  return (int)cudaGetLastError();
}

extern "C" const char* gmrm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
