// Per-marker OLS sums of predict, on the uncentered dosage
// val = a * na (a in {0, 1, 2} from the 2-bit code, na the phenotype's 0/1
// mask):
//   xtx[r] = sum_i val_i^2,   xty[r] = sum_i val_i * y_i
// over the 4 * L phase-plane individuals of marker row r of one chunk.
//
// Replaces gmrm_tpu/predict.py:43 _predict_sums_scan, an XLA lax.scan over
// chunks of 512 markers (not a Pallas kernel), driven by
// _chunked_predict_sums (:74).
//
// Layout: the bed rows are L bytes apart, L a multiple of 16 (the caller
// pads each row to L with 0x55, which decodes to a = 0, so pad bytes add
// nothing), and the bed, na and y are 16-byte aligned; na and y are (4, L)
// float32 planes.  Every load is 16 bytes, and the order of every sum
// depends on L alone, not on the row's place in the chunk or on the
// chunk's address: a marker gets the same bits in any layout of the run.
//
// Bound on the H100: bytes.  The bed is read once (M * L bytes over 3.35
// TB/s); y (16 L bytes) and the mask words made from na (L bytes) stay in
// L1 and L2 across rows (__ldg).  The
// arithmetic is a few integer and float operations per individual, about
// as many as the SMs issue in the bed's read time, so it is kept small:
// 16 codes are decoded at once with bit operations (gmrm_decode_word) under
// a mask word of the observed individuals; xtx is two popcounts a word,
// summed as int32 (exact and independent of order; stored as float32,
// exact below 2^24); each individual's val becomes a float by the 2^23
// trick (one byte permute into 0x4B0000vv, one subtract) and is added by
// one FMA.
//
// Design: two launches on the stream.  keep_words_kernel packs na into one
// mask word per four byte columns (the low bit of each 2-bit field), so the
// main kernel reads 4 bytes of mask instead of 64 of na per word of codes.
// predict_sums_kernel: a CTA of 8 warps, three CTAs an SM (85 registers a
// thread at most); a warp carries G = 4 rows at once, so the mask and y it
// loads serve four rows.  A team of 1, 2, 4 or 8 warps takes a group of G
// rows (more warps on wide rows, so that each lane still reads at least
// four 16-byte vectors a row and narrow panels keep many rows in flight);
// its lanes stride over the row's vectors.  The sums are in a fixed order:
// each lane's partial over its vectors in order, a fixed __shfl_xor tree
// over the warp, then the team's warps in order through shared memory.  No
// atomics: two launches on the same inputs give the same bits.
//
// Float64 (kernel D, gmrm_predict_sums_f64, a --dtype float64 predict):
// the same two kernels, templated on the value type V of na, y and out
// (Sums<V> holds the loads, the conversion of a value and the
// multiply-add).  xtx stays the int32 popcount sum (exact); each val
// becomes a double by a conversion and xty is a double FMA a value, in the
// order of the float32 kernel.  It replaces
// _predict_sums_scan(dtype=float64) (gmrm_tpu/predict.py:43).  Bound: the
// bed once, as in float32 (xty's FMAs at the float64 rate take less time);
// y is twice as wide and stays in L1 and L2 as well.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int G = 4;                      // rows a warp carries at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t word_of(const uint4 &v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// What the value type V of na, y and the sums changes: the load of four
// consecutive columns of a plane, the conversion of a 2-bit value, the
// multiply-add, and how many CTAs an SM is asked to hold.
template <typename V> struct Sums;

template <> struct Sums<float> {
  static constexpr int CTAS_PER_SM = 3;   // 85 registers a thread at most
  struct Quad { float4 v; };
  static __device__ __forceinline__ Quad load(const float* p) {
    return {__ldg((const float4*)p)};
  }
  static __device__ __forceinline__ float at(const Quad &q, int b) {
    return b == 0 ? q.v.x : b == 1 ? q.v.y : b == 2 ? q.v.z : q.v.w;
  }
  // Byte b of vk into 0x4B0000vv = 2^23 + val, minus 2^23.
  static __device__ __forceinline__ float value(uint32_t vk, int b) {
    return __uint_as_float(__byte_perm(vk, 0x4B000000u, 0x7650 + b)) -
           8388608.f;
  }
  static __device__ __forceinline__ float madd(float a, float b, float c) {
    return fmaf(a, b, c);
  }
};

template <> struct Sums<double> {
  static constexpr int CTAS_PER_SM = 2;
  struct Quad { double2 lo, hi; };
  static __device__ __forceinline__ Quad load(const double* p) {
    return {__ldg((const double2*)p), __ldg((const double2*)(p + 2))};
  }
  static __device__ __forceinline__ double at(const Quad &q, int b) {
    return b == 0 ? q.lo.x : b == 1 ? q.lo.y : b == 2 ? q.hi.x : q.hi.y;
  }
  static __device__ __forceinline__ double value(uint32_t vk, int b) {
    return (double)((vk >> (8 * b)) & 0xffu);
  }
  static __device__ __forceinline__ double madd(double a, double b,
                                                double c) {
    return fma(a, b, c);
  }
};

// keep[j] holds columns 4j..4j+3: bit 8b + 2k is set where the plane-k
// individual of column 4j + b is observed.
template <typename V>
__global__ void keep_words_kernel(const V* __restrict__ na,
                                  uint32_t* __restrict__ keep, int L) {
  using S = Sums<V>;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L / 4) return;
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const typename S::Quad n = S::load(na + (size_t)k * L + 4 * j);
    w |= (uint32_t)(S::at(n, 0) != V(0)) << (2 * k) |
         (uint32_t)(S::at(n, 1) != V(0)) << (8 + 2 * k) |
         (uint32_t)(S::at(n, 2) != V(0)) << (16 + 2 * k) |
         (uint32_t)(S::at(n, 3) != V(0)) << (24 + 2 * k);
  }
  keep[j] = w;
}

template <typename V>
__global__ void __launch_bounds__(THREADS, Sums<V>::CTAS_PER_SM)
predict_sums_kernel(const uint8_t* __restrict__ bed,
                    const uint32_t* __restrict__ keep,
                    const V* __restrict__ y, V* __restrict__ out,
                    int M, int L, int team) {
  using S = Sums<V>;
  __shared__ V red_y[WARPS][G];
  __shared__ int red_x[WARPS][G];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = WARPS / team;
  const long long row0 =
      ((long long)blockIdx.x * groups + warp / team) * G;
  const int nv = L / 16;

  V acc[G];
  int cnt[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    acc[g] = V(0);
    cnt[g] = 0;
  }
  if (row0 < M) {
    const uint4* rows[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      rows[g] = row0 + g < M
                    ? (const uint4*)(bed + (size_t)(row0 + g) * L)
                    : nullptr;
    for (int v = (warp % team) * 32 + lane; v < nv; v += team * 32) {
      uint4 w[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        w[g] = rows[g] ? __ldcs(rows[g] + v)
                       : make_uint4(0x55555555u, 0x55555555u, 0x55555555u,
                                    0x55555555u);
      const uint4 kw = __ldg((const uint4*)keep + v);
      const int col = v * 16;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        typename S::Quad yk[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          yk[k] = S::load(y + (size_t)k * L + col + 4 * q);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          uint32_t a2, a1;
          gmrm_decode_word(word_of(w[g], q), word_of(kw, q), a2, a1);
          cnt[g] += 4 * __popc(a2) + __popc(a1);
          const uint32_t val = (a2 << 1) | a1;   // a * na per 2-bit field
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t vk = (val >> (2 * k)) & 0x03030303u;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[g] = S::madd(S::value(vk, b), S::at(yk[k], b), acc[g]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc[g] += __shfl_xor_sync(FULL, acc[g], o);
      cnt[g] += __shfl_xor_sync(FULL, cnt[g], o);
    }
    if (lane == 0) {
      red_y[warp][g] = acc[g];
      red_x[warp][g] = cnt[g];
    }
  }
  __syncthreads();
  if (threadIdx.x < groups * G) {
    const int grp = threadIdx.x / G, g = threadIdx.x % G;
    const long long row = ((long long)blockIdx.x * groups + grp) * G + g;
    if (row < M) {
      V s = red_y[grp * team][g];
      int c = red_x[grp * team][g];
      for (int t = 1; t < team; ++t) {
        s += red_y[grp * team + t][g];
        c += red_x[grp * team + t][g];
      }
      out[row] = (V)c;
      out[(size_t)M + row] = s;
    }
  }
}

}  // namespace

// The warps a group of G rows takes at row pitch L: the most (a power of
// two up to 8) that still gives each lane four 16-byte vectors of a row.
extern "C" int gmrm_predict_sums_team(int L) {
  const int nv = L / 16;
  int team = 1;
  while (team < WARPS && nv >= 2 * team * 32 * 4) team *= 2;
  return team;
}

template <typename V>
static int launch_sums(const void* bed, const void* na, const void* y,
                       void* keep, void* out, int M, int L, void* stream) {
  if (M < 1 || L < 16 || L % 16 || (uintptr_t)bed % 16 ||
      (uintptr_t)na % 16 || (uintptr_t)y % 16 || (uintptr_t)keep % 16)
    return (int)cudaErrorInvalidValue;
  const int team = gmrm_predict_sums_team(L);
  const int rows_per_cta = WARPS / team * G;
  const long long grid = ((long long)M + rows_per_cta - 1) / rows_per_cta;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  keep_words_kernel<V><<<(L / 4 + THREADS - 1) / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>((const V*)na,
                                                 (uint32_t*)keep, L);
  predict_sums_kernel<V><<<(unsigned)grid, THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)bed, (const uint32_t*)keep, (const V*)y, (V*)out, M,
      L, team);
  return (int)cudaGetLastError();
}

// bed (M, L) uint8, na and y (4, L) float32, keep (L/4) uint32 scratch,
// out (2, M) float32: row 0 xtx, row 1 xty.  L a multiple of 16, every
// pointer 16-byte aligned.
extern "C" int gmrm_predict_sums(const void* bed, const void* na,
                                 const void* y, void* keep, void* out, int M,
                                 int L, void* stream) {
  return launch_sums<float>(bed, na, y, keep, out, M, L, stream);
}

// Kernel D: as gmrm_predict_sums, with na and y (4, L) float64 and out
// (2, M) float64.
extern "C" int gmrm_predict_sums_f64(const void* bed, const void* na,
                                     const void* y, void* keep, void* out,
                                     int M, int L, void* stream) {
  return launch_sums<double>(bed, na, y, keep, out, M, L, stream);
}
