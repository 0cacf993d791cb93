// 2-bit PLINK genotype decode shared by every kernel of the sweep.
//
// Replaces _decode_tile (gmrm_tpu/ops/pallas_kernels.py:102).  The TPU
// version decodes a whole (B, tn) tile into bf16 planes for the MXU; here
// each thread decodes the bytes it reads into registers, so decoded planes
// never touch memory.
//
// Layout: individual 4j+k lives in bits 2k..2k+1 of byte j, and phase plane
// k holds it (gmrm_tpu/ops/decode.py).  Code map (reference
// mk_lut.cpp:25-36): 00 -> a=2,b=1; 01 (missing) -> a=0,b=0;
// 10 -> a=1,b=1; 11 -> a=0,b=1.  The pad byte 0x55 decodes to a=b=0.
#pragma once

#include <stdint.h>

__device__ __forceinline__ void gmrm_decode(uint32_t byte, int k, int &a,
                                            int &b) {
  const int c = (byte >> (2 * k)) & 3;
  b = (c != 1);
  a = ((4 - c) >> 1) * b;
}

// The same map on the sixteen codes of a 32-bit word (four bytes) at once,
// for kernels that only need the dosage: a2 has bit 2j set where code j is
// 00 (a = 2) and a1 where it is 10 (a = 1), each only where ``keep`` has
// bit 2j set (keep is a subset of 0x55555555).  Codes 01 and 11 give a = 0.
__device__ __forceinline__ void gmrm_decode_word(uint32_t w, uint32_t keep,
                                                 uint32_t &a2, uint32_t &a1) {
  const uint32_t lo = w & 0x55555555u, hi = (w >> 1) & 0x55555555u;
  a2 = ~(lo | hi) & keep;
  a1 = hi & ~lo & keep;
}
