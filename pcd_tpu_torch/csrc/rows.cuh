// Row loads and stores of the quotient kernels (K5-K7): one 10 x u32
// element of a (rows, 10) array as five 8-byte accesses (rows are 40
// bytes, so 8-byte aligned when the array is).
#pragma once

#include "field.cuh"

PCD_FN void ld_row(uint32_t r[NL], const uint32_t* __restrict__ src,
                   long i) {
  const uint2* p = reinterpret_cast<const uint2*>(src + i * NL);
#pragma unroll
  for (int q = 0; q < NL / 2; ++q) {
    const uint2 u = p[q];
    r[2 * q] = u.x;
    r[2 * q + 1] = u.y;
  }
}

PCD_FN void st_row(uint32_t* __restrict__ dst, long i, const uint32_t r[NL]) {
  uint2* p = reinterpret_cast<uint2*>(dst + i * NL);
#pragma unroll
  for (int q = 0; q < NL / 2; ++q) p[q] = make_uint2(r[2 * q], r[2 * q + 1]);
}
