// Field core of the port's EC kernels: Montgomery arithmetic over 10 x u32
// limbs (R = 2^320), fully reduced to [0, p), for a prime p below 2^300
// and its binomial extensions Fp^D = Fp[u]/(u^D - nr), D = 2, 3.
//
// Replaces the TPU field layer the Pallas kernels inline: the transposed
// helpers of Fp32Ctx (pcd_tpu/ops/fp32.py:228-393: 8-bit limbs in f32,
// bf16 Toeplitz reductions on the MXU) and _ExtOpsT
// (pcd_tpu/ops/ec32.py:747-826).  A GPU multiplies 32 x 32 -> 64 bits in
// its integer units, so a prime-field product is one CIOS pass (210
// partial products).  An extension product forms its cross products by
// Karatsuba at the wide (640-bit) level, scales the wrapped ones by nr,
// and reduces once per component, as _ExtOpsT.mul does.  Every
// result is fully reduced, so the plain torch versions
// (pcd_tpu_torch/ops/field.py) agree limb for limb.
//
// The modulus, the Montgomery constants and the curve constants arrive
// as one FieldConsts kernel parameter (pcd_tpu_torch/ops/ec.py packs it).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NL 10

typedef unsigned long long u64;

struct FieldConsts {
  uint32_t p[NL];
  uint32_t n0;          // -p^-1 mod 2^32
  uint32_t nr;          // u^D = nr (D > 1)
  uint32_t one[NL];     // R mod p
  uint32_t a[3][NL];    // curve a, 3b, a^2 per component, Montgomery form
  uint32_t b3[3][NL];
  uint32_t a2[3][NL];
};

template <int D>
struct Fe {
  uint32_t c[D][NL];
};

// r = a - p if a >= p else a   (a < 2p)
__device__ __forceinline__ void fp_reduce_once(uint32_t r[NL],
                                               const uint32_t a[NL],
                                               const uint32_t p[NL]) {
  uint32_t t[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u64 d = (u64)a[i] - p[i] - borrow;
    t[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = borrow ? a[i] : t[i];
}

__device__ __forceinline__ void fp_add(uint32_t r[NL], const uint32_t a[NL],
                                       const uint32_t b[NL],
                                       const uint32_t p[NL]) {
  uint32_t s[NL];
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u64 t = (u64)a[i] + b[i] + c;
    s[i] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
  fp_reduce_once(r, s, p);
}

__device__ __forceinline__ void fp_sub(uint32_t r[NL], const uint32_t a[NL],
                                       const uint32_t b[NL],
                                       const uint32_t p[NL]) {
  uint32_t s[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u64 d = (u64)a[i] - b[i] - borrow;
    s[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  // a < b: add p back (mod 2^320)
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u64 t = (u64)s[i] + (borrow ? p[i] : 0u) + c;
    r[i] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
}

// CIOS Montgomery product a*b/R mod p
__device__ __forceinline__ void fp_mul(uint32_t r[NL], const uint32_t a[NL],
                                       const uint32_t b[NL],
                                       const FieldConsts& k) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int i = 0; i < NL + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      u64 s = (u64)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    u64 s = (u64)t[NL] + c;
    t[NL] = (uint32_t)s;
    t[NL + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * k.n0;
    s = (u64)m * k.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      s = (u64)m * k.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (u64)t[NL] + c;
    t[NL - 1] = (uint32_t)s;
    t[NL] = t[NL + 1] + (uint32_t)(s >> 32);
  }
  fp_reduce_once(r, t, k.p);  // t < 2p < 2^320, so t[NL] == 0
}

// acc (2NL+1 words) += x * y
__device__ __forceinline__ void wide_mac(uint32_t acc[2 * NL + 1],
                                         const uint32_t x[NL],
                                         const uint32_t y[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      u64 s = (u64)x[j] * y[i] + acc[i + j] + c;
      acc[i + j] = (uint32_t)s;
      c = s >> 32;
    }
#pragma unroll
    for (int j = i + NL; j < 2 * NL + 1; ++j) {
      u64 s = (u64)acc[j] + c;
      acc[j] = (uint32_t)s;
      c = s >> 32;
    }
  }
}

// r = acc / R mod p for acc < p * R (word-by-word reduction)
__device__ __forceinline__ void wide_redc(uint32_t r[NL],
                                          uint32_t acc[2 * NL + 1],
                                          const FieldConsts& k) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint32_t m = acc[i] * k.n0;
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      u64 s = (u64)m * k.p[j] + acc[i + j] + c;
      acc[i + j] = (uint32_t)s;
      c = s >> 32;
    }
#pragma unroll
    for (int j = i + NL; j < 2 * NL + 1; ++j) {
      u64 s = (u64)acc[j] + c;
      acc[j] = (uint32_t)s;
      c = s >> 32;
    }
  }
  fp_reduce_once(r, acc + NL, k.p);  // < 2p: acc[2NL] == 0
}

template <int D>
__device__ __forceinline__ void fe_add(Fe<D>& r, const Fe<D>& a,
                                       const Fe<D>& b, const FieldConsts& k) {
#pragma unroll
  for (int i = 0; i < D; ++i) fp_add(r.c[i], a.c[i], b.c[i], k.p);
}

template <int D>
__device__ __forceinline__ void fe_sub(Fe<D>& r, const Fe<D>& a,
                                       const Fe<D>& b, const FieldConsts& k) {
#pragma unroll
  for (int i = 0; i < D; ++i) fp_sub(r.c[i], a.c[i], b.c[i], k.p);
}

template <int D>
__device__ __forceinline__ void fe_neg(Fe<D>& r, const Fe<D>& a,
                                       const FieldConsts& k) {
  const uint32_t zero[NL] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < D; ++i) fp_sub(r.c[i], zero, a.c[i], k.p);
}

// w (2NL+1 words) = x * y
__device__ __forceinline__ void wide_mul(uint32_t w[2 * NL + 1],
                                         const uint32_t x[NL],
                                         const uint32_t y[NL]) {
#pragma unroll
  for (int i = 0; i < 2 * NL + 1; ++i) w[i] = 0;
  wide_mac(w, x, y);
}

// w = x * y for x = a_i + a_j, y = b_i + b_j (unreduced sums < 2p < 2^301)
__device__ __forceinline__ void wide_mul_sums(uint32_t w[2 * NL + 1],
                                              const uint32_t ai[NL],
                                              const uint32_t aj[NL],
                                              const uint32_t bi[NL],
                                              const uint32_t bj[NL]) {
  uint32_t x[NL], y[NL];
  uint32_t cx = 0, cy = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    u64 s = (u64)ai[l] + aj[l] + cx;
    x[l] = (uint32_t)s;
    cx = (uint32_t)(s >> 32);
    s = (u64)bi[l] + bj[l] + cy;
    y[l] = (uint32_t)s;
    cy = (uint32_t)(s >> 32);
  }
  wide_mul(w, x, y);
}

// w -= x (2NL+1 words; the caller keeps w >= x)
__device__ __forceinline__ void wide_sub(uint32_t w[2 * NL + 1],
                                         const uint32_t x[2 * NL + 1]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 2 * NL + 1; ++i) {
    u64 d = (u64)w[i] - x[i] - borrow;
    w[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
}

// w += x (2NL+1 words; the sum stays below 2^(32 (2NL+1)))
__device__ __forceinline__ void wide_add(uint32_t w[2 * NL + 1],
                                         const uint32_t x[2 * NL + 1]) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 2 * NL + 1; ++i) {
    u64 t = (u64)w[i] + x[i] + c;
    w[i] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
}

// w += s * x (2NL+1 words, s < 2^32; x < 2^640 in its first 2NL words)
__device__ __forceinline__ void wide_add_scaled(uint32_t w[2 * NL + 1],
                                                const uint32_t x[2 * NL + 1],
                                                uint32_t s) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) {
    u64 t = (u64)x[i] * s + w[i] + c;
    w[i] = (uint32_t)t;
    c = t >> 32;
  }
  w[2 * NL] += (uint32_t)c;
}

// Fp^D product with Karatsuba cross products, as _ExtOpsT.mul:
// v_i = a_i b_i, and a_i b_j + a_j b_i = (a_i + a_j)(b_i + b_j) - v_i - v_j
// (never negative, so the wide words stay unsigned).  Each component
// c_m = sum_{i+j = m mod D} a_i b_j (wrapped terms * nr) is below
// (1 + 2 nr) p^2 < p R and is reduced once: D = 2 takes 3 wide products,
// D = 3 takes 6.  Out of line: inlining the D = 3 body at the 17-18 call
// sites of one EC add would multiply code size and build time.
template <int D>
__device__ __noinline__ void ext_mul(Fe<D>& r, const Fe<D>& a, const Fe<D>& b,
                                     const FieldConsts& k) {
  uint32_t v[D][2 * NL + 1];
  uint32_t acc[2 * NL + 1];
#pragma unroll
  for (int i = 0; i < D; ++i) wide_mul(v[i], a.c[i], b.c[i]);
  Fe<D> out;
  if constexpr (D == 2) {
    // c0 = v0 + nr v1;  c1 = (a0 + a1)(b0 + b1) - v0 - v1
    wide_mul_sums(acc, a.c[0], a.c[1], b.c[0], b.c[1]);
    wide_sub(acc, v[0]);
    wide_sub(acc, v[1]);
    wide_redc(out.c[1], acc, k);
    wide_add_scaled(v[0], v[1], k.nr);
    wide_redc(out.c[0], v[0], k);
  } else {
    // c0 = v0 + nr (a1 b2 + a2 b1);  c1 = a0 b1 + a1 b0 + nr v2;
    // c2 = a0 b2 + a2 b0 + v1
    uint32_t x[2 * NL + 1];
    wide_mul_sums(x, a.c[1], a.c[2], b.c[1], b.c[2]);
    wide_sub(x, v[1]);
    wide_sub(x, v[2]);
#pragma unroll
    for (int i = 0; i < 2 * NL + 1; ++i) acc[i] = v[0][i];
    wide_add_scaled(acc, x, k.nr);
    wide_redc(out.c[0], acc, k);
    wide_mul_sums(acc, a.c[0], a.c[1], b.c[0], b.c[1]);
    wide_sub(acc, v[0]);
    wide_sub(acc, v[1]);
    wide_add_scaled(acc, v[2], k.nr);
    wide_redc(out.c[1], acc, k);
    wide_mul_sums(acc, a.c[0], a.c[2], b.c[0], b.c[2]);
    wide_sub(acc, v[0]);
    wide_sub(acc, v[2]);
    wide_add(acc, v[1]);
    wide_redc(out.c[2], acc, k);
  }
  r = out;
}

template <int D>
__device__ __forceinline__ void fe_mul(Fe<D>& r, const Fe<D>& a,
                                       const Fe<D>& b, const FieldConsts& k) {
  if constexpr (D == 1) {
    fp_mul(r.c[0], a.c[0], b.c[0], k);
  } else {
    ext_mul<D>(r, a, b, k);
  }
}

template <int D>
__device__ __forceinline__ void fe_load_const(Fe<D>& r,
                                              const uint32_t src[3][NL]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int l = 0; l < NL; ++l) r.c[i][l] = src[i][l];
}
