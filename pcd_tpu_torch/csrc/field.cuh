// Field core of the port's EC kernels: Montgomery arithmetic over 10 x u32
// limbs (R = 2^320), fully reduced to [0, p), for a prime p below 2^300
// and its binomial extensions Fp^D = Fp[u]/(u^D - nr), D = 2, 3.
//
// Replaces the TPU field layer the Pallas kernels inline: the transposed
// helpers of Fp32Ctx (pcd_tpu/ops/fp32.py:228-393: 8-bit limbs in f32,
// bf16 Toeplitz reductions on the MXU) and _ExtOpsT
// (pcd_tpu/ops/ec32.py:747-826).  A GPU multiplies 32 x 32 -> 64 bits in
// its integer units, so a prime-field product is one Montgomery pass (210
// partial products).  Every result is fully reduced, so the plain torch
// versions (pcd_tpu_torch/ops/field.py) agree limb for limb.
//
// Products run as PTX carry chains (csrc/ptx.cuh): mad.lo.cc / madc.hi.cc
// add the low and high words of x_j * y into an accumulator and carry in
// the flag.  The partial products of one row split by the parity of j:
// the even limbs' words tile one accumulator E (x_0 y at words 0-1, x_2 y
// at 2-3, ...), the odd limbs' another, O, one word up, so each row is
// two independent chains (instruction-level parallelism for one thread)
// and neither has to wait for the other's carries; ptxas fuses each
// lo/hi pair into one 64-bit multiply-add with carry.  The merged value is
// E + 2^32 O.  The Montgomery factor of word i needs only that word of
// the merged value and the carry into it, so the product and reduction
// rows interleave.  With p < 2^300 every chain ends in a word that no
// earlier row wrote or that holds at most a few carries, so no carry
// ripples further.
//
// An extension product sums each component's D products in one such pass
// and reduces it once, as _ExtOpsT.mul does at the wide level.
//
// The modulus, the Montgomery constants and the curve constants arrive
// as one FieldConsts kernel parameter (pcd_tpu_torch/ops/ec.py packs it).
#pragma once

#include <cstdint>

#include "ptx.cuh"

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
PCD_FN void fp_reduce_once(uint32_t r[NL], const uint32_t a[NL],
                           const uint32_t p[NL]) {
  uint32_t t[NL];
  t[0] = sub_cc(a[0], p[0]);
#pragma unroll
  for (int i = 1; i < NL; ++i) t[i] = subc_cc(a[i], p[i]);
  const uint32_t keep = subc(0, 0);  // all ones where a < p
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = (a[i] & keep) | (t[i] & ~keep);
}

PCD_FN void fp_add(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL],
                   const uint32_t p[NL]) {
  uint32_t s[NL];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < NL; ++i) s[i] = addc_cc(a[i], b[i]);
  fp_reduce_once(r, s, p);
}

PCD_FN void fp_sub(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL],
                   const uint32_t p[NL]) {
  uint32_t s[NL];
  s[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < NL; ++i) s[i] = subc_cc(a[i], b[i]);
  const uint32_t m = subc(0, 0);  // all ones where a < b: add p back
  r[0] = add_cc(s[0], p[0] & m);
#pragma unroll
  for (int i = 1; i < NL; ++i) r[i] = addc_cc(s[i], p[i] & m);
}

// acc[o .. o+NL-1] = the words of x[s] y, x[s+2] y, ..., x[s+NL-2] y (s = 0:
// the even limbs; s = 1: the odd ones), acc[o+NL] = 0.  Products of
// distinct limbs land in distinct words: no carries.
PCD_FN void mul_row(uint32_t* acc, int o, const uint32_t* x, int s,
                    uint32_t y) {
#pragma unroll
  for (int q = 0; q < NL / 2; ++q) {
    acc[o + 2 * q] = mul_lo(x[s + 2 * q], y);
    acc[o + 2 * q + 1] = mul_hi(x[s + 2 * q], y);
  }
  acc[o + NL] = 0;
}

// acc[o .. o+NL-1] += the same words in one carry chain; its carry lands
// in acc[o+NL], assigned where no row wrote that word yet (fresh), added
// where it holds a previous chain's carry.
PCD_FN void mac_row(uint32_t* acc, int o, const uint32_t* x, int s,
                    uint32_t y, bool fresh) {
  acc[o] = mad_lo_cc(x[s], y, acc[o]);
  acc[o + 1] = madc_hi_cc(x[s], y, acc[o + 1]);
#pragma unroll
  for (int q = 1; q < NL / 2; ++q) {
    acc[o + 2 * q] = madc_lo_cc(x[s + 2 * q], y, acc[o + 2 * q]);
    acc[o + 2 * q + 1] = madc_hi_cc(x[s + 2 * q], y, acc[o + 2 * q + 1]);
  }
  acc[o + NL] = fresh ? addc(0, 0) : addc(acc[o + NL], 0);
}

// Montgomery product (x_0 y_0 + ... + x_{K-1} y_{K-1}) / R mod p for a sum
// below (R / p - 1) p: product and reduction rows interleaved (FIOS), each
// row i adding x_j * y_j[i] for every j before its reduction row.  The
// merged value is sum_w (E[w] + O[w-1]) 2^(32 w), and c carries into word
// i once the words below it are zero.
template <int K>
PCD_FN void fp_mul_sum(uint32_t r[NL], const uint32_t x[K][NL],
                       const uint32_t y[K][NL], const FieldConsts& k) {
  uint32_t E[2 * NL], O[2 * NL];
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (i == 0 && j == 0) {
        mul_row(E, 0, x[0], 0, y[0][0]);
        mul_row(O, 0, x[0], 1, y[0][0]);
      } else {
        mac_row(E, i, x[j], 0, y[j][i], j == 0);
        mac_row(O, i, x[j], 1, y[j][i], j == 0);
      }
    }
    const uint32_t below = (i ? O[i - 1] : 0u) + c;
    const uint32_t m = (E[i] + below) * k.n0;
    mac_row(E, i, k.p, 0, m, false);
    mac_row(O, i, k.p, 1, m, false);
    c = (uint32_t)(((u64)E[i] + (i ? O[i - 1] : 0u) + c) >> 32);
  }
  // (sum + m p) / R < 2p: words NL .. 2NL-1 of the merged value, plus c
  uint32_t s[NL];
  s[0] = add_cc(E[NL], O[NL - 1]);
#pragma unroll
  for (int q = 1; q < NL; ++q) s[q] = addc_cc(E[NL + q], O[NL + q - 1]);
  s[0] = add_cc(s[0], c);
#pragma unroll
  for (int q = 1; q < NL; ++q) s[q] = addc_cc(s[q], 0);
  fp_reduce_once(r, s, k.p);
}

// Montgomery product a*b/R mod p
PCD_FN void fp_mul(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL],
                   const FieldConsts& k) {
  fp_mul_sum<1>(r, reinterpret_cast<const uint32_t(*)[NL]>(a),
                reinterpret_cast<const uint32_t(*)[NL]>(b), k);
}

// r = s a for s < 2^16 (a < p < 2^300, so s a < 2^316 fits)
PCD_FN void fp_scale_small(uint32_t r[NL], const uint32_t a[NL], uint32_t s) {
#pragma unroll
  for (int l = 0; l < NL; ++l) r[l] = mul_lo(a[l], s);
  r[1] = mad_hi_cc(a[0], s, r[1]);
#pragma unroll
  for (int l = 1; l < NL - 1; ++l) r[l + 1] = madc_hi_cc(a[l], s, r[l + 1]);
}

template <int D>
PCD_FN void fe_add(Fe<D>& r, const Fe<D>& a, const Fe<D>& b,
                   const FieldConsts& k) {
#pragma unroll
  for (int i = 0; i < D; ++i) fp_add(r.c[i], a.c[i], b.c[i], k.p);
}

template <int D>
PCD_FN void fe_sub(Fe<D>& r, const Fe<D>& a, const Fe<D>& b,
                   const FieldConsts& k) {
#pragma unroll
  for (int i = 0; i < D; ++i) fp_sub(r.c[i], a.c[i], b.c[i], k.p);
}

template <int D>
PCD_FN void fe_neg(Fe<D>& r, const Fe<D>& a, const FieldConsts& k) {
  const uint32_t zero[NL] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < D; ++i) fp_sub(r.c[i], zero, a.c[i], k.p);
}

// Fp^D product by schoolbook with one reduction per component, as
// _ExtOpsT.mul sums at the wide level: c_m = sum_{i+j = m mod D} a_i b_j,
// a wrapped term (i + j >= D) with a_i scaled by nr first.  Each component
// is one fp_mul_sum of D products, below (1 + 2 nr) p^2 < (R/p - 1) p^2.
// The components are written as they finish, so r must not alias a or b
// (no caller does).  Out of line: inlining the D = 3 body at the 17-18
// call sites of one EC add would multiply code size and build time; its
// operands live in the caller's local memory.
template <int D>
PCD_NOINLINE void ext_mul(Fe<D>& r, const Fe<D>& a, const Fe<D>& b,
                          const FieldConsts& k) {
  uint32_t s[D][NL];                  // s[i] = nr a_i (i >= 1)
#pragma unroll
  for (int i = 1; i < D; ++i) fp_scale_small(s[i], a.c[i], k.nr);
#pragma unroll
  for (int m = 0; m < D; ++m) {
    uint32_t x[D][NL], y[D][NL];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int j = (m - i + D) % D;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        x[i][l] = i + j >= D ? s[i][l] : a.c[i][l];
        y[i][l] = b.c[j][l];
      }
    }
    fp_mul_sum<D>(r.c[m], x, y, k);
  }
}

template <int D>
PCD_FN void fe_mul(Fe<D>& r, const Fe<D>& a, const Fe<D>& b,
                   const FieldConsts& k) {
  if constexpr (D == 1) {
    fp_mul(r.c[0], a.c[0], b.c[0], k);
  } else {
    ext_mul<D>(r, a, b, k);
  }
}

template <int D>
PCD_FN void fe_load_const(Fe<D>& r, const uint32_t src[3][NL]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int l = 0; l < NL; ++l) r.c[i][l] = src[i][l];
}

// Inversion (K8's affine conversion, one a tile of scalars on one
// thread, so its latency and not its work counts): a binary extended
// Euclid (Hankerson-Menezes-Vanstone, alg. 2.22) on the canonical value c
// = a / R, with x1 starting at R mod p, so that it ends at R / c, the
// Montgomery form of a^-1: while u, v != 1, halve u (x1 by 2 mod p) while
// even, likewise v and x2, then subtract the smaller of u, v (and its x)
// from the larger.  Each step is a few shifts and carry chains of NL
// words, about 900 steps for a 298-bit p where Fermat's a^(p-2) is 450
// Montgomery products.  a = 0 gives 0.  r must not alias a.
PCD_FN void fp_halve(uint32_t x[NL], const uint32_t p[NL]) {
  const uint32_t m = 0u - (x[0] & 1u);   // odd: x + p, which is even
  uint32_t s[NL];
  s[0] = add_cc(x[0], p[0] & m);
#pragma unroll
  for (int i = 1; i < NL; ++i) s[i] = addc_cc(x[i], p[i] & m);
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) x[i] = (s[i] >> 1) | (s[i + 1] << 31);
  x[NL - 1] = s[NL - 1] >> 1;            // x + p < 2^301: no carry out
}

PCD_FN bool fp_is_one(const uint32_t a[NL]) {
  uint32_t o = a[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < NL; ++i) o |= a[i];
  return o == 0;
}

PCD_FN void fp_inv(uint32_t r[NL], const uint32_t a[NL],
                   const FieldConsts& k) {
  const uint32_t one[NL] = {1, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t u[NL], v[NL], x1[NL], x2[NL], t[NL];
  fp_mul(u, a, one, k);                  // c = a / R
  uint32_t nz = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    nz |= u[i];
    v[i] = k.p[i];
    x1[i] = k.one[i];
    x2[i] = 0;
  }
  if (!nz) {
#pragma unroll
    for (int i = 0; i < NL; ++i) r[i] = 0;
    return;
  }
  while (!fp_is_one(u) && !fp_is_one(v)) {
    while (!(u[0] & 1u)) {
#pragma unroll
      for (int i = 0; i < NL - 1; ++i) u[i] = (u[i] >> 1) | (u[i + 1] << 31);
      u[NL - 1] >>= 1;
      fp_halve(x1, k.p);
    }
    while (!(v[0] & 1u)) {
#pragma unroll
      for (int i = 0; i < NL - 1; ++i) v[i] = (v[i] >> 1) | (v[i + 1] << 31);
      v[NL - 1] >>= 1;
      fp_halve(x2, k.p);
    }
    t[0] = sub_cc(u[0], v[0]);
#pragma unroll
    for (int i = 1; i < NL; ++i) t[i] = subc_cc(u[i], v[i]);
    if (!subc(0, 0)) {                   // u >= v
#pragma unroll
      for (int i = 0; i < NL; ++i) u[i] = t[i];
      fp_sub(x1, x1, x2, k.p);
    } else {
      v[0] = sub_cc(v[0], u[0]);
#pragma unroll
      for (int i = 1; i < NL; ++i) v[i] = subc_cc(v[i], u[i]);
      fp_sub(x2, x2, x1, k.p);
    }
  }
  const bool first = fp_is_one(u);
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = first ? x1[i] : x2[i];
}

// Fp^D inverse through the norm to Fp: at D = 2 a^-1 = conj(a) / N(a),
// N(a) = a0^2 - nr a1^2; at D = 3 the adjugate (A, B, C) = a^s a^(s^2) (s
// the Frobenius) with A = a0^2 - nr a1 a2, B = nr a2^2 - a0 a1, C = a1^2 -
// a0 a2, and N(a) = a0 A + nr (a2 B + a1 C), one fp_mul_sum as ext_mul
// sums a component (the nr a_i scaled, not reduced).  One inversion
// in Fp (fp_inv) either way.  The plain version is FieldCtx.inv_plain
// (ops/field.py), which inverts by Fermat: the inverse is unique, so the
// two agree limb for limb.  r must not alias a.
template <int D>
PCD_FN void fe_inv(Fe<D>& r, const Fe<D>& a, const FieldConsts& k) {
  if constexpr (D == 1) {
    fp_inv(r.c[0], a.c[0], k);
  } else if constexpr (D == 2) {
    uint32_t s1[NL], u[NL], v[NL], ni[NL];
    fp_scale_small(s1, a.c[1], k.nr);
    fp_mul(u, a.c[0], a.c[0], k);
    fp_mul(v, s1, a.c[1], k);
    fp_sub(u, u, v, k.p);                     // N(a)
    fp_inv(ni, u, k);
    fp_mul(r.c[0], a.c[0], ni, k);
    fp_mul(v, a.c[1], ni, k);
    const uint32_t zero[NL] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    fp_sub(r.c[1], zero, v, k.p);
  } else {
    uint32_t s[3][NL], adj[3][NL], u[NL], v[NL], ni[NL];
    fp_scale_small(s[1], a.c[2], k.nr);       // x = (a0, nr a2, nr a1)
    fp_scale_small(s[2], a.c[1], k.nr);
#pragma unroll
    for (int l = 0; l < NL; ++l) s[0][l] = a.c[0][l];
    fp_mul(u, a.c[0], a.c[0], k);
    fp_mul(v, s[2], a.c[2], k);
    fp_sub(adj[0], u, v, k.p);                // A
    fp_mul(u, s[1], a.c[2], k);
    fp_mul(v, a.c[0], a.c[1], k);
    fp_sub(adj[1], u, v, k.p);                // B
    fp_mul(u, a.c[1], a.c[1], k);
    fp_mul(v, a.c[0], a.c[2], k);
    fp_sub(adj[2], u, v, k.p);                // C
    fp_mul_sum<3>(u, s, adj, k);              // N(a)
    fp_inv(ni, u, k);
#pragma unroll
    for (int i = 0; i < 3; ++i) fp_mul(r.c[i], adj[i], ni, k);
  }
}
