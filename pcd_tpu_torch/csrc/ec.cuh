// Short-Weierstrass point formulas of the port's EC kernels over Fp^D:
// the complete projective addition of Renes-Costello-Batina 2015 (alg. 1,
// any a) and its mixed form with Z2 = 1 (alg. 2).  The same operation
// sequence as _rcb_add / _rcb_maddT_ns (pcd_tpu/ops/ec32.py:24-58,
// 162-210) and the plain torch versions (pcd_tpu_torch/ops/ec.py), so the
// kernels and the plain versions produce the same projective triples.
// Points are 3 * D * NL u32 words (X, Y, Z; component-major).
#pragma once

#include "field.cuh"

template <int D>
struct Pt {
  Fe<D> X, Y, Z;
};

template <int D>
PCD_FN void pt_identity(Pt<D>& P, const FieldConsts& k) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      P.X.c[i][l] = 0;
      P.Y.c[i][l] = i == 0 ? k.one[l] : 0u;
      P.Z.c[i][l] = 0;
    }
}

#if defined(__CUDACC__)
template <int D>
PCD_FN void pt_load(Pt<D>& P, const uint32_t* src) {
  const uint2* s = reinterpret_cast<const uint2*>(src);
  uint32_t buf[3 * D * NL];
#pragma unroll
  for (int q = 0; q < 3 * D * NL / 2; ++q) {
    uint2 v = s[q];
    buf[2 * q] = v.x;
    buf[2 * q + 1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      P.X.c[i][l] = buf[i * NL + l];
      P.Y.c[i][l] = buf[(D + i) * NL + l];
      P.Z.c[i][l] = buf[(2 * D + i) * NL + l];
    }
}

template <int D>
PCD_FN void pt_store(uint32_t* dst, const Pt<D>& P) {
  uint2* d = reinterpret_cast<uint2*>(dst);
  uint32_t buf[3 * D * NL];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      buf[i * NL + l] = P.X.c[i][l];
      buf[(D + i) * NL + l] = P.Y.c[i][l];
      buf[(2 * D + i) * NL + l] = P.Z.c[i][l];
    }
#pragma unroll
  for (int q = 0; q < 3 * D * NL / 2; ++q)
    d[q] = make_uint2(buf[2 * q], buf[2 * q + 1]);
}
#endif

// Shared tail of both formulas, from t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2,
// t3 = X1 Y2 + X2 Y1, t4 = X1 Z2 + X2 Z1, t5 = Y1 Z2 + Y2 Z1.  Ordered so
// that each input dies as early as it can: at most seven field elements
// are live besides the product in flight (the kernels' register peak).
// R is written after the last read of t0, t1, t2 and t4.
template <int D>
PCD_FN void rcb_tail(Pt<D>& R, const Fe<D>& t0,
                                         const Fe<D>& t1, const Fe<D>& t2,
                                         const Fe<D>& t3, const Fe<D>& t4,
                                         const Fe<D>& t5,
                                         const FieldConsts& k) {
  Fe<D> A, B3, A2, u, v;
  fe_load_const<D>(A, k.a);
  fe_load_const<D>(B3, k.b3);
  fe_load_const<D>(A2, k.a2);
  Fe<D> x3, z3, t1n, t4n;
  fe_mul(u, A, t4, k);
  fe_mul(v, B3, t2, k);
  fe_add(u, u, v, k);           // Zp = a t4 + 3b t2
  fe_sub(x3, t1, u, k);
  fe_add(z3, t1, u, k);         // t1 dead
  fe_add(t1n, t0, t0, k);
  fe_add(t1n, t1n, t0, k);
  fe_mul(u, A, t2, k);
  fe_add(t1n, t1n, u, k);       // 3 t0 + a t2
  fe_mul(u, A, t0, k);
  fe_mul(v, A2, t2, k);
  fe_sub(t4n, u, v, k);         // a t0 - a^2 t2; t0, t2 dead
  fe_mul(u, B3, t4, k);
  fe_add(t4n, u, t4n, k);       // 3b t4 + a t0 - a^2 t2; t4 dead
  fe_mul(u, x3, z3, k);
  fe_mul(v, t1n, t4n, k);
  fe_add(R.Y, u, v, k);
  fe_mul(u, t3, x3, k);
  fe_mul(v, t5, t4n, k);
  fe_sub(R.X, u, v, k);         // x3, t4n dead
  fe_mul(u, t5, z3, k);
  fe_mul(v, t3, t1n, k);
  fe_add(R.Z, u, v, k);
}

// R = P + Q, complete (any P, Q including the identity and P = +-Q)
template <int D>
PCD_FN void rcb_add(Pt<D>& R, const Pt<D>& P,
                                        const Pt<D>& Q, const FieldConsts& k) {
  Fe<D> t0, t1, t2, t3, t4, t5, u, v;
  fe_mul(t0, P.X, Q.X, k);
  fe_mul(t1, P.Y, Q.Y, k);
  fe_mul(t2, P.Z, Q.Z, k);
  fe_add(u, P.X, P.Y, k);
  fe_add(v, Q.X, Q.Y, k);
  fe_mul(t3, u, v, k);
  fe_sub(t3, t3, t0, k);
  fe_sub(t3, t3, t1, k);
  fe_add(u, P.X, P.Z, k);
  fe_add(v, Q.X, Q.Z, k);
  fe_mul(t4, u, v, k);
  fe_sub(t4, t4, t0, k);
  fe_sub(t4, t4, t2, k);
  fe_add(u, P.Y, P.Z, k);
  fe_add(v, Q.Y, Q.Z, k);
  fe_mul(t5, u, v, k);
  fe_sub(t5, t5, t1, k);
  fe_sub(t5, t5, t2, k);
  rcb_tail<D>(R, t0, t1, t2, t3, t4, t5, k);
}

// R = P + (x2, y2), the affine point finite (complete for P = identity and
// P = +-(x2, y2))
template <int D>
PCD_FN void rcb_madd(Pt<D>& R, const Pt<D>& P,
                                         const Fe<D>& x2, const Fe<D>& y2,
                                         const FieldConsts& k) {
  Fe<D> t0, t1, t3, t4, t5, u, v;
  fe_mul(t0, P.X, x2, k);
  fe_mul(t1, P.Y, y2, k);
  fe_add(u, P.X, P.Y, k);
  fe_add(v, x2, y2, k);
  fe_mul(t3, u, v, k);
  fe_sub(t3, t3, t0, k);
  fe_sub(t3, t3, t1, k);
  fe_mul(u, x2, P.Z, k);
  fe_add(t4, u, P.X, k);
  fe_mul(u, y2, P.Z, k);
  fe_add(t5, u, P.Y, k);
  rcb_tail<D>(R, t0, t1, P.Z, t3, t4, t5, k);
}

// dst (2, D, NL) = the affine canonical coordinates of P (x = X / Z, y = Y
// / Z, out of Montgomery form by a product with the integer 1), and for
// the identity (Z = 0) zeros with the infinity flag, bit 31 of x's top
// limb (K8's output; its plain version FixedBaseDevice.mul_digits_plain).
template <int D>
PCD_FN void pt_store_affine(uint32_t* dst, const Pt<D>& P,
                            const FieldConsts& k) {
  Fe<D> zi, x, y;
  fe_inv<D>(zi, P.Z, k);
  fe_mul(x, P.X, zi, k);
  fe_mul(y, P.Y, zi, k);
  const uint32_t one[NL] = {1, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t zor = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int l = 0; l < NL; ++l) zor |= P.Z.c[i][l];
    fp_mul(x.c[i], x.c[i], one, k);
    fp_mul(y.c[i], y.c[i], one, k);
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      dst[i * NL + l] = x.c[i][l];
      dst[(D + i) * NL + l] = y.c[i][l];
    }
  if (!zor) dst[NL - 1] |= 0x80000000u;
}

// [s] G of one scalar by windows of 8 bits (K8, csrc/fixed_base.cu):
// from the identity, for each window w whose digit d = dg[w * stride] is
// not 0, a complete mixed add of the table row tbl[w][d] = d 2^(8w) G
// ((nwin, 256, 2, D, NL) affine Montgomery rows), then the affine
// canonical store.  rcb_madd is complete for acc = identity and acc =
// +-tbl[w][d], which the top window's wrap modulo the group order allows.
template <int D>
PCD_FN void fb_point(uint32_t* dst, const uint32_t* tbl, const uint8_t* dg,
                     long stride, int nwin, const FieldConsts& k) {
  constexpr int RW = 2 * D * NL;
  Pt<D> acc;
  pt_identity<D>(acc, k);
  for (int w = 0; w < nwin; ++w) {
    const uint32_t d = dg[(long)w * stride];
    if (d == 0) continue;
    const uint32_t* row = tbl + ((long)w * 256 + d) * RW;
    Fe<D> x, y;
#pragma unroll
    for (int c = 0; c < D; ++c)
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        x.c[c][l] = row[c * NL + l];
        y.c[c][l] = row[(D + c) * NL + l];
      }
    Pt<D> t;
    rcb_madd<D>(t, acc, x, y, k);
    acc = t;
  }
  pt_store_affine<D>(dst, acc, k);
}
