// One EC add over a group of G lanes: the point formulas of K2
// (csrc/complete_add.cu) and K3 (csrc/madd.cu), the same RCB15 algorithms
// as rcb_add / rcb_madd (csrc/ec.cuh), which K1 and K4 keep.
//
// A one-thread add runs its 18 (mixed: 17) Montgomery products one after
// another, and holds two points and the tail's temporaries in registers,
// so few adds are in flight on an SM.  Here the products of an add fall
// into three rounds, each a set of independent jobs that the G lanes of
// a group share (job j on lane j mod G):
//   round 1  the formula's products of the inputs: 6 for the complete
//            add (X1X2, Y1Y2, Z1Z2 and the three sums' products), 5 for
//            the mixed add; each lane loads the coordinates its job needs;
//   round 2  the tail's products by 3b (two), and the products by a and
//            a^2 (four): for the MNT curves a small multiple of one basis
//            element, so a scaling by a small integer and a reduction by a
//            small quotient (fe_mul_a), not a product;
//   round 3  X3, Y3 and Z3, each a sum of two products under one
//            Montgomery reduction (fe_mul_sum2).
// The lanes exchange their results through the group's slots in shared
// memory, with a __syncwarp of the group between rounds: each lane reads
// only what its next job needs, which a shuffle (one register, the same
// for every lane of the warp) would not allow without reading it all.
// Every result is fully reduced, as in the one-thread formulas, so the
// kernels equal the plain versions limb for limb.
//
// Built by a plain host compiler, the rounds are plain functions of the
// lane index: csrc/host_check.cpp runs each lane's round in turn over a
// slots array, so the CPU tests run the card's product schedule.
#pragma once

#include "ec.cuh"

// The launch shapes of K2 and K3, the fastest of kernel_ab.py --ec
// --sweep's builds on the card.  K2: lanes an add at D = 1, 2, 3 (0: one
// thread an add through rcb_add), threads a block, minimum resident
// blocks at D = 1, 2.  K3: lanes an add, threads a block, minimum
// resident blocks; it lists its rows eight sweeps of its threads at a
// time.  A sweep build overrides a whole shape (a header of its own
// #defines, pre-included); host_check reports them to the CPU tests.
#ifndef K2_SHAPE
#define K2_SHAPE 2, 1, 0, 128, 4, 2
#endif
#ifndef K3_SHAPE
#define K3_SHAPE 1, 128, 4
#endif
struct K2Shape {
  int g1, g2, g3, threads, minb1, minb2;
};
struct K3Shape {
  int g, threads, minb;
};
constexpr K2Shape K2S{K2_SHAPE};
constexpr K3Shape K3S{K3_SHAPE};
constexpr int K3_TILE = 8 * K3S.threads;

// A curve's a and a^2 as small-integer scalings, when each is s u^j with
// one small s (the MNT curves); `on` = 0 takes the full products by the
// FieldConsts' a and a^2 (the toy curves).  a t has component
// m = sa[m] t_{(m - ja) mod D}, sa[m] = s, times nr where m < ja (the
// wrapped terms of u^j u^i).  mu = floor(2^64 / (p_hi + 1)), p_hi =
// floor(p / 2^256).  Packed by pcd_tpu_torch/ops/ec.py (ECCtx.ksmall).
struct SmallA {
  uint32_t on, ja, ja2;
  uint32_t a[3], a2[3];
  uint32_t pad;
  u64 mu;
};

// r = s t mod p for s < 2^16, t < p and p >= 2^288.  With v = s t < 2^316
// and x = v_hi / (p_hi + 1) (v_hi = floor(v / 2^256) < 2^60), v / p < x +
// (2 s + 2) / p_hi and q0 = floor(v_hi mu / 2^64) > x - 1/16 - 1, so the
// quotient v / p is q0 or q0 + 1 and v - q0 p < 2p.
PCD_FN void fp_mul_small(uint32_t r[NL], const uint32_t t[NL], uint32_t s,
                         const uint32_t p[NL], u64 mu) {
  uint32_t v[NL], w[NL];
  fp_scale_small(v, t, s);
  const u64 vh = ((u64)v[NL - 1] << 32) | v[NL - 2];
#if defined(__CUDACC__)
  const uint32_t q0 = (uint32_t)__umul64hi(vh, mu);
#else
  const uint32_t q0 = (uint32_t)(((unsigned __int128)vh * mu) >> 64);
#endif
  fp_scale_small(w, p, q0);
  r[0] = sub_cc(v[0], w[0]);
#pragma unroll
  for (int l = 1; l < NL; ++l) r[l] = subc_cc(v[l], w[l]);
  fp_reduce_once(r, r, p);
}

// r = a t (which = 0) or a^2 t (which = 1); r must not alias t
template <int D, bool SMALL>
PCD_FN void fe_mul_a(Fe<D>& r, const Fe<D>& t, int which,
                     const FieldConsts& k, const SmallA& s) {
  if constexpr (SMALL) {
    const int j = which ? s.ja2 : s.ja;
#pragma unroll
    for (int m = 0; m < D; ++m) {
      // t_{(m - j) mod D}, chosen without indexing a register array
      uint32_t src[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) src[l] = t.c[0][l];
#pragma unroll
      for (int i = 1; i < D; ++i) {
        if ((m - j + D) % D == i) {
#pragma unroll
          for (int l = 0; l < NL; ++l) src[l] = t.c[i][l];
        }
      }
      fp_mul_small(r.c[m], src, which ? s.a2[m] : s.a[m], k.p, s.mu);
    }
  } else {
    Fe<D> c;
    fe_load_const<D>(c, which ? k.a2 : k.a);
    fe_mul<D>(r, c, t, k);
  }
}

// r = a b + c d over Fp^D, one Montgomery reduction a component: at D = 1
// fp_mul_sum<2>; above, each component's 2D products (wrapped terms'
// left operand scaled by nr, as ext_mul) in one fp_mul_sum<2D>, below
// 2 (1 + 2 nr) p^2 < R p.  Out of line above D = 1, as ext_mul.
template <int D>
PCD_NOINLINE void ext_mul_sum2(Fe<D>& r, const Fe<D>& a, const Fe<D>& b,
                               const Fe<D>& c, const Fe<D>& d,
                               const FieldConsts& k) {
  uint32_t sa[D][NL], sc[D][NL];
#pragma unroll
  for (int i = 1; i < D; ++i) {
    fp_scale_small(sa[i], a.c[i], k.nr);
    fp_scale_small(sc[i], c.c[i], k.nr);
  }
#pragma unroll
  for (int m = 0; m < D; ++m) {
    uint32_t x[2 * D][NL], y[2 * D][NL];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int j = (m - i + D) % D;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        x[i][l] = i + j >= D ? sa[i][l] : a.c[i][l];
        y[i][l] = b.c[j][l];
        x[D + i][l] = i + j >= D ? sc[i][l] : c.c[i][l];
        y[D + i][l] = d.c[j][l];
      }
    }
    fp_mul_sum<2 * D>(r.c[m], x, y, k);
  }
}

template <int D>
PCD_FN void fe_mul_sum2(Fe<D>& r, const Fe<D>& a, const Fe<D>& b,
                        const Fe<D>& c, const Fe<D>& d,
                        const FieldConsts& k) {
  if constexpr (D == 1) {
    uint32_t x[2][NL], y[2][NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      x[0][l] = a.c[0][l];
      y[0][l] = b.c[0][l];
      x[1][l] = c.c[0][l];
      y[1][l] = d.c[0][l];
    }
    fp_mul_sum<2>(r.c[0], x, y, k);
  } else {
    ext_mul_sum2<D>(r, a, b, c, d, k);
  }
}

// one field element of D x NL words at src / to dst (global or shared
// memory, 8-byte aligned)
template <int D>
PCD_FN void fe_ld(Fe<D>& r, const uint32_t* src) {
#if defined(__CUDACC__)
  const uint2* s = reinterpret_cast<const uint2*>(src);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int q = 0; q < NL / 2; ++q) {
      const uint2 v = s[i * NL / 2 + q];
      r.c[i][2 * q] = v.x;
      r.c[i][2 * q + 1] = v.y;
    }
#else
  for (int i = 0; i < D; ++i)
    for (int l = 0; l < NL; ++l) r.c[i][l] = src[i * NL + l];
#endif
}

template <int D>
PCD_FN void fe_st(uint32_t* dst, const Fe<D>& a) {
#if defined(__CUDACC__)
  uint2* d = reinterpret_cast<uint2*>(dst);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int q = 0; q < NL / 2; ++q)
      d[i * NL / 2 + q] = make_uint2(a.c[i][2 * q], a.c[i][2 * q + 1]);
#else
  for (int i = 0; i < D; ++i)
    for (int l = 0; l < NL; ++l) dst[i * NL + l] = a.c[i][l];
#endif
}

// One add's operands: P a projective point row (3, D, NL); Q a projective
// row (complete add) or an affine table row (2, D, NL; mixed add, its Y
// negated where neg); out the result row, which may alias P (every read
// of P precedes the group's last sync before round 3's stores).
struct GrpRow {
  const uint32_t* P;
  const uint32_t* Q;
  uint32_t* out;
  bool neg;
};

// Slots of a group: round 1's results, then round 2's (x3, z3, 3b t4,
// t1n = 3 t0 + a t2, u = a t0 - a^2 t2).  Complete add: X1X2, Y1Y2, Z1Z2,
// (X1+Y1)(X2+Y2), (X1+Z1)(X2+Z2), (Y1+Z1)(Y2+Z2); mixed add: X1x2, Y1y2,
// (X1+Y1)(x2+y2), x2Z1 + X1, y2Z1 + Y1 (its t2 is Z1 itself).
template <bool MADD>
struct GrpSlots {
  static constexpr int R1 = MADD ? 5 : 6;
  static constexpr int N = R1 + 5;
};

template <int D>
PCD_FN uint32_t* slot(uint32_t* S, int i) {
  return S + i * D * NL;
}

// round 1, job j: one product of the inputs into slot j
template <int D, bool MADD>
PCD_FN void grp_round1_job(int j, uint32_t* S, const GrpRow& w,
                           const FieldConsts& k) {
  constexpr int F = D * NL;
  Fe<D> x, y, u;
  if constexpr (!MADD) {
    // coordinates c0 (+ c1) of P and of Q
    const int c0 = j < 3 ? j : j == 5 ? 1 : 0;
    const int c1 = j == 3 ? 1 : 2;
    fe_ld<D>(x, w.P + c0 * F);
    fe_ld<D>(y, w.Q + c0 * F);
    if (j >= 3) {
      fe_ld<D>(u, w.P + c1 * F);
      fe_add<D>(x, x, u, k);
      fe_ld<D>(u, w.Q + c1 * F);
      fe_add<D>(y, y, u, k);
    }
    fe_mul<D>(u, x, y, k);
  } else {
    // P's X1 (j = 0, 2), Y1 (1), Z1 (3, 4); x2 (j = 0, 3), y2 (1, 4),
    // x2 + y2 (2); then X1 + Y1 for j = 2, and + X1 / + Y1 after the
    // product for j = 3 / 4
    fe_ld<D>(x, w.P + (j == 1 ? F : j >= 3 ? 2 * F : 0));
    if (j != 0 && j != 3) {
      fe_ld<D>(y, w.Q + F);
      if (w.neg) fe_neg<D>(y, y, k);
    }
    if (j == 2) {
      fe_ld<D>(u, w.Q);
      fe_add<D>(y, u, y, k);
      fe_ld<D>(u, w.P + F);
      fe_add<D>(x, x, u, k);
    } else if (j == 0 || j == 3) {
      fe_ld<D>(y, w.Q);
    }
    fe_mul<D>(u, x, y, k);
    if (j >= 3) {
      fe_ld<D>(x, w.P + (j - 3) * F);
      fe_add<D>(u, u, x, k);
    }
  }
  fe_st<D>(slot<D>(S, j), u);
}

template <int D, int G, bool MADD>
PCD_FN void grp_round1(int lane, uint32_t* S, const GrpRow& w,
                       const FieldConsts& k) {
  for (int j = lane; j < GrpSlots<MADD>::R1; j += G)
    grp_round1_job<D, MADD>(j, S, w, k);
}

// t_i of the RCB15 tail (csrc/ec.cuh rcb_tail) from round 1's slots
template <int D, bool MADD>
PCD_FN void grp_t(Fe<D>& r, int i, uint32_t* S, const GrpRow& w,
                  const FieldConsts& k) {
  Fe<D> u;
  if constexpr (!MADD) {
    // t0 t1 t2 as stored; t3 = p3 - t0 - t1, t4 = p4 - t0 - t2,
    // t5 = p5 - t1 - t2
    fe_ld<D>(r, slot<D>(S, i));
    if (i >= 3) {
      fe_ld<D>(u, slot<D>(S, i == 5 ? 1 : 0));
      fe_sub<D>(r, r, u, k);
      fe_ld<D>(u, slot<D>(S, i == 3 ? 1 : 2));
      fe_sub<D>(r, r, u, k);
    }
  } else {
    if (i == 2) {
      fe_ld<D>(r, w.P + 2 * D * NL);      // t2 = Z1
    } else if (i == 3) {                  // t3 = p3 - t0 - t1
      fe_ld<D>(r, slot<D>(S, 2));
      fe_ld<D>(u, slot<D>(S, 0));
      fe_sub<D>(r, r, u, k);
      fe_ld<D>(u, slot<D>(S, 1));
      fe_sub<D>(r, r, u, k);
    } else {                              // t0, t1, t4, t5 as stored
      fe_ld<D>(r, slot<D>(S, i < 2 ? i : i - 1));
    }
  }
}

// round 2, job j: 0: x3 = t1 - zp, z3 = t1 + zp (zp = a t4 + 3b t2);
// 1: 3b t4; 2: t1n = 3 t0 + a t2 and u = a t0 - a^2 t2.  The order of
// rcb_tail's additions; t4n = 3b t4 + u is formed where round 3 needs it.
template <int D, bool SMALL, bool MADD>
PCD_FN void grp_round2_job(int j, uint32_t* S, const GrpRow& w,
                           const FieldConsts& k, const SmallA& sa) {
  constexpr int R = GrpSlots<MADD>::R1;
  Fe<D> t, u, v;
  if (j < 2) {
    grp_t<D, MADD>(t, j == 0 ? 2 : 4, S, w, k);
    fe_load_const<D>(u, k.b3);
    fe_mul<D>(v, u, t, k);              // 3b t2 or 3b t4
    if (j == 1) {
      fe_st<D>(slot<D>(S, R + 2), v);
      return;
    }
    grp_t<D, MADD>(t, 4, S, w, k);
    fe_mul_a<D, SMALL>(u, t, 0, k, sa);
    fe_add<D>(u, u, v, k);              // zp = a t4 + 3b t2
    grp_t<D, MADD>(t, 1, S, w, k);
    fe_sub<D>(v, t, u, k);
    fe_st<D>(slot<D>(S, R), v);         // x3
    fe_add<D>(v, t, u, k);
    fe_st<D>(slot<D>(S, R + 1), v);     // z3
    return;
  }
  Fe<D> t2;
  grp_t<D, MADD>(t2, 2, S, w, k);
  grp_t<D, MADD>(t, 0, S, w, k);
  fe_mul_a<D, SMALL>(u, t2, 0, k, sa);  // a t2
  fe_add<D>(v, t, t, k);
  fe_add<D>(v, v, t, k);
  fe_add<D>(v, v, u, k);
  fe_st<D>(slot<D>(S, R + 3), v);       // t1n
  fe_mul_a<D, SMALL>(u, t, 0, k, sa);   // a t0
  fe_mul_a<D, SMALL>(v, t2, 1, k, sa);  // a^2 t2
  fe_sub<D>(u, u, v, k);
  fe_st<D>(slot<D>(S, R + 4), u);       // u
}

template <int D, int G, bool SMALL, bool MADD>
PCD_FN void grp_round2(int lane, uint32_t* S, const GrpRow& w,
                       const FieldConsts& k, const SmallA& sa) {
  for (int j = lane; j < 3; j += G)
    grp_round2_job<D, SMALL, MADD>(j, S, w, k, sa);
}

// round 3, job j: coordinate j of the result, X3 = t3 x3 - t5 t4n,
// Y3 = x3 z3 + t1n t4n, Z3 = t5 z3 + t3 t1n, stored to out
template <int D, bool MADD>
PCD_FN void grp_round3_job(int j, uint32_t* S, const GrpRow& w,
                           const FieldConsts& k) {
  constexpr int R = GrpSlots<MADD>::R1;
  Fe<D> a, b, c, d;
  if (j < 2) {                                        // t4n in d
    fe_ld<D>(d, slot<D>(S, R + 2));
    fe_ld<D>(a, slot<D>(S, R + 4));
    fe_add<D>(d, d, a, k);
  } else {
    fe_ld<D>(d, slot<D>(S, R + 3));                   // t1n
  }
  if (j == 0) {
    fe_neg<D>(d, d, k);
    grp_t<D, MADD>(a, 3, S, w, k);
    fe_ld<D>(b, slot<D>(S, R));
    grp_t<D, MADD>(c, 5, S, w, k);
  } else if (j == 1) {
    fe_ld<D>(a, slot<D>(S, R));
    fe_ld<D>(b, slot<D>(S, R + 1));
    fe_ld<D>(c, slot<D>(S, R + 3));
  } else {
    grp_t<D, MADD>(a, 5, S, w, k);
    fe_ld<D>(b, slot<D>(S, R + 1));
    grp_t<D, MADD>(c, 3, S, w, k);
  }
  Fe<D> r;
  fe_mul_sum2<D>(r, a, b, c, d, k);
  fe_st<D>(w.out + j * D * NL, r);
}

template <int D, int G, bool MADD>
PCD_FN void grp_round3(int lane, uint32_t* S, const GrpRow& w,
                       const FieldConsts& k) {
  for (int j = lane; j < 3; j += G) grp_round3_job<D, MADD>(j, S, w, k);
}

#if defined(__CUDACC__)
// the whole add of one row by the group: lane = the lane's index in its
// group, mask = the group's lanes in the warp.  Returns after the group's
// last read of its slots, so the next row may reuse them.
template <int D, int G, bool SMALL, bool MADD>
__device__ __forceinline__ void grp_add_row(int lane, unsigned mask,
                                            uint32_t* S, const GrpRow& w,
                                            const FieldConsts& k,
                                            const SmallA& sa) {
  grp_round1<D, G, MADD>(lane, S, w, k);
  __syncwarp(mask);
  grp_round2<D, G, SMALL, MADD>(lane, S, w, k, sa);
  __syncwarp(mask);
  grp_round3<D, G, MADD>(lane, S, w, k);
  __syncwarp(mask);
}

// the geometry of a launch: warps of 32 / G groups (the last 32 mod G
// lanes idle), groups a block, and the group's lane and mask
template <int G>
struct GrpLane {
  int lane, grp, ngrp;
  unsigned mask;
  bool idle;
  __device__ __forceinline__ GrpLane() {
    const int wl = threadIdx.x & 31;
    constexpr int per = 32 / G;
    lane = wl % G;
    idle = wl >= per * G;
    grp = (threadIdx.x >> 5) * per + wl / G;
    ngrp = (blockDim.x >> 5) * per;
    mask = ((1u << G) - 1) << (wl - lane);
  }
};

// blocks for n rows: as many as are resident at once, never more than
// rows / groups a block, and the rows a block takes (even shares)
template <typename Kernel>
inline int grp_grid(Kernel kernel, int threads, size_t smem, long n,
                    int ngrp, long* rows_per_block) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, smem);
  long grid = (long)(per > 0 ? per : 1) * sms;
  const long need = (n + ngrp - 1) / ngrp;
  if (need < grid) grid = need;
  *rows_per_block = (n + grid - 1) / grid;
  return (int)grid;
}
#endif
