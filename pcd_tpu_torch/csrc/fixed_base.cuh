// K8's body (csrc/fixed_base.cu) as plain functions of one group or one
// node, so that csrc/host_check.cpp runs the card's product schedule on
// the host: the kernel calls them between its barriers, the host build
// calls them for every group or node in turn.
//
// A block takes a tile of scalars at a time, each scalar on S groups of
// K8_G(D) lanes (its split s covers the windows [s nwin / S, (s + 1) nwin
// / S)); the tile is the block's groups over S, and the launch picks S
// (fixed_base.cu k8_plan):
//   windows  each group, from the identity, one small-a mixed add
//            (csrc/ec_group.cuh, grp_add_row<D, G, SMALL, true>) of the
//            table row T[w][d] for each nonzero digit d of its windows,
//            its accumulator a projective row in shared memory;
//   join     S - 1 complete adds a scalar (the group add, MADD false) in
//            log2 S levels: split s += split s + 2^l where s is a
//            multiple of 2^(l+1), so split 0 ends with the sum;
//   invert   Montgomery's trick over the tile: the Z of each scalar (one
//            for the identity and the tile's unused places) at the leaves
//            of a product tree of a power of two leaves, built
//            level by level (k8_up), the root inverted by one thread
//            (fe_inv, csrc/field.cuh), and each node's inverse pushed
//            down (k8_down: a node's two children from its inverse and
//            their sibling's product), so each leaf holds its Z^-1;
//   store    x Z^-1, y Z^-1 out of Montgomery form, the identity (Z = 0)
//            zeros with the infinity flag (k8_out, pt_store_affine's
//            tail), as the Fermat-per-scalar kernel stored them.
#pragma once

#include "ec_group.cuh"

// The launch shape of K8: the most splits a scalar (a power of two);
// lanes an add at D = 1, 2, 3; threads a block; minimum resident blocks.  The fastest of kernel_ab.py --keygen
// --sweep's builds on the card; a sweep build overrides it (a pre-included
// header of its own #define), and host_check reports it to the CPU tests
// (op 6).
#ifndef K8_SHAPE
#define K8_SHAPE 2, 1, 1, 1, 128, 3
#endif
struct K8Shape {
  int s, g1, g2, g3, threads, minb;
};
constexpr K8Shape K8S{K8_SHAPE};
#define K8_G(D) ((D) == 1 ? K8S.g1 : (D) == 2 ? K8S.g2 : K8S.g3)
#if defined(__CUDACC__)
#define K8_CX __host__ __device__ constexpr
#else
#define K8_CX constexpr
#endif

// the least power of two >= x
K8_CX int k8_pow2(int x) {
  int t = 1;
  while (t < x) t *= 2;
  return t;
}

// groups a block, and the leaves of the largest tile's product tree (one
// split a scalar)
template <int D>
K8_CX int k8_ngrp() {
  return K8S.threads / 32 * (32 / K8_G(D));
}
template <int D>
K8_CX int k8_tree() {
  return k8_pow2(k8_ngrp<D>());
}
static_assert(K8S.s >= 1 && (K8S.s & (K8S.s - 1)) == 0 &&
                  k8_ngrp<1>() >= K8S.s && k8_ngrp<2>() >= K8S.s &&
                  k8_ngrp<3>() >= K8S.s,
              "K8_SHAPE: splits a power of two, a tile holds a scalar");

// shared words of a block: the groups' accumulators (3 D NL words each)
// and their slots (the complete add's, which the mixed add's fit in); the
// tree (2 k8_tree D NL words) reuses the slots after the join
template <int D>
K8_CX int k8_words() {
  constexpr int tree = 2 * k8_tree<D>() * D * NL;
  constexpr int slots = k8_ngrp<D>() * GrpSlots<false>::N * D * NL;
  return k8_ngrp<D>() * 3 * D * NL + (slots > tree ? slots : tree);
}

// the windows of split s of S: [*w0, *w1)
PCD_FN void k8_range(int s, int S, int nwin, int* w0, int* w1) {
  *w0 = s * nwin / S;
  *w1 = (s + 1) * nwin / S;
}

// the table row T[w][d] of (nwin, 256, 2, D, NL) affine Montgomery rows
template <int D>
PCD_FN const uint32_t* k8_row(const uint32_t* tbl, int w, uint32_t d) {
  return tbl + ((long)w * 256 + d) * (2 * D * NL);
}

// acc (3, D, NL) = the identity (0 : 1 : 0)
template <int D>
PCD_FN void k8_identity(uint32_t* acc, const FieldConsts& k) {
  for (int i = 0; i < 3 * D * NL; ++i)
    acc[i] = i >= D * NL && i < D * NL + NL ? k.one[i - D * NL] : 0u;
}

template <int D>
PCD_FN bool k8_is_zero(const uint32_t* z) {
  uint32_t o = 0;
  for (int i = 0; i < D * NL; ++i) o |= z[i];
  return o == 0;
}

// leaf q of the tree (tp leaves): the Z of the projective row acc, or
// one where acc is null (past the tile's scalars) or Z = 0 (the identity)
template <int D>
PCD_FN void k8_leaf(uint32_t* tree, int tp, int q, const uint32_t* acc,
                    const FieldConsts& k) {
  uint32_t* dst = tree + (long)(tp + q) * D * NL;
  const uint32_t* z = acc ? acc + 2 * D * NL : nullptr;
  const bool one = !z || k8_is_zero<D>(z);
  for (int i = 0; i < D * NL; ++i)
    dst[i] = one ? (i < NL ? k.one[i] : 0u) : z[i];
}

// node q (1 <= q < leaves) = the product of its children
template <int D>
PCD_FN void k8_up(uint32_t* tree, int q, const FieldConsts& k) {
  Fe<D> a, b, r;
  fe_ld<D>(a, tree + (long)(2 * q) * D * NL);
  fe_ld<D>(b, tree + (long)(2 * q + 1) * D * NL);
  fe_mul<D>(r, a, b, k);
  fe_st<D>(tree + (long)q * D * NL, r);
}

// the root (node 1) replaced by its inverse
template <int D>
PCD_FN void k8_root(uint32_t* tree, const FieldConsts& k) {
  Fe<D> a, r;
  fe_ld<D>(a, tree + D * NL);
  fe_inv<D>(r, a, k);
  fe_st<D>(tree + D * NL, r);
}

// node q holds its inverse: its children's inverses from it and their
// siblings' products
template <int D>
PCD_FN void k8_down(uint32_t* tree, int q, const FieldConsts& k) {
  Fe<D> inv, a, b, ra, rb;
  fe_ld<D>(inv, tree + (long)q * D * NL);
  fe_ld<D>(a, tree + (long)(2 * q) * D * NL);
  fe_ld<D>(b, tree + (long)(2 * q + 1) * D * NL);
  fe_mul<D>(ra, inv, b, k);
  fe_mul<D>(rb, inv, a, k);
  fe_st<D>(tree + (long)(2 * q) * D * NL, ra);
  fe_st<D>(tree + (long)(2 * q + 1) * D * NL, rb);
}

// dst (2, D, NL): the projective row acc in affine canonical coordinates,
// zi its Z^-1; for the identity zi is taken as 0 (fe_inv's 0^-1), so x
// and y are 0 as pt_store_affine stores them
template <int D>
PCD_FN void k8_out(uint32_t* dst, const uint32_t* acc, const uint32_t* zi,
                   const FieldConsts& k) {
  Pt<D> P;
  Fe<D> z;
  fe_ld<D>(P.X, acc);
  fe_ld<D>(P.Y, acc + D * NL);
  fe_ld<D>(P.Z, acc + 2 * D * NL);
  fe_ld<D>(z, zi);
  if (k8_is_zero<D>(acc + 2 * D * NL))
    for (int i = 0; i < D; ++i)
      for (int l = 0; l < NL; ++l) z.c[i][l] = 0;
  pt_store_affine_zi<D>(dst, P, z, k);
}
