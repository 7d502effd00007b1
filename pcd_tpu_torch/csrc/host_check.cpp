// A host build of the kernels' field core and point formulas
// (csrc/field.cuh, csrc/ec.cuh, csrc/ec_group.cuh) for the CPU tests:
// built with a plain C++ compiler, the carry chains of csrc/ptx.cuh run in
// emulation, so the instruction sequence the card runs is held to the
// plain torch versions without a card (tests/test_torch_field_core.py).
//
//   g++ -O1 -std=c++17 -o host_check host_check.cpp
//   host_check < request > reply
//
// request: int32 op, D, n; a FieldConsts; for ops 3-5 and 9 also int32 G
// and a SmallA; then n records of u32 words:
//   op 0  fe_mul    a, b (D x 10 each)      -> D x 10
//   op 1  rcb_add   P, Q (3 x D x 10 each)  -> 3 x D x 10
//   op 2  rcb_madd  P (3 x D x 10), x, y    -> 3 x D x 10
//   op 3  K2's add over a group of G lanes: P, Q         -> 3 x D x 10
//   op 4  K3's mixed add over G lanes: P, x, y, sign (1) -> 3 x D x 10
//   op 5  fe_mul_a  t (D x 10)              -> a t, a^2 t (2 x D x 10)
//   op 6  the kernels' launch shapes (D, n and the rest ignored): K2S's
//         six fields, K3S's three, K3_TILE and K8S's six, int32
//   op 7  fe_inv    a (D x 10)              -> D x 10
//   op 8  pt_store_affine P (3 x D x 10)    -> 2 x D x 10 (canonical)
//   op 9  K8's body (csrc/fixed_base.cuh) over tiles of scalars: after the
//         SmallA int32 S (splits a scalar), tile (scalars a tile) and nwin,
//         the window table (nwin x 256 x 2 x D x 10), then n records of
//         nwin digit bytes                  -> 2 x D x 10
// Ops 3-5 and 9 run the small-a form where SmallA.on is set (else the full
// products by a and a^2) and each lane's round in turn over one slots
// array, as the kernels' lanes run them between their syncs; op 9 runs
// each phase of a tile (windows, join levels, tree levels, stores) for
// every group or node before the next, as K8's barriers order them.
// reply: for ops 3-5 and 9 an int32, 1 where the small-a form ran; then
// the n results, u32 words.
#include <cstdio>
#include <vector>

#include "fixed_base.cuh"

template <int D, int G, bool SMALL, bool MADD>
static void grp_host(const GrpRow& w, const FieldConsts& k,
                     const SmallA& sa) {
  uint32_t S[GrpSlots<MADD>::N * D * NL];
  for (int l = 0; l < G; ++l) grp_round1<D, G, MADD>(l, S, w, k);
  for (int l = 0; l < G; ++l) grp_round2<D, G, SMALL, MADD>(l, S, w, k, sa);
  for (int l = 0; l < G; ++l) grp_round3<D, G, MADD>(l, S, w, k);
}

template <int D, int G, bool SMALL>
static void run_grp(int op, const FieldConsts& k, const SmallA& sa, int n,
                    FILE* in, FILE* out) {
  const int F = D * NL, P = 3 * D * NL;
  const int w_in = op == 3 ? 2 * P : op == 4 ? P + 2 * F + 1 : F;
  std::vector<uint32_t> buf(w_in), res(P);
  for (int i = 0; i < n; ++i) {
    if (fread(buf.data(), 4, w_in, in) != (size_t)w_in) return;
    if (op == 5) {
      Fe<D> t, r;
      std::copy(buf.begin(), buf.begin() + F, &t.c[0][0]);
      for (int which = 0; which < 2; ++which) {
        fe_mul_a<D, SMALL>(r, t, which, k, sa);
        fwrite(&r.c[0][0], 4, F, out);
      }
      continue;
    }
    const GrpRow w{buf.data(), buf.data() + P, res.data(),
                   op == 4 && buf[P + 2 * F] != 0};
    if (op == 3)
      grp_host<D, G, SMALL, false>(w, k, sa);
    else
      grp_host<D, G, SMALL, true>(w, k, sa);
    fwrite(res.data(), 4, P, out);
  }
}

template <int D>
static void run(int op, const FieldConsts& k, int n, FILE* in, FILE* out) {
  const int F = D * NL, P = 3 * D * NL;
  const int w_in = op == 0 ? 2 * F : op == 1 ? 2 * P : P + 2 * F;
  std::vector<uint32_t> buf(w_in);
  for (int i = 0; i < n; ++i) {
    if (fread(buf.data(), 4, w_in, in) != (size_t)w_in) return;
    if (op == 0) {
      Fe<D> a, b, r;
      std::copy(buf.begin(), buf.begin() + F, &a.c[0][0]);
      std::copy(buf.begin() + F, buf.begin() + 2 * F, &b.c[0][0]);
      fe_mul<D>(r, a, b, k);
      fwrite(&r.c[0][0], 4, F, out);
    } else {
      Pt<D> A, R;
      std::copy(buf.begin(), buf.begin() + P, &A.X.c[0][0]);
      if (op == 1) {
        Pt<D> B;
        std::copy(buf.begin() + P, buf.begin() + 2 * P, &B.X.c[0][0]);
        rcb_add<D>(R, A, B, k);
      } else {
        Fe<D> x, y;
        std::copy(buf.begin() + P, buf.begin() + P + F, &x.c[0][0]);
        std::copy(buf.begin() + P + F, buf.begin() + P + 2 * F, &y.c[0][0]);
        rcb_madd<D>(R, A, x, y, k);
      }
      fwrite(&R.X.c[0][0], 4, P, out);
    }
  }
}

template <int D>
static void run_inv(int op, const FieldConsts& k, int n, FILE* in,
                    FILE* out) {
  const int F = D * NL, P = 3 * D * NL;
  const int w_in = op == 7 ? 4 * F : 4 * P;
  std::vector<uint8_t> buf(w_in);
  std::vector<uint32_t> res(2 * F);
  for (int i = 0; i < n; ++i) {
    if (fread(buf.data(), 1, w_in, in) != (size_t)w_in) return;
    if (op == 7) {
      Fe<D> a, r;
      std::copy(buf.begin(), buf.end(), reinterpret_cast<uint8_t*>(&a));
      fe_inv<D>(r, a, k);
      fwrite(&r.c[0][0], 4, F, out);
      continue;
    }
    Pt<D> A;
    std::copy(buf.begin(), buf.end(), reinterpret_cast<uint8_t*>(&A));
    pt_store_affine<D>(res.data(), A, k);
    fwrite(res.data(), 4, 2 * F, out);
  }
}

// K8 over one tile of cnt scalars (their digit records, nwin bytes each)
// in a block of tile x S groups: the kernel's phases in its order
template <int D, int G, bool SMALL>
static void k8_host_tile(const uint8_t* recs, int cnt, int S, int tile,
                         int nwin, const uint32_t* tbl, uint32_t* out,
                         const FieldConsts& k, const SmallA& sa) {
  const int F = D * NL, PW = 3 * F;
  std::vector<uint32_t> accs((size_t)tile * S * PW);
  uint32_t slots[GrpSlots<false>::N * D * NL];
  for (int j = 0; j < cnt; ++j)
    for (int s = 0; s < S; ++s) {
      uint32_t* acc = &accs[(size_t)(j * S + s) * PW];
      k8_identity<D>(acc, k);
      int w0, w1;
      k8_range(s, S, nwin, &w0, &w1);
      for (int w = w0; w < w1; ++w) {
        const uint32_t d = recs[(size_t)j * nwin + w];
        if (d == 0) continue;
        const GrpRow row{acc, k8_row<D>(tbl, w, d), acc, false};
        for (int l = 0; l < G; ++l) grp_round1<D, G, true>(l, slots, row, k);
        for (int l = 0; l < G; ++l)
          grp_round2<D, G, SMALL, true>(l, slots, row, k, sa);
        for (int l = 0; l < G; ++l) grp_round3<D, G, true>(l, slots, row, k);
      }
    }
  for (int step = 1; step < S; step *= 2)
    for (int j = 0; j < cnt; ++j)
      for (int s = 0; s % (2 * step) == 0 && s + step < S; s += 2 * step) {
        uint32_t* acc = &accs[(size_t)(j * S + s) * PW];
        grp_host<D, G, SMALL, false>(GrpRow{acc, acc + step * PW, acc, false},
                                     k, sa);
      }
  int tp = 1;
  while (tp < tile) tp *= 2;
  std::vector<uint32_t> tree((size_t)2 * tp * F);
  for (int q = 0; q < tp; ++q)
    k8_leaf<D>(tree.data(), tp, q, q < cnt ? &accs[(size_t)q * S * PW]
                                           : nullptr, k);
  for (int h = tp / 2; h >= 1; h /= 2)
    for (int q = h; q < 2 * h; ++q) k8_up<D>(tree.data(), q, k);
  k8_root<D>(tree.data(), k);
  for (int h = 1; h < tp; h *= 2)
    for (int q = h; q < 2 * h; ++q) k8_down<D>(tree.data(), q, k);
  for (int q = 0; q < cnt; ++q)
    k8_out<D>(out + (size_t)q * 2 * F, &accs[(size_t)q * S * PW],
              &tree[(size_t)(tp + q) * F], k);
}

template <int D, int G, bool SMALL>
static int run_k8(const FieldConsts& k, const SmallA& sa, int n, FILE* in,
                  FILE* out) {
  int32_t hdr[3];
  if (fread(hdr, 4, 3, in) != 3) return 2;
  const int S = hdr[0], tile = hdr[1], nwin = hdr[2];
  if (S < 1 || tile < 1 || nwin < 1) return 2;
  const int F = D * NL;
  std::vector<uint32_t> tbl((size_t)nwin * 256 * 2 * F);
  if (fread(tbl.data(), 4, tbl.size(), in) != tbl.size()) return 2;
  std::vector<uint8_t> recs((size_t)n * nwin);
  if (fread(recs.data(), 1, recs.size(), in) != recs.size()) return 2;
  std::vector<uint32_t> res((size_t)n * 2 * F);
  for (int i0 = 0; i0 < n; i0 += tile)
    k8_host_tile<D, G, SMALL>(&recs[(size_t)i0 * nwin],
                              n - i0 < tile ? n - i0 : tile, S, tile, nwin,
                              tbl.data(), &res[(size_t)i0 * 2 * F], k, sa);
  fwrite(res.data(), 4, res.size(), out);
  return 0;
}

template <int D, int G>
static void run_grp_any(int op, const FieldConsts& k, const SmallA& sa,
                        int n, FILE* in, FILE* out) {
  if (op == 9) {
    if (sa.on)
      run_k8<D, G, true>(k, sa, n, in, out);
    else
      run_k8<D, G, false>(k, sa, n, in, out);
  } else if (sa.on) {
    run_grp<D, G, true>(op, k, sa, n, in, out);
  } else {
    run_grp<D, G, false>(op, k, sa, n, in, out);
  }
}

template <int D>
static int run_grp_g(int op, int G, const FieldConsts& k, const SmallA& sa,
                     int n, FILE* in, FILE* out) {
  switch (G) {
    case 1: run_grp_any<D, 1>(op, k, sa, n, in, out); return 0;
    case 2: run_grp_any<D, 2>(op, k, sa, n, in, out); return 0;
    case 3: run_grp_any<D, 3>(op, k, sa, n, in, out); return 0;
    case 6: run_grp_any<D, 6>(op, k, sa, n, in, out); return 0;
    default: return 2;
  }
}

int main() {
  int32_t hdr[3];
  FieldConsts k;
  if (fread(hdr, 4, 3, stdin) != 3) return 2;
  if (hdr[0] == 6) {
    const int32_t shapes[16] = {K2S.g1,    K2S.g2,    K2S.g3, K2S.threads,
                                K2S.minb1, K2S.minb2, K3S.g,  K3S.threads,
                                K3S.minb,  K3_TILE,   K8S.s,  K8S.g1,
                                K8S.g2,    K8S.g3,    K8S.threads, K8S.minb};
    fwrite(shapes, 4, 16, stdout);
    return 0;
  }
  if (fread(&k, sizeof k, 1, stdin) != 1) return 2;
  const int op = hdr[0], D = hdr[1], n = hdr[2];
  if (op < 0 || op > 9 || D < 1 || D > 3) return 2;
  if (op == 7 || op == 8) {
    switch (D) {
      case 1: run_inv<1>(op, k, n, stdin, stdout); break;
      case 2: run_inv<2>(op, k, n, stdin, stdout); break;
      default: run_inv<3>(op, k, n, stdin, stdout); break;
    }
    return 0;
  }
  if (op >= 3) {
    int32_t G;
    SmallA sa;
    if (fread(&G, 4, 1, stdin) != 1 || fread(&sa, sizeof sa, 1, stdin) != 1)
      return 2;
    const int32_t ran = sa.on ? 1 : 0;
    fwrite(&ran, 4, 1, stdout);
    switch (D) {
      case 1: return run_grp_g<1>(op, G, k, sa, n, stdin, stdout);
      case 2: return run_grp_g<2>(op, G, k, sa, n, stdin, stdout);
      default: return run_grp_g<3>(op, G, k, sa, n, stdin, stdout);
    }
  }
  switch (D) {
    case 1: run<1>(op, k, n, stdin, stdout); break;
    case 2: run<2>(op, k, n, stdin, stdout); break;
    default: run<3>(op, k, n, stdin, stdout); break;
  }
  return 0;
}
