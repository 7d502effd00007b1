// A host build of the kernels' field core and point formulas
// (csrc/field.cuh, csrc/ec.cuh, csrc/ec_group.cuh) for the CPU tests:
// built with a plain C++ compiler, the carry chains of csrc/ptx.cuh run in
// emulation, so the instruction sequence the card runs is held to the
// plain torch versions without a card (tests/test_torch_field_core.py).
//
//   g++ -O1 -std=c++17 -o host_check host_check.cpp
//   host_check < request > reply
//
// request: int32 op, D, n; a FieldConsts; for ops 3-5 also int32 G and a
// SmallA; then n records of u32 words:
//   op 0  fe_mul    a, b (D x 10 each)      -> D x 10
//   op 1  rcb_add   P, Q (3 x D x 10 each)  -> 3 x D x 10
//   op 2  rcb_madd  P (3 x D x 10), x, y    -> 3 x D x 10
//   op 3  K2's add over a group of G lanes: P, Q         -> 3 x D x 10
//   op 4  K3's mixed add over G lanes: P, x, y, sign (1) -> 3 x D x 10
//   op 5  fe_mul_a  t (D x 10)              -> a t, a^2 t (2 x D x 10)
//   op 6  the kernels' launch shapes (D, n and the rest ignored): K2S's
//         six fields, K3S's three and K3_TILE, int32
//   op 7  fe_inv    a (D x 10)              -> D x 10
//   op 8  pt_store_affine P (3 x D x 10)    -> 2 x D x 10 (canonical)
//   op 9  fb_point, K8's body: after the FieldConsts an int32 nwin and the
//         window table (nwin x 256 x 2 x D x 10), then n records of nwin
//         digit bytes                       -> 2 x D x 10
// Ops 3-5 run the small-a form where SmallA.on is set (else the full
// products by a and a^2) and each lane's round in turn over one slots
// array, as the kernels' lanes run them between their syncs.
// reply: for ops 3-5 an int32, 1 where the small-a form ran; then the n
// results, u32 words.
#include <cstdio>
#include <vector>

#include "ec_group.cuh"

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
static void run_k8(int op, const FieldConsts& k, int n, FILE* in,
                   FILE* out) {
  const int F = D * NL, P = 3 * D * NL;
  int32_t nwin = 0;
  std::vector<uint32_t> tbl;
  if (op == 9) {
    if (fread(&nwin, 4, 1, in) != 1 || nwin <= 0) return;
    tbl.resize((size_t)nwin * 256 * 2 * F);
    if (fread(tbl.data(), 4, tbl.size(), in) != tbl.size()) return;
  }
  const int w_in = op == 7 ? 4 * F : op == 8 ? 4 * P : nwin;
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
    if (op == 8) {
      Pt<D> A;
      std::copy(buf.begin(), buf.end(), reinterpret_cast<uint8_t*>(&A));
      pt_store_affine<D>(res.data(), A, k);
    } else {
      fb_point<D>(res.data(), tbl.data(), buf.data(), 1, nwin, k);
    }
    fwrite(res.data(), 4, 2 * F, out);
  }
}

template <int D, int G>
static void run_grp_any(int op, const FieldConsts& k, const SmallA& sa,
                        int n, FILE* in, FILE* out) {
  if (sa.on)
    run_grp<D, G, true>(op, k, sa, n, in, out);
  else
    run_grp<D, G, false>(op, k, sa, n, in, out);
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
    const int32_t shapes[10] = {K2S.g1,    K2S.g2,    K2S.g3, K2S.threads,
                                K2S.minb1, K2S.minb2, K3S.g,  K3S.threads,
                                K3S.minb,  K3_TILE};
    fwrite(shapes, 4, 10, stdout);
    return 0;
  }
  if (fread(&k, sizeof k, 1, stdin) != 1) return 2;
  const int op = hdr[0], D = hdr[1], n = hdr[2];
  if (op < 0 || op > 9 || D < 1 || D > 3) return 2;
  if (op >= 7) {
    switch (D) {
      case 1: run_k8<1>(op, k, n, stdin, stdout); break;
      case 2: run_k8<2>(op, k, n, stdin, stdout); break;
      default: run_k8<3>(op, k, n, stdin, stdout); break;
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
