// A host build of the kernels' field core and point formulas
// (csrc/field.cuh, csrc/ec.cuh) for the CPU tests: built with a plain C++
// compiler, the carry chains of csrc/ptx.cuh run in emulation, so the
// instruction sequence the card runs is held to the plain torch versions
// without a card (tests/test_torch_field_core.py).
//
//   g++ -O1 -std=c++17 -o host_check host_check.cpp
//   host_check < request > reply
//
// request: int32 op, D, n; a FieldConsts; then n records of u32 words:
//   op 0  fe_mul    a, b (D x 10 each)      -> D x 10
//   op 1  rcb_add   P, Q (3 x D x 10 each)  -> 3 x D x 10
//   op 2  rcb_madd  P (3 x D x 10), x, y    -> 3 x D x 10
// reply: the n results, u32 words.
#include <cstdio>
#include <vector>

#include "ec.cuh"

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

int main() {
  int32_t hdr[3];
  FieldConsts k;
  if (fread(hdr, 4, 3, stdin) != 3 || fread(&k, sizeof k, 1, stdin) != 1)
    return 2;
  const int op = hdr[0], D = hdr[1], n = hdr[2];
  if (op < 0 || op > 2) return 2;
  switch (D) {
    case 1: run<1>(op, k, n, stdin, stdout); break;
    case 2: run<2>(op, k, n, stdin, stdout); break;
    case 3: run<3>(op, k, n, stdin, stdout); break;
    default: return 2;
  }
  return 0;
}
