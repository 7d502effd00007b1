// K7: elementwise prime-field operations of the quotient pipeline, by op
// code, one thread per output element.
//
// Replaces the pointwise XLA steps of the reference's device quotient
// that no transform holds: z to Montgomery and the replayed-witness check
// (a b - c) (pcd_tpu/snark/groth16/native.py:485-492), GM17's SAP
// evaluations (pcd_tpu/snark/gm17/native.py:324-347) and the root and
// scaling tables' build.  None of them has a Pallas site.  The scalings
// around a transform (ifft's n^-1, the coset tables of coset_fft and
// coset_ifft, pcd_tpu/ops/fft_tensor.py:111-123), the quotient's
// (a b - c) Z_H^-1 and its final from-Montgomery run in K5's prologue and
// epilogue instead (csrc/ntt.cu); FPV_MUL and FPV_ABC still compute them
// where a caller asks for the step alone.
//
//   FPV_MUL  out[i] = a[i] b[i mod nb]        (a table: nb = rows; a scalar:
//            nb = 1; canonical <-> Montgomery is a product by R^2 or by 1)
//   FPV_ABC  out[i] = (a[i] b[i] - c[i]) s    (s one element)
//   FPV_SAP  for i < n: with j = i / 2 below 2 nc, d = az - bz, w = d^2:
//              even i: a_ev = az + bz, c_ev = 4 cz + w, ext[j] = w;
//              odd i:  a_ev = d,       c_ev = w;
//            2 nc <= i < 2 nc + ni: a_ev = zi, c_ev = zi^2 = ext[nc + q];
//            above: zero.  (a = az, b = bz, c = cz, s = zi; out = a_ev,
//            out2 = c_ev, out3 = ext (nc + ni rows): the SAP extension of
//            the assignment that the MSMs take.)
//
// Every value is a 10 x u32 Montgomery element of [0, p) (csrc/field.cuh),
// so the results equal the plain torch versions (pcd_tpu_torch/ops/
// field.py) limb for limb.
//
// Bound: operations for the products (one to three Montgomery products of
// 210 partial products per element) against 80-160 bytes moved.
#include "rows.cuh"

#define FPV_MUL 0
#define FPV_ABC 1
#define FPV_SAP 2

__global__ void __launch_bounds__(256)
fp_vec_kernel(int op, long n, long nb, long ni,
              const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              const uint32_t* __restrict__ c, const uint32_t* __restrict__ s,
              uint32_t* __restrict__ out, uint32_t* __restrict__ out2,
              uint32_t* __restrict__ out3, FieldConsts k) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NL], y[NL], t[NL];
  if (op == FPV_MUL) {
    ld_row(x, a, i);
    ld_row(y, b, nb == n ? i : i % nb);
    fp_mul(t, x, y, k);
    st_row(out, i, t);
    return;
  }
  if (op == FPV_ABC) {
    ld_row(x, a, i);
    ld_row(y, b, i);
    fp_mul(t, x, y, k);
    ld_row(x, c, i);
    fp_sub(y, t, x, k.p);
    ld_row(x, s, 0);
    fp_mul(t, y, x, k);
    st_row(out, i, t);
    return;
  }
  // FPV_SAP: nb = nc R1CS rows, ni instance rows
  uint32_t av[NL], cv[NL];
  if (i < 2 * nb) {
    const long j = i >> 1;
    ld_row(x, a, j);
    ld_row(y, b, j);
    uint32_t d[NL], w[NL];
    fp_sub(d, x, y, k.p);
    fp_mul(w, d, d, k);
    if (i & 1) {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        av[l] = d[l];
        cv[l] = w[l];
      }
    } else {
      fp_add(av, x, y, k.p);
      ld_row(x, c, j);
      fp_add(t, x, x, k.p);         // 2 cz
      fp_add(y, t, t, k.p);         // 4 cz
      fp_add(cv, y, w, k.p);
      st_row(out3, j, w);
    }
  } else if (i < 2 * nb + ni) {
    const long q = i - 2 * nb;
    ld_row(av, s, q);
    fp_mul(cv, av, av, k);
    st_row(out3, nb + q, cv);
  } else {
#pragma unroll
    for (int l = 0; l < NL; ++l) av[l] = cv[l] = 0u;
  }
  st_row(out, i, av);
  st_row(out2, i, cv);
}

// Operands (rows, NL) u32 Montgomery; n output rows (FPV_MUL, FPV_ABC: of
// out; FPV_SAP: the domain size); nb: FPV_MUL b's rows, FPV_SAP the R1CS
// rows; ni: FPV_SAP the instance rows; consts points to a host
// FieldConsts; stream is a cudaStream_t.  Returns cudaGetLastError.
extern "C" int pcd_fp_vec(int op, long n, long nb, long ni, const void* a,
                          const void* b, const void* c, const void* s,
                          void* out, void* out2, void* out3,
                          const void* consts, void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  if (op < FPV_MUL || op > FPV_SAP || (nb <= 0 && op != FPV_SAP))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const dim3 block(256);
  const dim3 grid((unsigned)((n + 255) / 256));
  fp_vec_kernel<<<grid, block, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      op, n, nb, ni, static_cast<const uint32_t*>(a),
      static_cast<const uint32_t*>(b), static_cast<const uint32_t*>(c),
      static_cast<const uint32_t*>(s), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(out2), static_cast<uint32_t*>(out3), k);
  return (int)cudaGetLastError();
}
