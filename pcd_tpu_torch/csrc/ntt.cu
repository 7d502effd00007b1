// K5: one level of the mixed-radix NTT, ntt_level.
//
// Replaces one stage of FFTTensorCtx._transform (pcd_tpu/ops/
// fft_tensor.py:83-93), an XLA program with no Pallas site.  The plan is
// the reference's (`_plan`, lines 53-72): the domain's prime factors
// (radixes 2..31, poly/domain.py) taken bottom-up, a level (r, m) building
// transforms of length n_l = r m from r transforms of length m:
//
//   out[g, k] = sum_{j < r} T[(stride j k) mod n] in[g, j, k mod m]
//
// for group g of n_l points and 0 <= k < n_l, stride = n / n_l, T the
// (n, 10) table of powers of the domain's root (its inverse for an
// inverse transform), all Montgomery.  One thread owns one output point:
// it reads its r inputs and r - 1 twiddles (T[0] = 1: the j = 0 term is
// the input itself) and writes once.  The first level reads its inputs
// through the mixed-radix digit reversal `perm` (_input_permutation,
// lines 96-106): in[g, j, k'] is src[perm[g n_l + j m + k']].
//
// The twiddle index.  (stride j k) mod n = stride ((j k) mod n_l), and
// (j k) mod n_l is stepped over j by adding k < n_l and subtracting n_l
// once: every intermediate stays below 2 n_l, and the index below n, so
// 32-bit ints hold it at any n a u32 row count can take, with no
// division or 64-bit product per term.
//
// Bound: operations at radix 2 and up: r - 1 Montgomery products (210
// partial products each) per output against (r + 1) 40-byte rows read
// and written (the twiddle rows come from a table of n rows that the
// level reads n_l of).
#include "rows.cuh"

__global__ void __launch_bounds__(256)
ntt_level_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                 const uint32_t* __restrict__ tbl,
                 const int32_t* __restrict__ perm, int n, long total, int r,
                 int m, FieldConsts k) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long row0 = t - t % n;          // this batch row's first point
  const int i = (int)(t - row0);
  const int nl = r * m;
  const int stride = n / nl;
  const int kk = i % nl;                // k
  const int base = i - kk + kk % m;     // g n_l + (k mod m)
  uint32_t acc[NL], x[NL], w[NL], p[NL];
  ld_row(acc, src, row0 + (perm ? perm[base] : base));
  int e = 0;                            // (j k) mod n_l
  for (int j = 1; j < r; ++j) {
    e += kk;
    if (e >= nl) e -= nl;
    const int s = base + j * m;
    ld_row(x, src, row0 + (perm ? perm[s] : s));
    ld_row(w, tbl, (long)e * stride);
    fp_mul(p, x, w, k);
    fp_add(acc, acc, p, k.p);
  }
  st_row(dst, t, acc);
}

// src, dst (batch, n, NL) u32 Montgomery, distinct buffers; tbl (n, NL)
// root powers; perm (n,) i32 or null; r the level's radix, m its
// sub-transform length (r m divides n); consts points to a host
// FieldConsts; stream is a cudaStream_t.  Returns cudaGetLastError.
extern "C" int pcd_ntt_level(const void* src, void* dst, const void* tbl,
                             const void* perm, long n, int batch, int r,
                             int m, const void* consts, void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  if (n <= 0 || n > 0x3FFFFFFF || batch <= 0 || r < 2 || m < 1 ||
      n % ((long)r * m) != 0)
    return (int)cudaErrorInvalidValue;
  const long total = n * batch;
  const dim3 block(256);
  const dim3 grid((unsigned)((total + 255) / 256));
  ntt_level_kernel<<<grid, block, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
      static_cast<const uint32_t*>(tbl), static_cast<const int32_t*>(perm),
      (int)n, total, r, m, k);
  return (int)cudaGetLastError();
}
