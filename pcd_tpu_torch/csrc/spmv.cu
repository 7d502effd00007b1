// K6: sparse matrix-vector product over a prime field, spmv_rows.
//
// Replaces _apply_jit behind SparseMatVec.apply (pcd_tpu/ops/
// matvec_tensor.py:77-92), an XLA program with no Pallas site: the
// products val * z[col] of COO entries, a segmented modular sum by
// associative scan, and a scatter of the segment ends to their rows.  On
// the card the matrix is CSR and one thread owns one row: it walks its
// entries in order, multiplies and adds into a register accumulator and
// writes its row once, so no scan, no scatter and no chunking of the
// entries (the reference's MAX_CHUNK bounds a TPU working set) are needed.
// A row without entries writes zero.
//
// Row lengths are very uneven in the provers' matrices (the verifier
// gadget's long linear combinations beside single-entry rows), so a warp
// waits on its longest row; one thread per row is this kernel's first,
// simple form.
//
// Bound: operations: one Montgomery product (210 partial products) per
// entry against 44 bytes of the entry, the z row it gathers (each z row
// counted once) and 40 bytes per output row.
#include "rows.cuh"

__global__ void __launch_bounds__(256)
spmv_rows_kernel(const int32_t* __restrict__ rowptr,
                 const int32_t* __restrict__ cols,
                 const uint32_t* __restrict__ vals,
                 const uint32_t* __restrict__ z, uint32_t* __restrict__ out,
                 long n_rows, FieldConsts k) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  uint32_t acc[NL] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t v[NL], x[NL], p[NL];
  const int e1 = rowptr[i + 1];
  for (int e = rowptr[i]; e < e1; ++e) {
    ld_row(v, vals, e);
    ld_row(x, z, cols[e]);
    fp_mul(p, v, x, k);
    fp_add(acc, acc, p, k.p);
  }
  st_row(out, i, acc);
}

// rowptr (n_rows + 1,) i32, cols (nnz,) i32, vals (nnz, NL) u32 and z
// (n_cols, NL) u32 Montgomery, out (n_rows, NL) u32; consts points to a
// host FieldConsts; stream is a cudaStream_t.  Returns cudaGetLastError.
extern "C" int pcd_spmv_rows(const void* rowptr, const void* cols,
                             const void* vals, const void* z, void* out,
                             long n_rows, const void* consts, void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  if (n_rows <= 0) return 0;
  const dim3 block(256);
  const dim3 grid((unsigned)((n_rows + 255) / 256));
  spmv_rows_kernel<<<grid, block, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(cols),
      static_cast<const uint32_t*>(vals), static_cast<const uint32_t*>(z),
      static_cast<uint32_t*>(out), n_rows, k);
  return (int)cudaGetLastError();
}
