// K6: sparse matrix-vector product over a prime field, spmv_rows, its
// rows balanced.
//
// Replaces _apply_jit behind SparseMatVec.apply (pcd_tpu/ops/
// matvec_tensor.py:77-92), an XLA program with no Pallas site: the
// products val * z[col] of COO entries, a segmented modular sum by
// associative scan, and a scatter of the segment ends to their rows.  On
// the card the matrix is CSR and each row is summed where it lies, so no
// scan, no scatter and no chunking of the entries (the reference's
// MAX_CHUNK bounds a TPU working set) are needed.
//
// Row lengths are very uneven in the provers' matrices (mean 6-7.5
// entries, the verifier gadget's long linear combinations up to 299), so
// with one thread a row a warp waits on its longest row.  The rows are
// binned once per matrix (ops/matvec_tensor.py `bin_rows`, in `order`):
//   - rows of more than SPMV_WARP_MIN (32) entries first, longest first,
//     one warp a row: the lanes stride the entries and a tree of
//     __shfl_down_sync modular adds sums the 32 partial sums;
//   - the rest one thread a row, ordered by their products and then
//     their units, so a warp holds rows of like cost.
// A row of the real matrices then costs at most 32 serial products
// where it cost 299.  No row of the provers' matrices is long enough
// for a block a row to pay (299 entries are 10 a lane).
//
// Units.  Within a row the entries whose value is one (Montgomery R)
// come first, units[row] of them: they add z[col] with no product and no
// value read.  Addition mod p is exact, so the order of the sum is free
// and the result equals the plain version limb for limb.  A row without
// entries writes zero.
//
// Bound: operations: one Montgomery product (210 partial products) per
// entry that is not a unit, against 4 bytes of column per entry, 40 of
// value per product, the z rows gathered (each counted once), the row
// data (pointer, units, order: 12 bytes) and 40 bytes per output row.
#include "rows.cuh"

#define SPMV_THREADS 256

__global__ void __launch_bounds__(SPMV_THREADS)
spmv_rows_kernel(const int32_t* __restrict__ rowptr,
                 const int32_t* __restrict__ units,
                 const int32_t* __restrict__ cols,
                 const uint32_t* __restrict__ vals,
                 const int32_t* __restrict__ order,
                 const uint32_t* __restrict__ z, uint32_t* __restrict__ out,
                 long n_rows, long n_warp, long warp_blocks, FieldConsts k) {
  uint32_t acc[NL] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t v[NL], x[NL], p[NL];
  if (blockIdx.x < warp_blocks) {         // one warp a long row
    const long w = (long)blockIdx.x * (SPMV_THREADS / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (w >= n_warp) return;              // the whole warp
    const int row = order[w];
    const int e0 = rowptr[row], eu = e0 + units[row], e1 = rowptr[row + 1];
    for (int e = e0 + lane; e < eu; e += 32) {
      ld_row(x, z, cols[e]);
      fp_add(acc, acc, x, k.p);
    }
    for (int e = eu + lane; e < e1; e += 32) {
      ld_row(v, vals, e);
      ld_row(x, z, cols[e]);
      fp_mul(p, v, x, k);
      fp_add(acc, acc, p, k.p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int l = 0; l < NL; ++l)
        x[l] = __shfl_down_sync(0xffffffffu, acc[l], off);
      fp_add(acc, acc, x, k.p);
    }
    if (lane == 0) st_row(out, row, acc);
    return;
  }
  const long i = n_warp + (long)(blockIdx.x - warp_blocks) * SPMV_THREADS +
                 threadIdx.x;               // one thread a short row
  if (i >= n_rows) return;
  const int row = order[i];
  const int e0 = rowptr[row], eu = e0 + units[row], e1 = rowptr[row + 1];
  for (int e = e0; e < eu; ++e) {
    ld_row(x, z, cols[e]);
    fp_add(acc, acc, x, k.p);
  }
  for (int e = eu; e < e1; ++e) {
    ld_row(v, vals, e);
    ld_row(x, z, cols[e]);
    fp_mul(p, v, x, k);
    fp_add(acc, acc, p, k.p);
  }
  st_row(out, row, acc);
}

// rowptr (n_rows + 1,) i32; units (n_rows,) i32, each row's leading unit
// entries; cols (nnz,) i32, vals (nnz, NL) u32 and z (n_cols, NL) u32
// Montgomery; order (n_rows,) i32, the n_warp warp rows first; out
// (n_rows, NL) u32; consts points to a host FieldConsts; stream is a
// cudaStream_t.  Returns cudaGetLastError.
extern "C" int pcd_spmv_rows(const void* rowptr, const void* units,
                             const void* cols, const void* vals,
                             const void* order, const void* z, void* out,
                             long n_rows, long n_warp, const void* consts,
                             void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  if (n_warp < 0 || n_warp > n_rows) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  const long warp_blocks = (n_warp + SPMV_THREADS / 32 - 1) /
                           (SPMV_THREADS / 32);
  const long blocks = warp_blocks + (n_rows - n_warp + SPMV_THREADS - 1) /
                                        SPMV_THREADS;
  spmv_rows_kernel<<<(unsigned)blocks, SPMV_THREADS, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(units),
      static_cast<const int32_t*>(cols), static_cast<const uint32_t*>(vals),
      static_cast<const int32_t*>(order), static_cast<const uint32_t*>(z),
      static_cast<uint32_t*>(out), n_rows, n_warp, warp_blocks, k);
  return (int)cudaGetLastError();
}
