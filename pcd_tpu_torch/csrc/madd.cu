// K3: elementwise masked mixed addition, madd<D>.
//
// Replaces the Pallas kernel EC32Ctx.madd -> _madd_pallas_T
// (pcd_tpu/ops/ec32.py:527-630): acc[i] += (x2[i], y2[i]) row by row,
// with Q's Y negated where sign[i] is set, and the old acc kept where
// active[i] is clear.  As in K1 (and the reference's pad-limb flag,
// ec32.py:200-208), a table row whose infinity flag (bit 31 of X's top
// limb) is set leaves its acc unchanged.  The reference aliases acc to
// the output; here too each thread updates its row of acc in place and
// writes nothing for a row it keeps.  EC32Ctx is G1 only, so the entry
// point instantiates D = 1.
//
// Bound: operations.  One mixed add is 17 field products (17 x 210
// 32x32-bit partial products at D = 1) against 120 bytes of acc read and
// written, 80 bytes of Q and 8 bytes of flags per row.
#include "ec.cuh"

template <int D>
__global__ void __launch_bounds__(128)
madd_kernel(uint32_t* __restrict__ acc, const uint32_t* __restrict__ q,
            const int32_t* __restrict__ sign,
            const int32_t* __restrict__ active, long n, FieldConsts k) {
  const long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n || !active[g]) return;
  const uint4* row = reinterpret_cast<const uint4*>(q + g * (2 * D * NL));
  uint32_t buf[2 * D * NL];
#pragma unroll
  for (int i = 0; i < 2 * D * NL / 4; ++i) {
    uint4 u = row[i];
    buf[4 * i] = u.x;
    buf[4 * i + 1] = u.y;
    buf[4 * i + 2] = u.z;
    buf[4 * i + 3] = u.w;
  }
  if (buf[NL - 1] & 0x80000000u) return;  // row flagged infinity
  Fe<D> x, y;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      x.c[i][l] = buf[i * NL + l];
      y.c[i][l] = buf[(D + i) * NL + l];
    }
  if (sign[g]) fe_neg<D>(y, y, k);
  Pt<D> P, R;
  pt_load<D>(P, acc + g * (3 * D * NL));
  rcb_madd<D>(R, P, x, y, k);
  pt_store<D>(acc + g * (3 * D * NL), R);
}

// acc (n, 3, D, NL) u32, updated in place; q (n, 2, D, NL) u32 affine
// rows; sign, active (n,) i32; consts points to a host FieldConsts;
// stream is a cudaStream_t.  Returns cudaGetLastError.
extern "C" int pcd_madd(int D, void* acc, const void* q, const void* sign,
                        const void* active, long n, const void* consts,
                        void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  if (n <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((unsigned)((n + 127) / 128));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      madd_kernel<1><<<grid, block, 0, s>>>(
          static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(q),
          static_cast<const int32_t*>(sign),
          static_cast<const int32_t*>(active), n, k);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
