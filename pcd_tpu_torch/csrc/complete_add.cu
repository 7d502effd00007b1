// K2: elementwise complete projective addition, complete_add<D>.
//
// Replaces the row-layout EC32Ctx._add_pallas (pcd_tpu/ops/ec32.py:
// 411-444), which no path of the JAX package calls: the port keeps points
// row-major, and this is that function.  The stream-MSM finish's complete
// adds (ec32.py:343-409, 457-513, 915-1012, 1152-1222) are K4's
// (csrc/bucket_finish.cu); the finish's old K2-step sequence stays as its
// yardstick (StreamMSMCtx.finish_steps), so no path runs K2.  One thread
// computes out[i] = P[i] + Q[i] with RCB15 alg. 1 for any a.
//
// Bound: operations.  18 field products per add against 2 x 120 * D bytes
// in and 120 * D out.
#include "ec.cuh"

template <int D>
__global__ void __launch_bounds__(128)
complete_add_kernel(const uint32_t* __restrict__ P,
                    const uint32_t* __restrict__ Q, uint32_t* __restrict__ out,
                    long n, FieldConsts k) {
  const long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  Pt<D> a, b, r;
  pt_load<D>(a, P + g * (3 * D * NL));
  pt_load<D>(b, Q + g * (3 * D * NL));
  rcb_add<D>(r, a, b, k);
  pt_store<D>(out + g * (3 * D * NL), r);
}

// P, Q, out: (n, 3, D, NL) u32; consts points to a host FieldConsts;
// stream is a cudaStream_t.  Returns cudaGetLastError.
extern "C" int pcd_complete_add(int D, const void* P, const void* Q, void* out,
                                long n, const void* consts, void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  if (n <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((unsigned)((n + 127) / 128));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(P);
  const uint32_t* q = static_cast<const uint32_t*>(Q);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (D) {
    case 1:
      complete_add_kernel<1><<<grid, block, 0, s>>>(p, q, o, n, k);
      break;
    case 2:
      complete_add_kernel<2><<<grid, block, 0, s>>>(p, q, o, n, k);
      break;
    case 3:
      complete_add_kernel<3><<<grid, block, 0, s>>>(p, q, o, n, k);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
