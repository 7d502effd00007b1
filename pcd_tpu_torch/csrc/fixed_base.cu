// K8: fixed-base scalar multiplication, fixed_base<D>: [s_i] G for many
// scalars s_i and one base G, the SNARK setups' key generation.
//
// Replaces FixedBaseDevice.mul_digits (pcd_tpu/ops/fixed_base.py:63-75),
// an XLA program (no Pallas site): nwin gathers from a window table, each
// followed by a batched complete add.  Here one thread computes one
// output: from the identity, for each window w with digit d != 0 (the
// scalar's byte w: windows of c = 8 bits, the reference's), one complete
// mixed add of the table row T[w][d] = d 2^(8w) G (RCB15 alg. 2,
// csrc/ec.cuh rcb_madd, as K1 and ECCtx._rcb_madd run it).  The add must
// be complete: in the top window d 2^(8w) wraps modulo the group order, so
// the accumulator can equal +-T[w][d] (and it starts at the identity).
// Then the point goes to affine canonical coordinates, with one inversion
// of Z (csrc/field.cuh fe_inv: Fermat in Fp, through the norm at D = 2,
// 3), and the identity (scalar 0) to zeros with the infinity flag.
//
// Table: (nwin, 256, 2, D, NL) u32 affine Montgomery rows, row 0 of each
// window flagged at infinity (bit 31 of X's top limb) and never read;
// digits: (nwin, n) u8, window-major, so a warp reads one window's digits
// of 32 scalars in one line; out: (n, 2, D, NL) u32.
//
// Bound: operations.  Each scalar takes one mixed add (17 Fp^D products)
// a nonzero digit, 38 of them for a 298-bit scalar, and the inversion
// (297 squarings and 153-169 products in Fp, 4 or 12 Fp products more at
// D = 2, 3), against 38 bytes of digits in and 80 D bytes out; the table
// rows (20 D KB a window) stay in the caches.  One thread an output keeps
// the kernel simple; its adds are a chain of dependent products, so its
// latency is hidden only by many threads (setups give 10^4 - 10^6
// scalars).
#include "ec.cuh"

constexpr int FB_THREADS = 128;

// one thread an output: fb_point (csrc/ec.cuh) over the scalar's digit
// column
template <int D>
__global__ void __launch_bounds__(FB_THREADS)
fixed_base_kernel(const uint32_t* __restrict__ tbl,
                  const uint8_t* __restrict__ digits,
                  uint32_t* __restrict__ out, long n, int nwin,
                  FieldConsts k) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fb_point<D>(out + i * (2 * D * NL), tbl, digits + i, n, nwin, k);
}

template <int D>
static int fb_launch(const uint32_t* tbl, const uint8_t* dg, uint32_t* o,
                     long n, int nwin, const FieldConsts& k,
                     cudaStream_t s) {
  fixed_base_kernel<D><<<(unsigned)((n + FB_THREADS - 1) / FB_THREADS),
                         FB_THREADS, 0, s>>>(tbl, dg, o, n, nwin, k);
  return (int)cudaGetLastError();
}

// tbl: (nwin, 256, 2, D, NL) u32; digits: (nwin, n) u8; out: (n, 2, D, NL)
// u32; consts points to a host FieldConsts; stream is a cudaStream_t.
// Returns cudaGetLastError.
extern "C" int pcd_fixed_base_mul(int D, const void* tbl, const void* digits,
                                  void* out, long n, int nwin,
                                  const void* consts, void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  if (n <= 0) return 0;
  if (nwin <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* t = static_cast<const uint32_t*>(tbl);
  const uint8_t* dg = static_cast<const uint8_t*>(digits);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (D) {
    case 1: return fb_launch<1>(t, dg, o, n, nwin, k, s);
    case 2: return fb_launch<2>(t, dg, o, n, nwin, k, s);
    case 3: return fb_launch<3>(t, dg, o, n, nwin, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
