// sched_digits: the device scheduler's signed-digit recoding.
//
// Replaces the XLA glue of DevSchedMSM._p1 (pcd_tpu/ops/msm_stream_dev.py:
// 80-110), which has no Pallas site: the c-bit windows of every scalar,
// recoded to signed digits in [-2^(c-1), 2^(c-1)) by a carry that runs
// from the lowest window to the highest.  In torch that chain is about
// four launches per window (100 at c = 12 on 298-bit scalars); here one
// thread owns one scalar, keeps its carry in a register and walks all
// windows in one launch.  The top window absorbs the carry unsigned when
// the context has no carry window; a digit there above B (a scalar wider
// than scalar_bits) is written as B + 1, the overflow bin that
// DevSchedMSM's histogram fetch checks.
//
// Output is window-major, (nwin, n) magnitudes (int32) and signs (int8),
// so the per-window sort and histogram after it read contiguous rows.
//
// Bound: bytes.  4 * nwords bytes read and 5 * nwin written per scalar,
// against a few integer operations per window.
#include <cstdint>

#include <cuda_runtime.h>

__global__ void __launch_bounds__(256)
sched_digits_kernel(const uint32_t* __restrict__ W, long n, int nwords,
                    int c, int base, int carry_win, int B,
                    int32_t* __restrict__ mags, int8_t* __restrict__ signs) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* row = W + i * nwords;
  const uint32_t mask = (1u << c) - 1u;
  const int half = 1 << (c - 1);
  const int full = 1 << c;
  int carry = 0;
  for (int w = 0; w < base; ++w) {
    const int bit = w * c;
    const int w0 = bit >> 5, sh = bit & 31;
    uint32_t v = (w0 < nwords ? row[w0] : 0u) >> sh;
    if (sh + c > 32) v |= (w0 + 1 < nwords ? row[w0 + 1] : 0u) << (32 - sh);
    int d = (int)(v & mask) + carry;
    const long o = (long)w * n + i;
    if (w == base - 1 && !carry_win) {
      mags[o] = d > B ? B + 1 : d;
      signs[o] = 0;
      return;
    }
    carry = d >= half;
    d -= carry * full;
    signs[o] = d < 0;
    mags[o] = d < 0 ? -d : d;
  }
  mags[(long)base * n + i] = carry;
  signs[(long)base * n + i] = 0;
}

// W (n, nwords) u32 little-endian scalar words; mags (nwin, n) i32, signs
// (nwin, n) i8, nwin = base + carry_win; stream is a cudaStream_t.
// Returns cudaGetLastError.
extern "C" int pcd_sched_digits(const void* W, long n, int nwords, int c,
                                int base, int carry_win, int B, void* mags,
                                void* signs, void* stream) {
  if (n <= 0) return 0;
  if (c < 2 || c > 14 || base <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((unsigned)((n + 255) / 256));
  sched_digits_kernel<<<grid, block, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(W), n, nwords, c, base, carry_win, B,
      static_cast<int32_t*>(mags), static_cast<int8_t*>(signs));
  return (int)cudaGetLastError();
}
