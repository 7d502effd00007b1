// K1: the stream-MSM lane accumulation, madd_accumulate<D>.
//
// Replaces the Pallas kernels EC32Ctx.madd_accumulate and
// EC32ExtCtx.madd_accumulate (pcd_tpu/ops/ec32.py:632-732, 1224-1330) and
// the XLA gather glue before them (pcd_tpu/ops/msm_stream.py:261-277).
// One thread owns one accumulator lane of one window and walks its rounds
// in a loop (the TPU's sequential grid axis): round t < loads[lane] reads
// perm[w, t, lane] (table row in bits 0-30, digit sign in bit 31),
// gathers that affine row from the table itself, skips it if its
// infinity flag (bit 31 of X's top limb) is set, negates Y for a negative
// digit, and folds it in with a complete mixed addition.  All windows of
// one MSM run in one grid: one window's 8192 lanes alone would not fill
// the card's 132 SMs.
//
// Bound: operations.  A mixed add is 17 field products (D = 1: 17 x 210
// 32x32-bit partial products) against 80 * D gathered bytes, so the
// kernel is integer-multiply bound.  The field core runs its products as
// carry chains (csrc/field.cuh); the accumulator stays in registers at
// D = 1 across all rounds and leaves once.  At D = 2, 3 the operands of
// the out-of-line Fp^D product live in the thread's local memory (L1),
// and the product keeps its own values in registers.
#include "ec.cuh"

// Minimum resident blocks of 128 threads per SM, per D.  An SM's
// registers come in four quarters, each holding whole warps, so only caps
// of 255, 168 and 128 registers (2, 3 or 4 blocks) change occupancy;
// kernel_ab.py --sweep measures them.  The fastest caps spill (D = 1:
// 52 B, D = 2: 4 B, D = 3: 704 B); uncapped nothing spills, and K1 runs
// 16-94% slower by form (PERF.md).
#ifndef K1_MINB1
#define K1_MINB1 4
#endif
#ifndef K1_MINB2
#define K1_MINB2 3
#endif
#ifndef K1_MINB3
#define K1_MINB3 4
#endif
#define K1_MINB(D) ((D) == 1 ? K1_MINB1 : (D) == 2 ? K1_MINB2 : K1_MINB3)

template <int D>
__global__ void __launch_bounds__(128, K1_MINB(D))
madd_accumulate_kernel(const uint32_t* __restrict__ table,
                       const uint32_t* __restrict__ perm,
                       const int32_t* __restrict__ loads,
                       uint32_t* __restrict__ out, long lanes_total, int T,
                       int L, FieldConsts k) {
  const long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= lanes_total) return;
  const long w = g / L;
  const long lane = g - w * L;
  Pt<D> acc;
  pt_identity<D>(acc, k);
  // Hide the identity's constant words from the optimizer: folding them
  // into the round loop crashes nvcc 12.9's front end at D = 1.
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      asm("" : "+r"(acc.X.c[i][l]));
      asm("" : "+r"(acc.Y.c[i][l]));
      asm("" : "+r"(acc.Z.c[i][l]));
    }
  const int ld = loads[g];
  const uint32_t* pw = perm + w * (long)T * L + lane;
  for (int t = 0; t < ld; ++t) {
    const uint32_t v = __ldg(pw + (long)t * L);
    const uint4* row = reinterpret_cast<const uint4*>(
        table + (long)(v & 0x7fffffffu) * (2 * D * NL));
    uint32_t buf[2 * D * NL];
#pragma unroll
    for (int q = 0; q < 2 * D * NL / 4; ++q) {
      uint4 u = __ldg(row + q);
      buf[4 * q] = u.x;
      buf[4 * q + 1] = u.y;
      buf[4 * q + 2] = u.z;
      buf[4 * q + 3] = u.w;
    }
    if (buf[NL - 1] & 0x80000000u) continue;  // row flagged infinity
    Fe<D> x, y;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        x.c[i][l] = buf[i * NL + l];
        y.c[i][l] = buf[(D + i) * NL + l];
      }
    if (v >> 31) fe_neg<D>(y, y, k);
    Pt<D> r;
    rcb_madd<D>(r, acc, x, y, k);
    acc = r;
  }
  pt_store<D>(out + g * (3 * D * NL), acc);
}

// table (m, 2, D, NL) u32, perm (nwin, T, L) u32, loads (nwin, L) i32,
// out (nwin * L, 3, D, NL) u32, every lane starting at the identity;
// consts points to a host FieldConsts; stream is a cudaStream_t.  Returns
// cudaGetLastError.
extern "C" int pcd_madd_accumulate(int D, const void* table, const void* perm,
                                   const void* loads, void* out,
                                   long lanes_total, int T, int L,
                                   const void* consts, void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  if (lanes_total <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((unsigned)((lanes_total + 127) / 128));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* tb = static_cast<const uint32_t*>(table);
  const uint32_t* pm = static_cast<const uint32_t*>(perm);
  const int32_t* ld = static_cast<const int32_t*>(loads);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (D) {
    case 1:
      madd_accumulate_kernel<1><<<grid, block, 0, s>>>(tb, pm, ld, o,
                                                       lanes_total, T, L, k);
      break;
    case 2:
      madd_accumulate_kernel<2><<<grid, block, 0, s>>>(tb, pm, ld, o,
                                                       lanes_total, T, L, k);
      break;
    case 3:
      madd_accumulate_kernel<3><<<grid, block, 0, s>>>(tb, pm, ld, o,
                                                       lanes_total, T, L, k);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
