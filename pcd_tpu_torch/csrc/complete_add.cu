// K2: elementwise complete projective addition, complete_add<D>.
//
// Replaces the row-layout EC32Ctx._add_pallas (pcd_tpu/ops/ec32.py:
// 411-444), which no path of the JAX package calls: the port keeps points
// row-major, and this is that function.  The stream-MSM finish's complete
// adds (ec32.py:343-409, 457-513, 915-1012, 1152-1222) are K4's
// (csrc/bucket_finish.cu); the finish's old K2-step sequence stays as its
// yardstick (StreamMSMCtx.finish_steps), so no path runs K2.
//
// Bound: operations.  18 field products per add against 2 x 120 * D bytes
// in and 120 * D out.  One add on one thread is a chain of 18 dependent
// products, and a thread that holds two points leaves room for few adds
// on an SM.  So at D = 1 and 2 a group of K2_G(D) lanes computes each add
// in three rounds of independent products (csrc/ec_group.cuh), the MNT
// curves' products by a and a^2 are small-integer scalings, and X3, Y3,
// Z3 take one reduction each: at D = 1 about 2,690 partial products an
// add where RCB15 alg. 1 takes 3,780.  The grid is as many blocks as are
// resident at once, each taking an even share of the rows, its groups the
// block's rows in turn, so no last wave runs nearly empty.  At D = 3 the
// group's slots (1,320 bytes a group) and the out-of-line Fp^3 products
// made that design slower on the card, so K2_G(3) = 0 keeps one thread an
// add through rcb_add (csrc/ec.cuh), the body before the redesign.
#include "ec_group.cuh"

// lanes an add, and minimum resident blocks of the group kernel (K2S,
// csrc/ec_group.cuh)
#define K2_G(D) ((D) == 1 ? K2S.g1 : (D) == 2 ? K2S.g2 : K2S.g3)
#define K2_MINB(D) ((D) == 1 ? K2S.minb1 : K2S.minb2)
constexpr int K2_THREADS = K2S.threads;

// groups a block, and shared bytes of their slots
template <int D>
constexpr int k2_ngrp() {
  return K2_THREADS / 32 * (32 / K2_G(D));
}

template <int D>
constexpr size_t k2_smem() {
  return (size_t)k2_ngrp<D>() * GrpSlots<false>::N * D * NL * 4;
}

template <int D, bool SMALL>
__global__ void __launch_bounds__(K2_THREADS, K2_MINB(D))
complete_add_kernel(const uint32_t* __restrict__ P,
                    const uint32_t* __restrict__ Q, uint32_t* __restrict__ out,
                    long n, long rows_per_block, FieldConsts k, SmallA sa) {
  constexpr int PW = 3 * D * NL;
  extern __shared__ __align__(16) uint32_t k2_slots[];
  const GrpLane<K2_G(D)> g;
  if (g.idle) return;
  uint32_t* S = k2_slots + g.grp * (GrpSlots<false>::N * D * NL);
  const long r0 = (long)blockIdx.x * rows_per_block;
  const long r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  for (long i = r0 + g.grp; i < r1; i += g.ngrp) {
    const GrpRow w{P + i * PW, Q + i * PW, out + i * PW, false};
    grp_add_row<D, K2_G(D), SMALL, false>(g.lane, g.mask, S, w, k, sa);
  }
}

// one thread an add (K2_G(D) = 0)
template <int D>
__global__ void __launch_bounds__(128)
complete_add_one(const uint32_t* __restrict__ P,
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

template <int D, bool SMALL>
static int k2_launch(const uint32_t* p, const uint32_t* q, uint32_t* o,
                     long n, const FieldConsts& k, const SmallA& sa,
                     cudaStream_t s) {
  if constexpr (K2_G(D) == 0) {
    complete_add_one<D><<<(unsigned)((n + 127) / 128), 128, 0, s>>>(
        p, q, o, n, k);
  } else {
    auto kern = complete_add_kernel<D, SMALL>;
    constexpr size_t smem = k2_smem<D>();
    static bool attr = false;
    if (!attr) {
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      attr = true;
    }
    long rows;
    const int grid = grp_grid(kern, K2_THREADS, smem, n, k2_ngrp<D>(),
                              &rows);
    kern<<<grid, K2_THREADS, smem, s>>>(p, q, o, n, rows, k, sa);
  }
  return (int)cudaGetLastError();
}

// P, Q, out: (n, 3, D, NL) u32; consts points to a host FieldConsts, small
// to a host SmallA; stream is a cudaStream_t.  Returns cudaGetLastError.
extern "C" int pcd_complete_add(int D, const void* P, const void* Q, void* out,
                                long n, const void* consts, const void* small,
                                void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  const SmallA sa = *reinterpret_cast<const SmallA*>(small);
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(P);
  const uint32_t* q = static_cast<const uint32_t*>(Q);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (D * 2 + (sa.on ? 1 : 0)) {
    case 2: return k2_launch<1, false>(p, q, o, n, k, sa, s);
    case 3: return k2_launch<1, true>(p, q, o, n, k, sa, s);
    case 4: return k2_launch<2, false>(p, q, o, n, k, sa, s);
    case 5: return k2_launch<2, true>(p, q, o, n, k, sa, s);
    case 6: return k2_launch<3, false>(p, q, o, n, k, sa, s);
    case 7: return k2_launch<3, true>(p, q, o, n, k, sa, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D, bool SMALL>
static int k2_info(int* out) {
  cudaFuncAttributes a;
  int per = 0;
  cudaError_t e;
  if constexpr (K2_G(D) == 0) {
    e = cudaFuncGetAttributes(&a, complete_add_one<D>);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, complete_add_one<D>, 128, 0);
    out[1] = 128;
    out[2] = 0;
    out[6] = 0;
  } else {
    auto kern = complete_add_kernel<D, SMALL>;
    e = cudaFuncGetAttributes(&a, kern);
    if (e != cudaSuccess) return (int)e;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)k2_smem<D>());
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, K2_THREADS,
                                                      k2_smem<D>());
    out[1] = K2_THREADS;
    out[2] = K2_MINB(D);
    out[6] = (int)k2_smem<D>();
  }
  out[0] = K2_G(D);
  out[3] = per;
  out[4] = a.numRegs;
  out[5] = (int)a.localSizeBytes;
  out[7] = 0;
  return (int)e;
}

// out[8]: lanes an add (0: one thread through rcb_add), threads a block,
// minimum blocks, resident blocks per SM, registers, local bytes a
// thread, shared bytes a block, 0, of the kernel for D and small (0 or 1).
extern "C" int pcd_complete_add_info(int D, int small, int* out) {
  switch (D * 2 + (small ? 1 : 0)) {
    case 2: return k2_info<1, false>(out);
    case 3: return k2_info<1, true>(out);
    case 4: return k2_info<2, false>(out);
    case 5: return k2_info<2, true>(out);
    case 6: return k2_info<3, false>(out);
    case 7: return k2_info<3, true>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
