// One complete add's latency, for kernel_ab.py --ec, built from this
// checkout's pcd_tpu_torch/csrc with -I pointing there; no path of the port
// runs it.  Each chain adds a point P to R = P, N times in sequence
// (R = (N + 1) P at the end), so its time over N is the latency of one
// add on the chain's critical path, at the occupancy n chains get:
//
// pcd_chain_one: one thread a chain through rcb_add (csrc/ec.cuh), the
//   one-thread body of K2 before its redesign, in blocks of 128 threads;
// pcd_chain_group: one group of CHAIN_G lanes a chain through K2's group
//   add (csrc/ec_group.cuh), R in the output row, in blocks of
//   CHAIN_THREADS.
#include "complete_add.cu"

#ifndef CHAIN_G
#define CHAIN_G 3
#endif
#define CHAIN_THREADS 128
constexpr int CHAIN_NGRP = CHAIN_THREADS / 32 * (32 / CHAIN_G);

template <int D>
__global__ void __launch_bounds__(128)
chain_one_kernel(const uint32_t* __restrict__ pts, uint32_t* out, int n,
                 int N, FieldConsts k) {
  const long g = (long)blockIdx.x * 128 + threadIdx.x;
  if (g >= n) return;
  Pt<D> P, R;
  pt_load<D>(P, pts + g * 3 * D * NL);
  R = P;
  for (int i = 0; i < N; ++i) {
    Pt<D> r;
    rcb_add<D>(r, R, P, k);
    R = r;
  }
  pt_store<D>(out + g * 3 * D * NL, R);
}

template <int D, bool SMALL>
__global__ void __launch_bounds__(CHAIN_THREADS)
chain_group_kernel(const uint32_t* __restrict__ pts, uint32_t* out, int n,
                   int N, FieldConsts k, SmallA sa) {
  constexpr int PW = 3 * D * NL;
  extern __shared__ __align__(16) uint32_t ch_slots[];
  const GrpLane<CHAIN_G> g;
  const long row = (long)blockIdx.x * g.ngrp + g.grp;
  if (g.idle || row >= n) return;
  uint32_t* S = ch_slots + g.grp * (GrpSlots<false>::N * D * NL);
  for (int x = g.lane; x < PW; x += CHAIN_G)
    out[row * PW + x] = pts[row * PW + x];
  __syncwarp(g.mask);
  const GrpRow w{out + row * PW, pts + row * PW, out + row * PW, false};
  for (int i = 0; i < N; ++i)
    grp_add_row<D, CHAIN_G, SMALL, false>(g.lane, g.mask, S, w, k, sa);
}

// pts, out (n, 3, D, NL) u32: out = (N + 1) pts, one add at a time
extern "C" int pcd_chain_one(int D, const void* pts, void* out, int n, int N,
                             const void* consts, void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int grid = (n + 127) / 128;
  const uint32_t* p = static_cast<const uint32_t*>(pts);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (D) {
    case 1: chain_one_kernel<1><<<grid, 128, 0, s>>>(p, o, n, N, k); break;
    case 2: chain_one_kernel<2><<<grid, 128, 0, s>>>(p, o, n, N, k); break;
    case 3: chain_one_kernel<3><<<grid, 128, 0, s>>>(p, o, n, N, k); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int D, bool SMALL>
static int chain_group(const uint32_t* p, uint32_t* o, int n, int N,
                       const FieldConsts& k, const SmallA& sa,
                       cudaStream_t s) {
  auto kern = chain_group_kernel<D, SMALL>;
  const size_t smem = (size_t)CHAIN_NGRP * GrpSlots<false>::N * D * NL * 4;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int grid = (n + CHAIN_NGRP - 1) / CHAIN_NGRP;
  kern<<<grid, CHAIN_THREADS, smem, s>>>(p, o, n, N, k, sa);
  return (int)cudaGetLastError();
}

extern "C" int pcd_chain_group(int D, const void* pts, void* out, int n,
                               int N, const void* consts, const void* small,
                               void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  const SmallA sa = *reinterpret_cast<const SmallA*>(small);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(pts);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (D * 2 + (sa.on ? 1 : 0)) {
    case 2: return chain_group<1, false>(p, o, n, N, k, sa, s);
    case 3: return chain_group<1, true>(p, o, n, N, k, sa, s);
    case 4: return chain_group<2, false>(p, o, n, N, k, sa, s);
    case 5: return chain_group<2, true>(p, o, n, N, k, sa, s);
    case 6: return chain_group<3, false>(p, o, n, N, k, sa, s);
    case 7: return chain_group<3, true>(p, o, n, N, k, sa, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
