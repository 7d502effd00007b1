// K3: elementwise masked mixed addition, madd<D>.
//
// Replaces the Pallas kernel EC32Ctx.madd -> _madd_pallas_T
// (pcd_tpu/ops/ec32.py:527-630): acc[i] += (x2[i], y2[i]) row by row,
// with Q's Y negated where sign[i] is set, and the old acc kept where
// active[i] is clear.  As in K1 (and the reference's pad-limb flag,
// ec32.py:200-208), a table row whose infinity flag (bit 31 of X's top
// limb) is set leaves its acc unchanged.  The reference aliases acc to
// the output; here too the rows of acc are updated in place, and nothing
// is written for a row that is kept.  EC32Ctx is G1 only, so the entry
// point instantiates D = 1.
//
// Bound: operations.  One mixed add is 17 field products (17 x 210
// 32x32-bit partial products at D = 1) against 120 bytes of acc read and
// written, 80 bytes of Q and 8 bytes of flags per row.  As K2 (csrc/
// complete_add.cu), each add runs in three rounds (csrc/ec_group.cuh) on
// a group of K3_G lanes, its values between rounds in the group's slots
// in shared memory: about 2,480 partial products at D = 1 for the MNT
// curves.  Inactive and flagged rows are scattered, so one add a
// thread pays for a full add in almost every warp; here each block takes
// an even share of the rows, K3_TILE at a time: a ballot and a prefix
// count over the warps list the tile's active, unflagged rows in index
// order in shared memory, and the block's groups take the list in turn,
// so no group spends an add on a row it keeps.
#include "ec_group.cuh"

// lanes an add, block and minimum resident blocks (K3S, csrc/
// ec_group.cuh); rows a block lists at once: K3_TILE
constexpr int K3_G = K3S.g, K3_THREADS = K3S.threads, K3_MINB = K3S.minb;

constexpr int K3_NGRP = K3_THREADS / 32 * (32 / K3_G);

template <int D, bool SMALL>
__global__ void __launch_bounds__(K3_THREADS, K3_MINB)
madd_kernel(uint32_t* acc, const uint32_t* __restrict__ q,
            const int32_t* __restrict__ sign,
            const int32_t* __restrict__ active, long n, long rows_per_block,
            FieldConsts k, SmallA sa) {
  constexpr int PW = 3 * D * NL, QW = 2 * D * NL, NW = K3_THREADS / 32;
  extern __shared__ __align__(16) uint32_t k3_slots[];
  __shared__ int s_list[K3_TILE];
  __shared__ int s_warp[NW];
  const GrpLane<K3_G> g;
  const int t = threadIdx.x, wl = t & 31, wid = t >> 5;
  uint32_t* S = k3_slots + g.grp * (GrpSlots<true>::N * D * NL);
  const long r0 = (long)blockIdx.x * rows_per_block;
  const long r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  for (long base = r0; base < r1; base += K3_TILE) {
    // list the tile's live rows (offsets from base) in index order
    int len = 0;
    for (int s = 0; s < K3_TILE && base + s < r1; s += K3_THREADS) {
      const long i = base + s + t;
      const bool live = i < r1 && active[i] &&
                        !(q[i * QW + NL - 1] & 0x80000000u);
      const unsigned b = __ballot_sync(0xffffffffu, live);
      if (wl == 0) s_warp[wid] = __popc(b);
      __syncthreads();
      int pre = len, tot = 0;
#pragma unroll
      for (int v = 0; v < NW; ++v) {
        pre += v < wid ? s_warp[v] : 0;
        tot += s_warp[v];
      }
      if (live) s_list[pre + __popc(b & ((1u << wl) - 1))] = s + t;
      len += tot;
      __syncthreads();
    }
    if (!g.idle)
      for (int e = g.grp; e < len; e += g.ngrp) {
        const long i = base + s_list[e];
        const GrpRow w{acc + i * PW, q + i * QW, acc + i * PW, sign[i] != 0};
        grp_add_row<D, K3_G, SMALL, true>(g.lane, g.mask, S, w, k, sa);
      }
    __syncthreads();            // the list is read before the next tile's
  }
}

template <int D>
static size_t k3_smem() {
  return (size_t)K3_NGRP * GrpSlots<true>::N * D * NL * 4;
}

template <int D, bool SMALL>
static int k3_launch(uint32_t* acc, const uint32_t* q, const int32_t* sign,
                     const int32_t* active, long n, const FieldConsts& k,
                     const SmallA& sa, cudaStream_t s) {
  auto kern = madd_kernel<D, SMALL>;
  const size_t smem = k3_smem<D>();
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    attr = true;
  }
  long rows;
  const int grid = grp_grid(kern, K3_THREADS, smem, n, K3_NGRP, &rows);
  kern<<<grid, K3_THREADS, smem, s>>>(acc, q, sign, active, n, rows, k, sa);
  return (int)cudaGetLastError();
}

// acc (n, 3, D, NL) u32, updated in place; q (n, 2, D, NL) u32 affine
// rows; sign, active (n,) i32; consts points to a host FieldConsts, small
// to a host SmallA; stream is a cudaStream_t.  Returns cudaGetLastError.
extern "C" int pcd_madd(int D, void* acc, const void* q, const void* sign,
                        const void* active, long n, const void* consts,
                        const void* small, void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  const SmallA sa = *reinterpret_cast<const SmallA*>(small);
  if (n <= 0) return 0;
  if (D != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  uint32_t* a = static_cast<uint32_t*>(acc);
  const uint32_t* qq = static_cast<const uint32_t*>(q);
  const int32_t* sg = static_cast<const int32_t*>(sign);
  const int32_t* ac = static_cast<const int32_t*>(active);
  return sa.on ? k3_launch<1, true>(a, qq, sg, ac, n, k, sa, s)
               : k3_launch<1, false>(a, qq, sg, ac, n, k, sa, s);
}

template <int D, bool SMALL>
static int k3_info(int* out) {
  auto kern = madd_kernel<D, SMALL>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)k3_smem<D>());
  int per = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, K3_THREADS,
                                                    k3_smem<D>());
  out[0] = K3_G;
  out[1] = K3_THREADS;
  out[2] = K3_MINB;
  out[3] = per;
  out[4] = a.numRegs;
  out[5] = (int)a.localSizeBytes;
  out[6] = (int)(k3_smem<D>() + a.sharedSizeBytes);
  out[7] = K3_TILE;
  return (int)e;
}

// out[8]: group size, threads a block, minimum blocks, resident blocks
// per SM, registers, local bytes a thread, shared bytes a block, rows a
// block lists at once, of the instantiation for small (0 or 1); D = 1.
extern "C" int pcd_madd_info(int D, int small, int* out) {
  if (D != 1) return (int)cudaErrorInvalidValue;
  return small ? k3_info<1, true>(out) : k3_info<1, false>(out);
}
