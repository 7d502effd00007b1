// The two-launch variant of the device scheduler's P2 placement, for
// kernel_ab.py --sched: csrc/sched_place.cu's one launch against the
// design that keeps p2_buckets' split but spreads it over several blocks
// a window.  Built by kernel_ab.py beside this tree's kernels:
//
//   nvcc <NVCC_FLAGS> -I pcd_tpu_torch/csrc -o p2split.so kernel_ab_p2split.cu
//
//   split_lanes  over (lane tiles x active windows), as p2_place: each
//                block its window's scans (p2_scan), its share of bidx,
//                and each of its lanes' load, run remainder, round-0 rank
//                and stride, the last two to memory (lanes, 8 bytes a
//                lane);
//   split_rows   one thread a lane: the lane's rank and stride read back,
//                then perm's rows from order (the sign already in bit 31).
// The same outputs as pcd_p2_place, which kernel_ab.py checks.
#include "sched_place.cu"

__global__ void __launch_bounds__(P2_THREADS)
split_lanes_kernel(const int32_t* __restrict__ counts, int K, P2Wins act,
                   int nact, int B, int T, int L, int32_t* __restrict__ bidx,
                   int32_t* __restrict__ loads, int32_t* __restrict__ runrem,
                   int2* __restrict__ lanes) {
  extern __shared__ int32_t sm[];
  int32_t* starts = sm;
  int32_t* off = sm + B + 1;
  __shared__ long long part[P2_WARPS];
  const int i = blockIdx.y;
  const int32_t* cw = counts + (long)act.w[i] * K;
  p2_scan(cw, B, T, starts, off, part);
  const int share = (B + gridDim.x - 1) / gridDim.x;
  const int s0 = min(B, (int)blockIdx.x * share), s1 = min(B, s0 + share);
  int32_t* bw = bidx + (long)i * B;
  for (int b = s0 + threadIdx.x; b < s1; b += P2_THREADS)
    bw[b] = starts[b + 1] > starts[b] ? starts[b] + i * L : nact * L;
  const int lane = blockIdx.x * P2_THREADS + threadIdx.x;
  if (lane >= L) return;
  const long row = (long)i * L + lane;
  int ld = 0, rem = 0;
  int2 rs = make_int2(0, 0);
  if (lane < starts[B]) {
    int lo = 0, hi = B;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (starts[mid] <= lane) lo = mid; else hi = mid;
    }
    const int st = starts[lo], lb = starts[lo + 1] - st;
    const int j = lane - st;
    const int of = off[lo], cz = off[lo + 1] - of;
    ld = (cz - j + lb - 1) / lb;
    rem = lb - j;
    rs = make_int2(of + j, lb);
  }
  loads[row] = ld;
  runrem[row] = rem;
  lanes[row] = rs;
}

__global__ void __launch_bounds__(P2_THREADS)
split_rows_kernel(const int32_t* __restrict__ order, long n, P2Wins act,
                  int T, int L, const int32_t* __restrict__ loads,
                  const int2* __restrict__ lanes,
                  uint32_t* __restrict__ perm) {
  const int lane = blockIdx.x * P2_THREADS + threadIdx.x;
  if (lane >= L) return;
  const int i = blockIdx.y;
  const int32_t* ow = order + (long)act.w[i] * n;
  const int ld = loads[(long)i * L + lane];
  const int2 rs = lanes[(long)i * L + lane];
  uint32_t* out = perm + (long)i * T * L + lane;
#pragma unroll 4
  for (int t = 0; t < T; ++t)
    out[(long)t * L] = t < ld ? (uint32_t)ow[rs.x + (long)t * rs.y] : 0u;
}

// pcd_p2_place's arguments and a (nact, L) int2 scratch for the lanes'
// ranks and strides.  Returns cudaGetLastError.
extern "C" int pcd_p2_split(const void* order, const void* counts, int nwin,
                            long n, int K, const int* act, int nact, int B,
                            int T, int L, void* perm, void* loads, void* bidx,
                            void* runrem, void* lanes, void* stream) {
  P2Wins w;
  if (n < 1 || B < 2 || B > P2_MAX_B || (B & (B - 1)) || K < B + 1 ||
      T < 1 || L < 1 || !wins(act, nact, nwin, &w))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(B + 1) * 2 * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        (const void*)split_lanes_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid((unsigned)((L + P2_THREADS - 1) / P2_THREADS),
                  (unsigned)nact);
  split_lanes_kernel<<<grid, P2_THREADS, smem, as_stream(stream)>>>(
      static_cast<const int32_t*>(counts), K, w, nact, B, T, L,
      static_cast<int32_t*>(bidx), static_cast<int32_t*>(loads),
      static_cast<int32_t*>(runrem), static_cast<int2*>(lanes));
  split_rows_kernel<<<grid, P2_THREADS, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(order), n, w, T, L,
      static_cast<const int32_t*>(loads), static_cast<const int2*>(lanes),
      static_cast<uint32_t*>(perm));
  return (int)cudaGetLastError();
}
