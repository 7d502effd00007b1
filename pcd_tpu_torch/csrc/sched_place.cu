// The device scheduler's P2 placement: the schedule tensors K1 and K4 take,
// computed from P1's sorted order over the active windows.
//
// Replaces the placement of the XLA program DevSchedMSM._p2
// (pcd_tpu/ops/msm_stream_dev.py:171-196 and 227-229), which has no Pallas
// site: each bucket b of an active window gets lanes_b = ceil(count_b / T)
// contiguous lanes from starts_b (an exclusive scan of the lanes), its
// k-th point of sorted rank off_b + k (off_b: the window's zero digits plus
// an exclusive scan of the counts) goes to lane starts_b + k % lanes_b,
// round k / lanes_b; the reference finds each lane's bucket by a
// searchsorted over starts.  Two launches, both on the schedule stream
// after p1_scatter:
//
//   p2_buckets  one block a window: a block scan over the window's B
//               buckets, (lanes, count) packed in one 64-bit sum, gives
//               starts and off (with their ends at index B) in shared
//               memory and bidx (each bucket's first lane as a global
//               lane over the active windows, sentinel nact * L on an
//               empty bucket); then each thread takes lanes L / blockDim
//               apart and finds a lane's bucket by a binary search of
//               starts in shared memory (every lane the same eleven steps
//               at c = 12, where a bucket-major fill would leave a
//               one-bucket window's 8,192 lanes to one thread), writing
//               loads, runrem and the lane's round-0 rank and stride.
//   p2_place    one thread a lane over (L / P2_LANE_THREADS, nact): for
//               t < T, perm[i, t, lane] = the row of sorted rank
//               rank0 + t * stride, with its digit's sign in bit 31, and 0
//               from the lane's load on.  The stores go along L, so a
//               warp's are coalesced, and the lanes of one bucket read
//               adjacent entries of order; the sign is a gather.
//
// The active windows reach both kernels as a by-value parameter (at most
// P2_MAX_WIN), so the schedule copies nothing to the card after its one
// histogram fetch.
//
// Bound: bytes.  perm (nact T L words) is written whole and each live
// entry reads one word of order and one byte of signs, against a few
// integer operations an entry; the per-lane rank and stride (8 bytes a
// lane) are the design's own traffic.
#include <cstdint>

#include <cuda_runtime.h>

constexpr int P2_THREADS = 1024;         // p2_buckets: one block a window
constexpr int P2_WARPS = P2_THREADS / 32;
constexpr int P2_LANE_THREADS = 256;     // p2_place
constexpr int P2_MAX_WIN = 256;          // active windows (c = 2: 150)
constexpr int P2_MAX_B = 1 << 13;        // c <= 14, as P1

struct P2Wins {
  int32_t w[P2_MAX_WIN];
};

// Exclusive scan of one 64-bit value a thread over the block; `part`
// holds each warp's total.
__device__ __forceinline__ long long block_exclusive(long long v,
                                                     long long* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const long long u = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  long long before = 0;
  for (int q = 0; q < warp; ++q) before += part[q];
  return before + incl - v;
}

__global__ void __launch_bounds__(P2_THREADS)
p2_buckets_kernel(const int32_t* __restrict__ counts, int K, P2Wins act,
                  int nact, int B, int T, int L,
                  int32_t* __restrict__ bidx, int32_t* __restrict__ loads,
                  int32_t* __restrict__ runrem, int2* __restrict__ lanes) {
  extern __shared__ int32_t sm[];
  int32_t* starts = sm;                  // B + 1: starts[B] = lanes used
  int32_t* off = sm + B + 1;             // B + 1: off[B] = the last rank + 1
  __shared__ long long part[P2_WARPS];
  const int i = blockIdx.x;
  const int32_t* cw = counts + (long)act.w[i] * K;
  const int per = (B + P2_THREADS - 1) / P2_THREADS;
  const int b0 = min(B, (int)threadIdx.x * per), b1 = min(B, b0 + per);
  long long sums = 0;                    // lanes << 32 | count
  for (int b = b0; b < b1; ++b) {
    const int c = cw[1 + b];
    sums += ((long long)((c + T - 1) / T) << 32) + c;
  }
  const long long first = block_exclusive(sums, part);
  int lrun = (int)(first >> 32);
  int crun = cw[0] + (int)(first & 0xFFFFFFFFll);
  int32_t* bw = bidx + (long)i * B;
  for (int b = b0; b < b1; ++b) {
    const int c = cw[1 + b];
    starts[b] = lrun;
    off[b] = crun;
    bw[b] = c > 0 ? lrun + i * L : nact * L;
    lrun += (c + T - 1) / T;
    crun += c;
  }
  if (threadIdx.x == P2_THREADS - 1) {
    const long long all = first + sums;
    starts[B] = (int)(all >> 32);
    off[B] = cw[0] + (int)(all & 0xFFFFFFFFll);
  }
  __syncthreads();
  const int used = starts[B];
  const long row = (long)i * L;
  for (int lane = threadIdx.x; lane < L; lane += P2_THREADS) {
    if (lane >= used) {
      loads[row + lane] = 0;
      runrem[row + lane] = 0;
      lanes[row + lane] = make_int2(0, 0);
      continue;
    }
    int lo = 0, hi = B;                  // the last bucket starting <= lane
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (starts[mid] <= lane) lo = mid; else hi = mid;
    }
    const int st = starts[lo], lb = starts[lo + 1] - st;
    const int j = lane - st;
    const int of = off[lo], cz = off[lo + 1] - of;
    loads[row + lane] = (cz - j + lb - 1) / lb;
    runrem[row + lane] = lb - j;
    lanes[row + lane] = make_int2(of + j, lb);
  }
}

__global__ void __launch_bounds__(P2_LANE_THREADS)
p2_place_kernel(const int32_t* __restrict__ order,
                const int8_t* __restrict__ signs, long n, P2Wins act, int T,
                int L, const int32_t* __restrict__ loads,
                const int2* __restrict__ lanes, uint32_t* __restrict__ perm) {
  const int lane = blockIdx.x * P2_LANE_THREADS + threadIdx.x;
  if (lane >= L) return;
  const int i = blockIdx.y;
  const long w = act.w[i];
  const int32_t* ow = order + w * n;
  const int8_t* sw = signs + w * n;
  const int ld = loads[(long)i * L + lane];
  const int2 rs = lanes[(long)i * L + lane];
  uint32_t* out = perm + (long)i * T * L + lane;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    uint32_t v = 0;
    if (t < ld) {
      const int32_t p = ow[rs.x + (long)t * rs.y];
      v = (uint32_t)p | ((uint32_t)(sw[p] != 0) << 31);
    }
    out[(long)t * L] = v;
  }
}

namespace {

cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

// The active windows as the kernels' parameter; false when out of range.
bool wins(const int* act, int nact, int nwin, P2Wins* out) {
  if (nact <= 0 || nact > P2_MAX_WIN) return false;
  for (int i = 0; i < nact; ++i) {
    if (act[i] < 0 || act[i] >= nwin) return false;
    out->w[i] = act[i];
  }
  return true;
}

}  // namespace

// counts (nwin, K) i32 (P1's histogram, K >= B + 1), the active windows
// act[nact] and the round count T -> bidx (nact, B), loads (nact, L),
// runrem (nact, L) and lanes (nact, L, 2) i32: each lane's round-0 sorted
// rank and its bucket's lane count (0, 0 on an unused lane).  Returns
// cudaGetLastError.
extern "C" int pcd_p2_buckets(const void* counts, int nwin, int K,
                              const int* act, int nact, int B, int T, int L,
                              void* bidx, void* loads, void* runrem,
                              void* lanes, void* stream) {
  P2Wins w;
  if (B < 2 || B > P2_MAX_B || (B & (B - 1)) || K < B + 1 || T < 1 ||
      L < 1 || !wins(act, nact, nwin, &w))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(B + 1) * 2 * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        (const void*)p2_buckets_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  p2_buckets_kernel<<<nact, P2_THREADS, smem, as_stream(stream)>>>(
      static_cast<const int32_t*>(counts), K, w, nact, B, T, L,
      static_cast<int32_t*>(bidx), static_cast<int32_t*>(loads),
      static_cast<int32_t*>(runrem), static_cast<int2*>(lanes));
  return (int)cudaGetLastError();
}

// order (nwin, n) i32 and signs (nwin, n) i8 (P1's), the active windows,
// T, and p2_buckets' loads and lanes -> perm (nact, T, L) u32: the row of
// each round of each lane with its sign in bit 31, 0 past the lane's load.
extern "C" int pcd_p2_place(const void* order, const void* signs, int nwin,
                            long n, const int* act, int nact, int T, int L,
                            const void* loads, const void* lanes, void* perm,
                            void* stream) {
  P2Wins w;
  if (n < 1 || T < 1 || L < 1 || !wins(act, nact, nwin, &w))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((L + P2_LANE_THREADS - 1) / P2_LANE_THREADS),
                  (unsigned)nact);
  p2_place_kernel<<<grid, P2_LANE_THREADS, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(order), static_cast<const int8_t*>(signs),
      n, w, T, L, static_cast<const int32_t*>(loads),
      static_cast<const int2*>(lanes), static_cast<uint32_t*>(perm));
  return (int)cudaGetLastError();
}
