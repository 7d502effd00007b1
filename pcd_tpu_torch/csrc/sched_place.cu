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
// searchsorted over starts.  One launch, p2_place, on the schedule stream
// after p1_scatter, over (lane tiles of P2_THREADS lanes x active
// windows):
//   scan   each block rebuilds its window's scans from the window's B + 1
//          counts (read from L2: every block of a window reads the same
//          row), (lanes, count) packed in one 64-bit sum, into starts and
//          off in shared memory, with their ends at index B;
//   bidx   the block's even share of the window's B buckets: each
//          bucket's first lane as a global lane over the active windows,
//          sentinel nact * L on an empty bucket;
//   lanes  one thread a lane: its bucket by a binary search of starts (the
//          last bucket starting at or before it: every lane the same
//          log2 B steps, where a bucket-major fill would leave a
//          one-bucket window's lanes to one thread), its load and run
//          remainder, then for t < T perm[i, t, lane] = order's entry of
//          sorted rank rank0 + t * lanes_b, or 0 from the lane's load on.
//          The stores go along L, so a warp's are coalesced, and the
//          lanes of one bucket read adjacent entries of order.
// P1's scatter carries each scalar's digit sign in bit 31 of order, the
// layout perm wants, so the entry is stored as it is read: P2 reads no
// signs.  Each lane's bucket, rank and stride stay in registers, and
// there is no second launch.
//
// The active windows reach the kernel as a by-value parameter (at most
// P2_MAX_WIN), so the schedule copies nothing to the card after its one
// histogram fetch.
//
// Bound: bytes.  perm (nact T L words) is written whole, loads, runrem
// and bidx once, the active windows' counts read once, and each placed
// entry reads one word of order, against a few integer operations an
// entry; the blocks' re-reads of a window's counts are the design's own
// traffic (L2).
#include <cstdint>

#include <cuda_runtime.h>

constexpr int P2_THREADS = 256;          // lanes a block, one a thread
constexpr int P2_WARPS = P2_THREADS / 32;
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

// The window's scans into shared memory: starts[b] (lanes before bucket
// b) and off[b] (sorted rank of its first point) for b <= B.  The counts
// are staged in starts by coalesced loads, and each thread scans a run of
// them (read before it overwrites them).
__device__ __forceinline__ void p2_scan(const int32_t* __restrict__ cw,
                                        int B, int T, int32_t* starts,
                                        int32_t* off, long long* part) {
  for (int b = threadIdx.x; b < B; b += P2_THREADS) starts[b] = cw[1 + b];
  __syncthreads();
  const int per = (B + P2_THREADS - 1) / P2_THREADS;
  const int b0 = min(B, (int)threadIdx.x * per), b1 = min(B, b0 + per);
  long long sums = 0;                    // lanes << 32 | count
  for (int b = b0; b < b1; ++b) {
    const int c = starts[b];
    sums += ((long long)((c + T - 1) / T) << 32) + c;
  }
  const long long first = block_exclusive(sums, part);
  int lrun = (int)(first >> 32);
  int crun = cw[0] + (int)(first & 0xFFFFFFFFll);
  for (int b = b0; b < b1; ++b) {
    const int c = starts[b];
    starts[b] = lrun;
    off[b] = crun;
    lrun += (c + T - 1) / T;
    crun += c;
  }
  if (threadIdx.x == P2_THREADS - 1) {
    const long long all = first + sums;
    starts[B] = (int)(all >> 32);
    off[B] = cw[0] + (int)(all & 0xFFFFFFFFll);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(P2_THREADS)
p2_place_kernel(const int32_t* __restrict__ order,
                const int32_t* __restrict__ counts, int K, long n, P2Wins act,
                int nact, int B, int T, int L, uint32_t* __restrict__ perm,
                int32_t* __restrict__ loads, int32_t* __restrict__ bidx,
                int32_t* __restrict__ runrem) {
  extern __shared__ int32_t sm[];
  int32_t* starts = sm;                  // B + 1: starts[B] = lanes used
  int32_t* off = sm + B + 1;             // B + 1: off[B] = the last rank + 1
  __shared__ long long part[P2_WARPS];
  const int i = blockIdx.y;
  const long w = act.w[i];
  const int32_t* cw = counts + w * K;
  p2_scan(cw, B, T, starts, off, part);
  // this block's share of bidx
  const int share = (B + gridDim.x - 1) / gridDim.x;
  const int s0 = min(B, (int)blockIdx.x * share), s1 = min(B, s0 + share);
  int32_t* bw = bidx + (long)i * B;
  for (int b = s0 + threadIdx.x; b < s1; b += P2_THREADS)
    bw[b] = starts[b + 1] > starts[b] ? starts[b] + i * L : nact * L;
  const int lane = blockIdx.x * P2_THREADS + threadIdx.x;
  if (lane >= L) return;
  const int used = starts[B];
  const long row = (long)i * L + lane;
  int ld = 0, rank0 = 0, stride = 0, rem = 0;
  if (lane < used) {
    int lo = 0, hi = B;                  // the last bucket starting <= lane
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (starts[mid] <= lane) lo = mid; else hi = mid;
    }
    const int st = starts[lo], lb = starts[lo + 1] - st;
    const int j = lane - st;
    const int of = off[lo], cz = off[lo + 1] - of;
    ld = (cz - j + lb - 1) / lb;
    rem = lb - j;
    rank0 = of + j;
    stride = lb;
  }
  loads[row] = ld;
  runrem[row] = rem;
  const int32_t* ow = order + w * n;
  uint32_t* out = perm + (long)i * T * L + lane;
#pragma unroll 4
  for (int t = 0; t < T; ++t)
    out[(long)t * L] = t < ld ? (uint32_t)ow[rank0 + (long)t * stride] : 0u;
}

namespace {

cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

// The active windows as the kernel's parameter; false when out of range.
bool wins(const int* act, int nact, int nwin, P2Wins* out) {
  if (nact <= 0 || nact > P2_MAX_WIN) return false;
  for (int i = 0; i < nact; ++i) {
    if (act[i] < 0 || act[i] >= nwin) return false;
    out->w[i] = act[i];
  }
  return true;
}

}  // namespace

// order (nwin, n) i32 (P1's, the digit sign in bit 31), counts (nwin, K)
// i32 (P1's histogram, K >= B + 1), the active windows act[nact] and the
// round count T -> perm (nact, T, L) u32 (the row of each round of each
// lane with its sign in bit 31, 0 past the lane's load), loads (nact, L),
// bidx (nact, B) and runrem (nact, L) i32.  Returns cudaGetLastError.
extern "C" int pcd_p2_place(const void* order, const void* counts, int nwin,
                            long n, int K, const int* act, int nact, int B,
                            int T, int L, void* perm, void* loads, void* bidx,
                            void* runrem, void* stream) {
  P2Wins w;
  if (n < 1 || B < 2 || B > P2_MAX_B || (B & (B - 1)) || K < B + 1 ||
      T < 1 || L < 1 || !wins(act, nact, nwin, &w))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(B + 1) * 2 * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        (const void*)p2_place_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid((unsigned)((L + P2_THREADS - 1) / P2_THREADS),
                  (unsigned)nact);
  p2_place_kernel<<<grid, P2_THREADS, smem, as_stream(stream)>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(counts),
      K, n, w, nact, B, T, L, static_cast<uint32_t*>(perm),
      static_cast<int32_t*>(loads), static_cast<int32_t*>(bidx),
      static_cast<int32_t*>(runrem));
  return (int)cudaGetLastError();
}
