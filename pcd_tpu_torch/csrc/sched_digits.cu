// The device scheduler's P1: signed digits, a stable counting sort of each
// window's scalars by digit magnitude, and the histogram.
//
// Replaces the XLA program of DevSchedMSM._p1 (pcd_tpu/ops/msm_stream_dev.py:
// 67-118), which has no Pallas site: the c-bit windows of every scalar
// recoded to signed digits in [-2^(c-1), 2^(c-1)) by a carry that runs from
// the lowest window to the highest (80-110), a stable argsort of each
// window's magnitudes (112) and a search of the sorted keys for the
// histogram (116).  The keys are magnitudes in [0, B + 1], K = B + 2 bins
// (2,050 at c = 12), so one counting pass orders them, and the histogram is
// its first step.  Four launches, each on its own grid:
//
//   p1_digits   one thread a scalar, the block's rows staged through shared
//               memory by coalesced loads; the carry stays in a register
//               while the thread walks every window.  Writes magnitudes as
//               u16 and signs as i8, window-major (nwin, n).  The top window
//               absorbs the carry unsigned when the context has no carry
//               window; a digit there above B (a scalar wider than
//               scalar_bits) is written as B + 1, the overflow bin that the
//               histogram fetch checks.
//   p1_hist     one block a (tile of P1_TILE = 8,192 scalars, window): the
//               tile's histogram in shared memory, written to hist (nwin,
//               ntiles, K); a warp's keys equal to its first lane's go in
//               one atomic add (a window whose digits are all zero is the
//               common case).
//   p1_scan     one thread a (bin, window): the bin's total over the tiles
//               (the counts row) and, over hist in place, each tile's count
//               of the bin's keys in the earlier tiles.
//   p1_scatter  one block a (tile, window), P1_WARPS warps, each owning a
//               contiguous segment of the tile, the tile's keys staged in
//               shared memory: per-warp bin counts, then each warp's first
//               local place in each bin (a scan over the bins and the
//               warps in index order; the window's bin starts by a scan of
//               the counts row), then each warp walks its segment 32 keys
//               at a time, ranks every key among its equal peers of lower
//               lanes (one ballot per key bit: __match_any_sync's cost
//               grows with the distinct keys of a warp, and dense digits
//               are nearly all distinct) and stages the scalar's index at
//               its local place; the tile then goes out in local order, so
//               each bin's keys are written to consecutive slots.  The
//               digit's sign rides in bit 15 of the staged key (keys are
//               below 2^14), loaded beside the magnitude, and goes out in
//               bit 31 of the index: the perm entry P2 stores as it is.
//
// Stable and deterministic: a key's slot is its bin's start + the keys of
// its bin in earlier tiles, earlier warps of its tile, earlier rounds of
// its warp and lower lanes of its round.  Atomics only count.
//
// Bound: bytes.  4 * nwords read and (4 + 1) * nwin written (order, signs)
// per scalar, plus the counts, against a few integer operations per key.
// (The signs are written by p1_digits and read back by p1_scatter, the
// design's own traffic, so that P2 reads none.)
// The u16 magnitudes and the tile histograms are the design's own traffic.
#include <cstdint>

#include <cuda_runtime.h>

constexpr int P1_THREADS = 256;          // every P1 block
constexpr int P1_WARPS = P1_THREADS / 32;
constexpr int P1_TILE = 8192;            // scalars a hist or scatter block
static_assert(P1_TILE % P1_THREADS == 0 && P1_TILE <= 32768,
              "a tile is whole warp segments; local places are u16");
constexpr int P1_SCAN_RUN = 16;          // tiles a p1_scan thread loads at once
constexpr int P1_MAX_NWORDS = 32;
constexpr uint32_t P1_NO_KEY = 0xFFFFu;  // past the end: above every bin
constexpr int P1_KEY_BITS = 14;          // K <= 8,194: every key below 2^14
constexpr uint32_t P1_SIGN = 0x8000u;    // a staged key's sign bit

// The lanes whose key equals this lane's, by one ballot per key bit; the
// ballots are independent of each other, so unrolled they issue back to
// back.
__device__ __forceinline__ unsigned peers_of(uint32_t key) {
  unsigned m = 0xFFFFFFFFu;
#pragma unroll
  for (int i = 0; i < P1_KEY_BITS; ++i) {
    const unsigned bit = (key >> i) & 1u;
    const unsigned b = __ballot_sync(0xFFFFFFFFu, bit);
    m &= b ^ (bit - 1u);                 // b where the bit is set, else ~b
  }
  return m;
}

__global__ void __launch_bounds__(P1_THREADS)
p1_digits_kernel(const uint32_t* __restrict__ W, long n, int nwords, int c,
                 int base, int carry_win, int B, uint16_t* __restrict__ mags,
                 int8_t* __restrict__ signs) {
  extern __shared__ uint32_t rows[];     // P1_THREADS x nwords
  const long i0 = (long)blockIdx.x * P1_THREADS;
  const int cnt = (int)min((long)P1_THREADS, n - i0);
  const uint32_t* src = W + i0 * nwords;
  for (int k = threadIdx.x; k < cnt * nwords; k += P1_THREADS)
    rows[k] = src[k];
  __syncthreads();
  if ((int)threadIdx.x >= cnt) return;
  const uint32_t* row = rows + threadIdx.x * nwords;
  const long i = i0 + threadIdx.x;
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
      mags[o] = (uint16_t)(d > B ? B + 1 : d);
      signs[o] = 0;
      return;
    }
    carry = d >= half;
    d -= carry * full;
    signs[o] = d < 0;
    mags[o] = (uint16_t)(d < 0 ? -d : d);
  }
  mags[(long)base * n + i] = (uint16_t)carry;
  signs[(long)base * n + i] = 0;
}

__global__ void __launch_bounds__(P1_THREADS)
p1_hist_kernel(const uint16_t* __restrict__ mags, long n, int K,
               int32_t* __restrict__ hist) {
  extern __shared__ uint32_t h[];        // K
  const int w = blockIdx.y, t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < K; b += P1_THREADS) h[b] = 0;
  __syncthreads();
  const uint16_t* row = mags + (long)w * n;
  const long lo = (long)t * P1_TILE, hi = min(n, lo + P1_TILE);
  for (long at = lo; at < hi; at += P1_THREADS) {   // uniform in the block
    const long j = at + threadIdx.x;
    const bool ok = j < hi;
    const uint32_t key = ok ? row[j] : P1_NO_KEY;
    const uint32_t k0 = __shfl_sync(0xFFFFFFFFu, key, 0);
    const unsigned same = __ballot_sync(0xFFFFFFFFu, key == k0);
    if (!ok) continue;
    if (key != k0)
      atomicAdd(&h[key], 1u);
    else if (lane == __ffs(same) - 1)
      atomicAdd(&h[key], (unsigned)__popc(same));
  }
  __syncthreads();
  int32_t* out = hist + ((long)w * gridDim.x + t) * K;
  for (int b = threadIdx.x; b < K; b += P1_THREADS) out[b] = (int32_t)h[b];
}

__global__ void __launch_bounds__(P1_THREADS)
p1_scan_kernel(int32_t* __restrict__ hist, int ntiles, int K,
               int32_t* __restrict__ counts) {
  const int w = blockIdx.y;
  const int b = blockIdx.x * P1_THREADS + threadIdx.x;
  if (b >= K) return;
  int32_t* col = hist + (long)w * ntiles * K + b;
  int32_t at = 0;
  for (int t0 = 0; t0 < ntiles; t0 += P1_SCAN_RUN) {  // loads, then stores
    int32_t v[P1_SCAN_RUN];
#pragma unroll
    for (int i = 0; i < P1_SCAN_RUN; ++i)
      v[i] = t0 + i < ntiles ? col[(long)(t0 + i) * K] : 0;
#pragma unroll
    for (int i = 0; i < P1_SCAN_RUN; ++i)
      if (t0 + i < ntiles) {
        col[(long)(t0 + i) * K] = at;
        at += v[i];
      }
  }
  counts[(long)w * K + b] = at;
}

// Exclusive scan of one 64-bit value a thread over the block.
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

__global__ void __launch_bounds__(P1_THREADS)
p1_scatter_kernel(const uint16_t* __restrict__ mags,
                  const int8_t* __restrict__ signs, long n, int K,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ counts,
                  int32_t* __restrict__ order) {
  extern __shared__ int32_t sm[];
  const int K4 = (K + 3) & ~3;               // 16-byte aligned regions
  int32_t* delta = sm;                       // K: order slot - local place
  uint16_t* keys = reinterpret_cast<uint16_t*>(sm + K4);        // tile
  uint16_t* stage = keys + P1_TILE;          // tile: indices in local order
  uint16_t* slot = stage + P1_TILE;          // P1_WARPS x K local places
  __shared__ long long part[P1_WARPS];
  const int w = blockIdx.y, t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long t0 = (long)t * P1_TILE;
  const int cnt = (int)min((long)P1_TILE, n - t0);
  const uint16_t* row = mags + (long)w * n + t0;
  const int8_t* srow = signs + (long)w * n + t0;
  // stage the keys with their signs, four a thread where both rows are
  // aligned for it (8-byte magnitudes, 4-byte signs), the rest one a
  // thread
  int head = 0;
  if (!((uintptr_t)row & 7) && !((uintptr_t)srow & 3)) {
    head = cnt & ~3;
    const uint2* r4 = reinterpret_cast<const uint2*>(row);
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(srow);
    uint2* k4 = reinterpret_cast<uint2*>(keys);
    for (int q = threadIdx.x; q < head / 4; q += P1_THREADS) {
      const uint2 m = r4[q];
      const uint32_t sg = s4[q];
      const uint32_t b0 = (sg & 0xFFu) ? P1_SIGN : 0u;
      const uint32_t b1 = (sg & 0xFF00u) ? P1_SIGN << 16 : 0u;
      const uint32_t b2 = (sg & 0xFF0000u) ? P1_SIGN : 0u;
      const uint32_t b3 = (sg & 0xFF000000u) ? P1_SIGN << 16 : 0u;
      k4[q] = make_uint2(m.x | b0 | b1, m.y | b2 | b3);
    }
  }
  for (int i = head + threadIdx.x; i < cnt; i += P1_THREADS)
    keys[i] = row[i] | (srow[i] ? P1_SIGN : 0u);
  uint4* slot16 = reinterpret_cast<uint4*>(slot);
  for (int b = threadIdx.x; b < P1_WARPS * K4 / 8; b += P1_THREADS)
    slot16[b] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int seg = P1_TILE / P1_WARPS;
  const int lo = warp * seg, hi = min(cnt, lo + seg);
  uint16_t* mine = slot + warp * K;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t none = (1u << (32 - __clz(K))) - 1u;   // >= K: no bin
  // this warp's bin counts, two u16 a word; the keys equal to the first
  // lane's in one add
  unsigned* words = reinterpret_cast<unsigned*>(slot);
  for (int at = lo; at < hi; at += 32) {                       // warp-uniform
    const int j = at + lane;
    const bool ok = j < hi;
    const uint32_t key = ok ? keys[j] & ~P1_SIGN : none;
    const uint32_t k0 = __shfl_sync(0xFFFFFFFFu, key, 0);
    const unsigned same = __ballot_sync(0xFFFFFFFFu, key == k0);
    if (ok && (key != k0 || lane == __ffs(same) - 1)) {
      const int at16 = warp * K + (int)key;
      atomicAdd(&words[at16 >> 1], (key == k0 ? (unsigned)__popc(same) : 1u)
                                       << ((at16 & 1) * 16));
    }
  }
  __syncthreads();
  // this thread's bins [b0, b1): each warp's first local place in each bin
  // (the tile's keys of lower bins, then of the bin in earlier warps), and
  // delta = the bin's first order slot (the window's keys of lower bins,
  // then the bin's keys in earlier tiles) - its first local place
  const int per = (K + P1_THREADS - 1) / P1_THREADS;
  const int b0 = min(K, (int)threadIdx.x * per), b1 = min(K, b0 + per);
  const int32_t* cw = counts + (long)w * K;
  long long sums = 0;                          // window count << 32 | tile's
  for (int b = b0; b < b1; ++b) {
    int tc = 0;
    for (int q = 0; q < P1_WARPS; ++q) tc += slot[q * K + b];
    sums += ((long long)cw[b] << 32) + tc;
  }
  const long long first = block_exclusive(sums, part);
  long long lrun = first & 0xFFFFFFFFll, grun = first >> 32;
  const int32_t* st = starts + ((long)w * gridDim.x + t) * K;
  for (int b = b0; b < b1; ++b) {
    delta[b] = (int32_t)(grun + st[b] - lrun);
    for (int q = 0; q < P1_WARPS; ++q) {
      const int v = slot[q * K + b];
      slot[q * K + b] = (uint16_t)lrun;
      lrun += v;
    }
    grun += cw[b];
  }
  __syncthreads();
  // rank each key among its equal peers of lower lanes; its local place
  for (int at = lo; at < hi; at += 32) {
    const int j = at + lane;
    const bool ok = j < hi;
    const uint32_t key = ok ? keys[j] & ~P1_SIGN : none;
    const unsigned peers = peers_of(key);
    unsigned place = 0;
    if (ok) {
      place = mine[key];
      stage[place + __popc(peers & below)] = (uint16_t)j;
    }
    __syncwarp();
    if (ok && !(peers & below)) mine[key] = (uint16_t)(place + __popc(peers));
    __syncwarp();
  }
  __syncthreads();
  // the tile in local order: a bin's keys go to consecutive slots, each
  // index with its sign in bit 31
  int32_t* out = order + (long)w * n;
#pragma unroll 4
  for (int p = threadIdx.x; p < cnt; p += P1_THREADS) {
    const int j = stage[p];
    const uint32_t key = keys[j];
    out[p + delta[key & ~P1_SIGN]] =
        (int32_t)((uint32_t)(t0 + j) | (key & P1_SIGN) << 16);
  }
}

namespace {

cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_bins(int K) { return K < 3 || K > (1 << 13) + 2; }

unsigned tiles(long n) { return (unsigned)((n + P1_TILE - 1) / P1_TILE); }

}  // namespace

// The tile and the warps of a hist or scatter block; the wrappers size
// hist by the tile, and the plain versions (ops/msm_stream_dev.py) split
// tiles into the same warp segments.
extern "C" int pcd_p1_tile() { return P1_TILE; }
extern "C" int pcd_p1_warps() { return P1_WARPS; }

// W (n, nwords) u32 little-endian scalar words -> mags (nwin, n) u16, signs
// (nwin, n) i8, nwin = base + carry_win.  Returns cudaGetLastError.
extern "C" int pcd_p1_digits(const void* W, long n, int nwords, int c,
                             int base, int carry_win, int B, void* mags,
                             void* signs, void* stream) {
  if (n <= 0 || nwords <= 0 || nwords > P1_MAX_NWORDS || c < 2 || c > 14 ||
      base <= 0 || B != 1 << (c - 1))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + P1_THREADS - 1) / P1_THREADS);
  p1_digits_kernel<<<grid, P1_THREADS, P1_THREADS * nwords * 4,
                     as_stream(stream)>>>(
      static_cast<const uint32_t*>(W), n, nwords, c, base, carry_win, B,
      static_cast<uint16_t*>(mags), static_cast<int8_t*>(signs));
  return (int)cudaGetLastError();
}

// mags (nwin, n) u16 in [0, K) -> hist (nwin, ceil(n / P1_TILE), K) i32,
// each tile's bin counts.
extern "C" int pcd_p1_hist(const void* mags, int nwin, long n, int K,
                           void* hist, void* stream) {
  if (n <= 0 || nwin <= 0 || bad_bins(K)) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles(n), (unsigned)nwin);
  p1_hist_kernel<<<grid, P1_THREADS, K * 4, as_stream(stream)>>>(
      static_cast<const uint16_t*>(mags), n, K,
      static_cast<int32_t*>(hist));
  return (int)cudaGetLastError();
}

// hist (nwin, ntiles, K) i32 tile counts -> in place each tile's count of
// each bin's keys in the earlier tiles; counts (nwin, K) i32 the bin totals.
extern "C" int pcd_p1_scan(void* hist, int nwin, int ntiles, int K,
                           void* counts, void* stream) {
  if (nwin <= 0 || ntiles <= 0 || bad_bins(K))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((K + P1_THREADS - 1) / P1_THREADS),
                  (unsigned)nwin);
  p1_scan_kernel<<<grid, P1_THREADS, 0, as_stream(stream)>>>(
      static_cast<int32_t*>(hist), ntiles, K, static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}

// mags (nwin, n) u16 and signs (nwin, n) i8 (p1_digits'), starts (nwin,
// ceil(n / P1_TILE), K) i32 and counts (nwin, K) i32 (p1_scan's) -> order
// (nwin, n) i32, each window's scalar indices stably sorted by magnitude,
// the digit's sign in bit 31.
extern "C" int pcd_p1_scatter(const void* mags, const void* signs, int nwin,
                              long n, int K, const void* starts,
                              const void* counts, void* order,
                              void* stream) {
  if (n <= 0 || nwin <= 0 || bad_bins(K)) return (int)cudaErrorInvalidValue;
  const size_t K4 = (size_t)(K + 3) & ~(size_t)3;
  const size_t smem = K4 * 4 + (size_t)P1_TILE * 4 + P1_WARPS * K4 * 2;
  const int rc = set_smem((const void*)p1_scatter_kernel, smem);
  if (rc) return rc;
  const dim3 grid(tiles(n), (unsigned)nwin);
  p1_scatter_kernel<<<grid, P1_THREADS, smem, as_stream(stream)>>>(
      static_cast<const uint16_t*>(mags), static_cast<const int8_t*>(signs),
      n, K, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(order));
  return (int)cudaGetLastError();
}
