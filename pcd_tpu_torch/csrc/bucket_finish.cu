// K4: the stream-MSM finish, bucket_finish<D>: K1's lane accumulators to
// the window sums sum_b b S_b in one launch.
//
// Replaces the Pallas complete adds of the finish, EC32Ctx.add_cols and
// EC32ExtCtx.add_cols (pcd_tpu/ops/ec32.py:457-513, 1152-1222) and
// EC32Ctx.add / EC32ExtCtx.add through _add_pallas_T (ec32.py:343-409,
// 915-1012), with the XLA glue of msm_stream._finish_dev between them
// (pcd_tpu/ops/msm_stream.py:281-340): there, about 29 launches per MSM
// of one complete add per lane, column or pair, most of whose results a
// mask then drops, each between shifts, masks and gathers of the whole
// slab.
//
// The lanes of bucket b are a run [start_b, start_b + cnt_b) of its
// window's lanes, in bucket order.  One block owns FB consecutive buckets
// (one thread each) and their lanes; nwin x B / FB blocks fill the card.
//  (1) Each run is summed pairwise into its first lane: at level s lane
//      start + 2sq adds lane start + 2sq + s, the block's pairs dealt
//      evenly to its threads.  A long run costs log2(cnt) levels and
//      cnt / FB adds a thread, not cnt serial adds; sums of two or more
//      lanes go to `scratch`, so the accumulators are only read.
//  (2) Thread t takes S_t (identity where the bucket is empty); a suffix
//      scan over the block in shared memory gives C_t = sum_{t' >= t}
//      S_t', and a tree over t >= 1 gives W = sum_{t >= 1} C_t =
//      sum_t t S_t.  S = C_0 and W go to `part`.  The points stay in
//      shared memory (D = 3: 93 KB a block) and the Fp^D formula runs on
//      them there, out of line, so no thread holds a point in registers.
//  (3) The window's last block to finish (a counter per window, zeroed
//      by the entry point) combines the nblk pairs: sum_k W_k + sum_k S_k
//      + FB sum_k k S_k, the last by the same scan and tree over the S_k
//      and log2(FB) doublings.
// ECCtx.bucket_finish_plain (pcd_tpu_torch/ops/ec.py) runs the same adds
// in the same order, one batched plain add per level.
//
// Bound: operations.  A window needs (used lanes - nonempty buckets) +
// 2 B complete adds of 18 field products each (chip_smoke.py counts them
// from the schedule), against the accumulators read once and the sums
// written once.  Every stage is log-depth, so a thread waits on at most
// log2(maxrun) + 2 log2(FB) + 2 log2(nblk) + log2(FB) + 2 dependent adds.
#include "ec.cuh"

#define FB 128  // buckets per block, one thread each (pcd_finish_block)

// R = P + Q (R may be P or Q).  Out of line for D > 1, where the operands
// stay in shared or global memory: one copy of the Fp^D formula serves
// every stage.  Inline for D = 1, on register copies.
template <int D>
__device__ __noinline__ void add_mem(Pt<D>& R, const Pt<D>& P,
                                     const Pt<D>& Q, const FieldConsts& k) {
  rcb_add<D>(R, P, Q, k);
}

template <int D>
__device__ __forceinline__ void k4_add(Pt<D>& R, const Pt<D>& P,
                                       const Pt<D>& Q, const FieldConsts& k) {
  if constexpr (D == 1) {
    const Pt<1> a = P, b = Q;
    Pt<1> r;
    rcb_add<1>(r, a, b, k);
    R = r;
  } else {
    add_mem<D>(R, P, Q, k);
  }
}

// P = a point written by another block of this launch (L2, not L1)
template <int D>
__device__ __forceinline__ void pt_load_cg(Pt<D>& P, const uint32_t* src) {
  uint32_t* d = &P.X.c[0][0];
  const uint2* s = reinterpret_cast<const uint2*>(src);
#pragma unroll 6
  for (int q = 0; q < 3 * D * NL / 2; ++q) {
    const uint2 v = __ldcg(s + q);
    d[2 * q] = v.x;
    d[2 * q + 1] = v.y;
  }
}

// suffix scan over cur[0 .. n): cur[t] += cur[t + s] level by level,
// through the second buffer
template <int D>
__device__ __forceinline__ void block_scan(Pt<D>*& cur, Pt<D>*& nxt, int t,
                                           int n, const FieldConsts& k) {
  for (int s = 1; s < n; s *= 2) {
    if (t + s < n)
      k4_add<D>(nxt[t], cur[t], cur[t + s], k);
    else if (t < n)
      nxt[t] = cur[t];
    __syncthreads();
    Pt<D>* x = cur;
    cur = nxt;
    nxt = x;
  }
}

// cur[off .. n) summed pairwise into cur[off], in place: the element a
// level writes is read by no one at that level
template <int D>
__device__ __forceinline__ void block_tree(Pt<D>* cur, int t, int n, int off,
                                           const FieldConsts& k) {
  const int u = t - off;
  for (int s = 1; s < n - off; s *= 2) {
    if (u >= 0 && (u & (2 * s - 1)) == 0 && u + s < n - off)
      k4_add<D>(cur[t], cur[t], cur[t + s], k);
    __syncthreads();
  }
}

// (1) for the nb buckets from bucket j0 of window w (their first lanes
// and lane counts left in start[], cnt[]): each run pairwise into its first
// lane.  Level s adds lane start + 2sq + s into start + 2sq; its pairs are
// numbered across the buckets (a prefix over their pair counts, pre[0 ..
// nb]), so each of the block's nt threads takes every nt-th pair, however
// long or short the runs.  The partial sum at a lane covers min(s, lanes
// left in the run) lanes after level s / 2: in accs if that is one lane,
// else in scratch.  Ends before a barrier: the caller syncs.
template <int D>
__device__ __forceinline__ void merge_runs(
    const Pt<D>* A, Pt<D>* S, const int32_t* bidx, const int32_t* runrem,
    long empty, long j0, int nb, long* start, int* cnt, int* pre, int* top,
    int t, int nt, const FieldConsts& k) {
  if (t == 0) *top = 0;
  for (int j = t; j < nb; j += nt) {
    start[j] = bidx[j0 + j];
    cnt[j] = start[j] == empty ? 0 : runrem[start[j]];
  }
  __syncthreads();
  for (int j = t; j < nb; j += nt)
    if (cnt[j] > 1) atomicMax(top, cnt[j]);
  __syncthreads();
  const int longest = *top;
  for (int s = 1; s < longest; s *= 2) {
    __syncthreads();
    if (t == 0) {
      int acc = 0;
      for (int j = 0; j < nb; ++j) {
        pre[j] = acc;
        const int c = cnt[j];
        acc += c > s ? (c - s + 2 * s - 1) / (2 * s) : 0;
      }
      pre[nb] = acc;
    }
    __syncthreads();
    for (int p = t; p < pre[nb]; p += nt) {
      int lo = 0, hi = nb;               // pre[lo] <= p < pre[lo + 1]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (pre[mid] <= p)
          lo = mid;
        else
          hi = mid;
      }
      const int q = p - pre[lo];
      const long g = start[lo] + 2L * s * q;
      const int left = cnt[lo] - 2 * s * q - s;  // lanes from g + s on
      k4_add<D>(S[g], s == 1 ? A[g] : S[g],
                s == 1 || left == 1 ? A[g + s] : S[g + s], k);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FB)
bucket_finish_kernel(const uint32_t* __restrict__ accs,
                     const int32_t* __restrict__ bidx,
                     const int32_t* __restrict__ runrem, uint32_t* scratch,
                     uint32_t* part, int* done, uint32_t* __restrict__ out,
                     int nwin, int L, int B, FieldConsts k) {
  constexpr int PW = 3 * D * NL;
  extern __shared__ __align__(16) unsigned char smem[];
  Pt<D>* cur = reinterpret_cast<Pt<D>*>(smem);
  Pt<D>* nxt = cur + FB;
  Pt<D>* keep = cur + 2 * FB;           // E_0 and Y of the window combine
  __shared__ long s_start[FB];
  __shared__ int s_cnt[FB], s_pre[FB + 1], s_top, s_last;
  const Pt<D>* A = reinterpret_cast<const Pt<D>*>(accs);
  Pt<D>* S = reinterpret_cast<Pt<D>*>(scratch);
  const int nb = B < FB ? B : FB;
  const int nblk = B / nb;
  const int w = blockIdx.x / nblk, kb = blockIdx.x - w * nblk;
  const int t = threadIdx.x;
  merge_runs<D>(A, S, bidx, runrem, (long)nwin * L, (long)w * B + kb * nb,
                nb, s_start, s_cnt, s_pre, &s_top, t, nb, k);
  const long start = s_start[t];
  const int cnt = s_cnt[t];
  __syncthreads();
  // (2) the block's buckets: S = C_0 and W = sum_{t >= 1} C_t = sum_t t
  // S_t to the window's parts
  if (cnt == 0)
    pt_identity<D>(cur[t], k);
  else
    cur[t] = cnt == 1 ? A[start] : S[start];
  __syncthreads();
  block_scan<D>(cur, nxt, t, nb, k);
  block_tree<D>(cur, t, nb, 1, k);
  uint32_t* mine = part + ((long)w * nblk + kb) * 2 * PW;
  if (t < 2) {
    pt_store<D>(mine + t * PW, cur[t]);
    __threadfence();
  }
  __syncthreads();
  if (t == 0) s_last = atomicAdd(done + w, 1) == nblk - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // (3) the window's last block: E_k = sum_{k' >= k} S_k', Y = sum_{k >=
  // 1} E_k = sum_k k S_k, then sum_k W_k + E_0 + FB Y
  const uint32_t* all = part + (long)w * nblk * 2 * PW;
  if (t < nblk) pt_load_cg<D>(cur[t], all + 2 * t * PW);
  __syncthreads();
  block_scan<D>(cur, nxt, t, nblk, k);
  block_tree<D>(cur, t, nblk, 1, k);
  if (t < 2) keep[t] = cur[t];
  __syncthreads();
  if (t < nblk) pt_load_cg<D>(cur[t], all + (2 * t + 1) * PW);
  __syncthreads();
  block_tree<D>(cur, t, nblk, 0, k);
  if (t == 0) {
    k4_add<D>(cur[0], cur[0], keep[0], k);
    if (nblk > 1) {
      for (int d = 1; d < nb; d *= 2) k4_add<D>(keep[1], keep[1], keep[1], k);
      k4_add<D>(cur[0], cur[0], keep[1], k);
    }
    pt_store<D>(out + (long)w * PW, cur[0]);
  }
}

// accs (nwin, L, 3, D, NL) u32 lane accumulators; bidx (nwin, B) i32
// global first lane per bucket (nwin * L: empty); runrem (nwin, L) i32;
// scratch like accs, part (nwin, B / min(B, FB), 2, 3, D, NL), done
// (nwin,) i32 workspace; out (nwin, 3, D, NL).  B a power of two >= 2.
// consts points to a host FieldConsts; stream is a cudaStream_t.  Returns
// the first CUDA error of the set-up, the counter reset and the launch.
template <int D>
static int launch(const void* accs, const void* bidx, const void* runrem,
                  void* scratch, void* part, void* done, void* out, int nwin,
                  int L, int B, const FieldConsts& k, cudaStream_t s) {
  const int nb = B < FB ? B : FB;
  const int smem = (2 * FB + 2) * (int)sizeof(Pt<D>);
  cudaError_t e = cudaFuncSetAttribute(
      bucket_finish_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(done, 0, sizeof(int) * nwin, s);
  if (e != cudaSuccess) return (int)e;
  bucket_finish_kernel<D><<<nwin * (B / nb), nb, smem, s>>>(
      static_cast<const uint32_t*>(accs), static_cast<const int32_t*>(bidx),
      static_cast<const int32_t*>(runrem), static_cast<uint32_t*>(scratch),
      static_cast<uint32_t*>(part), static_cast<int*>(done),
      static_cast<uint32_t*>(out), nwin, L, B, k);
  return (int)cudaGetLastError();
}

extern "C" int pcd_bucket_finish(int D, const void* accs, const void* bidx,
                                 const void* runrem, void* scratch,
                                 void* part, void* done, void* out, int nwin,
                                 int L, int B, const void* consts,
                                 void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  if (nwin <= 0) return 0;
  if (B < 2 || (B & (B - 1))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return launch<1>(accs, bidx, runrem, scratch, part, done, out, nwin, L,
                       B, k, s);
    case 2:
      return launch<2>(accs, bidx, runrem, scratch, part, done, out, nwin, L,
                       B, k, s);
    case 3:
      return launch<3>(accs, bidx, runrem, scratch, part, done, out, nwin, L,
                       B, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K4's buckets per block, which ECCtx.bucket_finish_plain must share to
// repeat its adds in order
extern "C" int pcd_finish_block() { return FB; }
