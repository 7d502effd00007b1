// Two measurements for kernel_ab.py --k4, built from this checkout's
// pcd_tpu_torch/csrc with -I pointing there; no path of the port runs
// them.
//
// pcd_bucket_finish_runsum: the stream-MSM finish in the design first
// proposed for K4, to time against K4 (bucket_finish.cu, built into the
// same library) on the same inputs.  Each block owns FB * M consecutive
// buckets of one window and merges their runs of lanes as K4 does
// (merge_runs).  Thread t then owns M consecutive buckets and runs the
// running-sum pair over them, top down: S_t = sum_i S_{tM+i} and W_t =
// sum_i i S_{tM+i}, 2 (M - 1) adds in sequence.  A tree over the block's
// threads in shared memory combines neighbouring pairs, (S, W) = (S_lo +
// S_hi, W_lo + W_hi + n_lo S_hi), n_lo the low half's bucket count, a
// power of two, so n_lo S_hi is log2(n_lo) doublings.  The window's last
// block combines the blocks' pairs by the same tree, and sum_b b S_b =
// W + S.  K4 instead runs a suffix scan and a tree per block of FB
// buckets: more adds, fewer in sequence.
//
// pcd_add_chain: n threads each add a point to itself N times in
// sequence through K4's add (k4_add: registers at D = 1, the out-of-line
// formula on local memory at D > 1), in blocks of FB threads: the time of
// one complete add on one thread's critical path, at the occupancy a grid
// of n / FB blocks gets.
#include "bucket_finish.cu"

// W += n S (n a power of two), through tmp
template <int D>
__device__ __forceinline__ void add_scaled(Pt<D>& W, const Pt<D>& S,
                                           Pt<D>& tmp, int n,
                                           const FieldConsts& k) {
  tmp = S;
  for (int d = 1; d < n; d *= 2) k4_add<D>(tmp, tmp, tmp, k);
  k4_add<D>(W, W, tmp, k);
}

// (S, W) pairs in Sx[0 .. n), Wx[0 .. n), each of `len` buckets, combined
// pairwise into Sx[0], Wx[0]
template <int D>
__device__ __forceinline__ void pair_tree(Pt<D>* Sx, Pt<D>* Wx, Pt<D>* tmp,
                                          int t, int n, int len,
                                          const FieldConsts& k) {
  for (int s = 1; s < n; s *= 2) {
    if ((t & (2 * s - 1)) == 0 && t + s < n) {
      k4_add<D>(Wx[t], Wx[t], Wx[t + s], k);
      add_scaled<D>(Wx[t], Sx[t + s], tmp[t], len * s, k);
      k4_add<D>(Sx[t], Sx[t], Sx[t + s], k);
    }
    __syncthreads();
  }
}

#define RS_MMAX 16

template <int D>
__global__ void __launch_bounds__(FB)
bucket_finish_runsum_kernel(const uint32_t* __restrict__ accs,
                            const int32_t* __restrict__ bidx,
                            const int32_t* __restrict__ runrem,
                            uint32_t* scratch, uint32_t* part, int* done,
                            uint32_t* __restrict__ out, int nwin, int L,
                            int B, int M, FieldConsts k) {
  constexpr int PW = 3 * D * NL;
  extern __shared__ __align__(16) unsigned char smem[];
  Pt<D>* Sx = reinterpret_cast<Pt<D>*>(smem);
  Pt<D>* Wx = Sx + FB;
  Pt<D>* tmp = Sx + 2 * FB;
  __shared__ long s_start[FB * RS_MMAX];
  __shared__ int s_cnt[FB * RS_MMAX], s_pre[FB * RS_MMAX + 1], s_top, s_last;
  const Pt<D>* A = reinterpret_cast<const Pt<D>*>(accs);
  Pt<D>* S = reinterpret_cast<Pt<D>*>(scratch);
  const int nb = FB * M;
  const int nblk = B / nb;
  const int w = blockIdx.x / nblk, kb = blockIdx.x - w * nblk;
  const int t = threadIdx.x;
  merge_runs<D>(A, S, bidx, runrem, (long)nwin * L, (long)w * B + kb * nb,
                nb, s_start, s_cnt, s_pre, &s_top, t, FB, k);
  __syncthreads();
  // the running-sum pair over this thread's buckets t M .. t M + M - 1
  pt_identity<D>(Sx[t], k);
  pt_identity<D>(Wx[t], k);
  for (int i = M - 1; i >= 0; --i) {
    const int j = t * M + i;
    if (i < M - 1) k4_add<D>(Wx[t], Wx[t], Sx[t], k);
    if (s_cnt[j] > 0)
      k4_add<D>(Sx[t], Sx[t], s_cnt[j] == 1 ? A[s_start[j]] : S[s_start[j]],
                k);
  }
  __syncthreads();
  pair_tree<D>(Sx, Wx, tmp, t, FB, M, k);
  uint32_t* mine = part + ((long)w * nblk + kb) * 2 * PW;
  if (t == 0) {
    pt_store<D>(mine, Sx[0]);
    pt_store<D>(mine + PW, Wx[0]);
    __threadfence();
    s_last = atomicAdd(done + w, 1) == nblk - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const uint32_t* all = part + (long)w * nblk * 2 * PW;
  if (t < nblk) {
    pt_load_cg<D>(Sx[t], all + 2 * t * PW);
    pt_load_cg<D>(Wx[t], all + (2 * t + 1) * PW);
  }
  __syncthreads();
  pair_tree<D>(Sx, Wx, tmp, t, nblk, nb, k);
  if (t == 0) {
    k4_add<D>(Wx[0], Wx[0], Sx[0], k);
    pt_store<D>(out + (long)w * PW, Wx[0]);
  }
}

template <int D>
static int launch_runsum(const void* accs, const void* bidx,
                         const void* runrem, void* scratch, void* part,
                         void* done, void* out, int nwin, int L, int B, int M,
                         const FieldConsts& k, cudaStream_t s) {
  const int smem = 3 * FB * (int)sizeof(Pt<D>);
  cudaError_t e = cudaFuncSetAttribute(
      bucket_finish_runsum_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(done, 0, sizeof(int) * nwin, s);
  if (e != cudaSuccess) return (int)e;
  bucket_finish_runsum_kernel<D><<<nwin * (B / (FB * M)), FB, smem, s>>>(
      static_cast<const uint32_t*>(accs), static_cast<const int32_t*>(bidx),
      static_cast<const int32_t*>(runrem), static_cast<uint32_t*>(scratch),
      static_cast<uint32_t*>(part), static_cast<int*>(done),
      static_cast<uint32_t*>(out), nwin, L, B, M, k);
  return (int)cudaGetLastError();
}

// As pcd_bucket_finish, with M buckets a thread (M a power of two, at
// most RS_MMAX, B >= FB M); part holds (nwin, B / (FB M), 2) points.
extern "C" int pcd_bucket_finish_runsum(int D, int M, const void* accs,
                                        const void* bidx, const void* runrem,
                                        void* scratch, void* part,
                                        void* done, void* out, int nwin,
                                        int L, int B, const void* consts,
                                        void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  if (M < 1 || M > RS_MMAX || (M & (M - 1)) || B < FB * M || (B & (B - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return launch_runsum<1>(accs, bidx, runrem, scratch, part, done, out,
                              nwin, L, B, M, k, s);
    case 2:
      return launch_runsum<2>(accs, bidx, runrem, scratch, part, done, out,
                              nwin, L, B, M, k, s);
    case 3:
      return launch_runsum<3>(accs, bidx, runrem, scratch, part, done, out,
                              nwin, L, B, M, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
__global__ void __launch_bounds__(FB)
add_chain_kernel(const uint32_t* __restrict__ pts, uint32_t* out, int n,
                 int N, FieldConsts k) {
  const int g = blockIdx.x * FB + threadIdx.x;
  if (g >= n) return;
  Pt<D> P, R;
  pt_load<D>(P, pts + (long)g * 3 * D * NL);
  R = P;
  for (int i = 0; i < N; ++i) k4_add<D>(R, R, P, k);
  pt_store<D>(out + (long)g * 3 * D * NL, R);
}

// pts, out (n, 3, D, NL) u32; out = (N + 1) pts, one add at a time
extern "C" int pcd_add_chain(int D, const void* pts, void* out, int n, int N,
                             const void* consts, void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int grid = (n + FB - 1) / FB;
  const uint32_t* p = static_cast<const uint32_t*>(pts);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (D) {
    case 1: add_chain_kernel<1><<<grid, FB, 0, s>>>(p, o, n, N, k); break;
    case 2: add_chain_kernel<2><<<grid, FB, 0, s>>>(p, o, n, N, k); break;
    case 3: add_chain_kernel<3><<<grid, FB, 0, s>>>(p, o, n, N, k); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
