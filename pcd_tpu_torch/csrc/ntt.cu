// K5: a run of consecutive levels of the mixed-radix NTT in shared
// memory, ntt_pass.
//
// Replaces FFTTensorCtx._transform (pcd_tpu/ops/fft_tensor.py:74-94) and
// its digit reversal (96-106), XLA programs with no Pallas site.  The
// plan is the reference's (`_plan`, lines 53-72): the domain's prime
// factors (radixes 2..31, poly/domain.py) taken bottom-up, a level (r, m)
// building transforms of length n_l = r m from r transforms of length m:
//
//   out[g, k] = sum_{j < r} T[(stride j k) mod n] in[g, j, k mod m]
//
// for group g of n_l points and 0 <= k < n_l, stride = n / n_l, T the
// (n, 10) table of powers of the domain's root (its inverse for an
// inverse transform), all Montgomery.
//
// Passes.  pcd_tpu_torch/ops/fft_tensor.py `passes` groups the levels
// into runs whose radixes multiply to Q <= the tile and hands each run's
// geometry to one launch: its base stride M (the length of the
// transforms the pass starts from), Q, the lines C a block owns and, per
// level, (r, m / M, n_l, stride).  A line is Q points that the pass's
// levels transform among themselves: in the pass of the lowest levels
// (M = 1) one contiguous sub-transform of Q points, read through the
// digit reversal `perm`; in a later pass the column k' < M of a group G
// of M Q points, the points G M Q + u M + k' (u < Q).  A level (r, m) of
// the pass acts on a line as a level (r, m / M) on the u, with the full
// k = k_u M + k' in the twiddle index.  A block loads its C adjacent
// lines (adjacent k': contiguous runs) into shared memory, runs every
// level of the pass there with __syncthreads between levels, and writes
// the lines back: one round trip through device memory a pass (two or
// three a transform at the real sizes) where a launch per level made one
// a level.
//
// The tile lies limb-major in shared memory (limb l of point p at
// [l][p], p = u C + c for point u of line c): threads on adjacent sets
// touch adjacent words, where a 10-word row stride would conflict.
//
// A radix-2 level is a butterfly: with T[n / 2] = -1 the outputs k and
// k + m of a pair are x0 + T[stride k] x1 and x0 - T[stride k] x1, one
// Montgomery product per pair.  A level of radix r > 2 keeps the r-point
// sum, r - 1 products per output: a round of threads reads whole sets
// of r positions, waits at a barrier and writes the outputs back into
// the same positions.  Twiddles are read from the table (L2-resident:
// 9 MB at 225,792 points); staging a level's twiddles in shared memory
// was slower at this tile and block shape (PERF.md).
//
// The twiddle index.  (stride j k) mod n = stride ((j k) mod n_l), and
// (j k) mod n_l is stepped over j by adding k < n_l and subtracting n_l
// once: every intermediate stays below 2 n_l, and the index below n, so
// 32-bit ints hold it, with no division or 64-bit product per term.
//
// Tile and block: ops/fft_tensor.py `ntt_tile`, 512 points (20 KB of
// dynamic shared memory), or 256 for a domain of at most 2^17 points;
// blocks of 128 threads, at least 6 an SM (74 registers, no spills).  Of
// tiles 256-2048 and blocks of 64-512 threads this was the fastest or
// near it on every real domain (kernel_ab.py --quotient --sweep; PERF.md):
// more, smaller blocks fill the 132 SMs' 792 slots where a 2,048-point
// tile left a part wave (384 blocks on 264 slots at 225,792).  At 2^17
// points or fewer and the provers' batch of 2-3, a pass of 512-point
// blocks makes at most 768 blocks, under one wave, so the smaller tile
// doubles them.  The real domains' passes (bottom-up radixes):
//   225,792 = 2^9 3^2 7^2: 7 7 3 3 (Q = 441), then 2^9 at M = 441
//   31,360 = 2^7 5 7^2:    7 7 5 (Q = 245), then 2^7 at M = 245
//   688,128 = 2^15 3 7:    7 3 2^4 (Q = 336), 2^9 at M = 336, 2^2 at
//                          M = 172,032
//   107,520 = 2^10 3 5 7:  7 5 3 2 (Q = 210), 2^8 at M = 210, 2 at
//                          M = 53,760
//
// Bound: operations: one Montgomery product (210 partial products) per
// pair at radix 2 and r - 1 per output at radix r > 2, against the input
// and output read and written once each, the permutation and the table.
#include "rows.cuh"

#define NTT_THREADS 128
#define NTT_MINB 6
#define NTT_MAX_TILE 4096
#define NTT_MAX_LEV 12

struct NttPass {
  int M, Q, C, nlev;
  int r[NTT_MAX_LEV], ml[NTT_MAX_LEV], nl[NTT_MAX_LEV], stride[NTT_MAX_LEV];
};

PCD_FN void sm_ld(uint32_t x[NL], const uint32_t* sm, int S, int p) {
#pragma unroll
  for (int l = 0; l < NL; ++l) x[l] = sm[l * S + p];
}

PCD_FN void sm_st(uint32_t* sm, int S, int p, const uint32_t x[NL]) {
#pragma unroll
  for (int l = 0; l < NL; ++l) sm[l * S + p] = x[l];
}

// dynamic shared memory of a block: the tile (NL even: 8-byte aligned
// after it) and 16 bytes of line data per line
static size_t ntt_smem_bytes(int C, int Q) {
  return (size_t)NL * C * Q * 4 + (size_t)C * 16;
}

__global__ void __launch_bounds__(NTT_THREADS, NTT_MINB)
ntt_pass_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                const uint32_t* __restrict__ tbl,
                const int32_t* __restrict__ perm, int n, long lines,
                NttPass g, FieldConsts k) {
  // [NL][S] tile, then per line: its batch row's first point, the
  // offset of its point u = 0 (before perm) or -1 past the last line,
  // and its column k'
  extern __shared__ uint32_t sm[];
  const int C = g.C, S = C * g.Q;
  long* lrow = reinterpret_cast<long*>(sm + NL * S);
  int* loff = reinterpret_cast<int*>(lrow + C);
  int* kcs = loff + C;
  const int lpr = n / g.Q;                // lines per batch row
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long Lg = (long)blockIdx.x * C + c;
    const long row = Lg / lpr;
    const int L = (int)(Lg - row * lpr), kc = L % g.M;
    lrow[c] = row * n;
    loff[c] = Lg < lines ? (L - kc) * g.Q + kc : -1;   // G M Q + k'
    kcs[c] = kc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * (NL / 2); i += blockDim.x) {
    const int p = i / (NL / 2), q = i - p * (NL / 2);
    const int u = p / C, c = p - u * C;
    if (loff[c] < 0) continue;
    int a = loff[c] + u * g.M;
    if (perm) a = perm[a];
    const uint2 v =
        reinterpret_cast<const uint2*>(src + (lrow[c] + a) * NL)[q];
    sm[2 * q * S + p] = v.x;
    sm[(2 * q + 1) * S + p] = v.y;
  }
  __syncthreads();
  for (int lv = 0; lv < g.nlev; ++lv) {
    const int r = g.r[lv], ml = g.ml[lv], nl = g.nl[lv];
    const int stride = g.stride[lv];
    if (r == 2) {
      for (int s = threadIdx.x; s < S / 2; s += blockDim.x) {
        const int c = s % C, rest = s / C;
        const int kk = rest % ml;          // k mod m of the pair
        const int p0 = ((rest - kk) * 2 + kk) * C + c;
        const int p1 = p0 + ml * C;
        uint32_t x0[NL], x1[NL], w[NL], t[NL];
        sm_ld(x0, sm, S, p0);
        sm_ld(x1, sm, S, p1);
        ld_row(w, tbl, (long)(kk * g.M + kcs[c]) * stride);
        fp_mul(t, x1, w, k);
        fp_add(w, x0, t, k.p);
        fp_sub(x1, x0, t, k.p);
        sm_st(sm, S, p0, w);
        sm_st(sm, S, p1, x1);
      }
    } else {
      const int per = (blockDim.x / r) * r;   // whole sets a round
      for (int base = 0; base < S; base += per) {
        const int o = base + threadIdx.x;
        const bool on = threadIdx.x < per && o < S;
        uint32_t acc[NL];
        int pout = 0;
        if (on) {
          const int s = o / r, jo = o - s * r;
          const int c = s % C, rest = s / C;
          const int kk = rest % ml;
          const int u0 = (rest - kk) * r + kk;   // g r m + (k mod m)
          const int kf = (kk + jo * ml) * g.M + kcs[c];   // k < n_l
          pout = (u0 + jo * ml) * C + c;
          sm_ld(acc, sm, S, u0 * C + c);        // T[0] = 1
          uint32_t x[NL], w[NL], t[NL];
          int e = 0;                            // (j k) mod n_l
          for (int j = 1; j < r; ++j) {
            e += kf;
            if (e >= nl) e -= nl;
            sm_ld(x, sm, S, (u0 + j * ml) * C + c);
            ld_row(w, tbl, (long)e * stride);
            fp_mul(t, x, w, k);
            fp_add(acc, acc, t, k.p);
          }
        }
        __syncthreads();                        // the round's sets read
        if (on) sm_st(sm, S, pout, acc);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < S * (NL / 2); i += blockDim.x) {
    const int p = i / (NL / 2), q = i - p * (NL / 2);
    const int u = p / C, c = p - u * C;
    if (loff[c] < 0) continue;
    reinterpret_cast<uint2*>(dst + (lrow[c] + loff[c] + u * g.M) * NL)[q] =
        make_uint2(sm[2 * q * S + p], sm[(2 * q + 1) * S + p]);
  }
}

// src, dst (batch, n, NL) u32 Montgomery, distinct buffers; tbl (n, NL)
// root powers; perm (n,) i32 or null (only at M = 1); geom a host int32
// array [M, Q, C, nlev, then per level r, m / M, n_l, stride] as
// fft_tensor.passes gives it, checked here; consts points to a host
// FieldConsts; stream is a cudaStream_t.  Returns cudaGetLastError (or
// cudaErrorInvalidValue for a geometry that is not a pass of n).
extern "C" int pcd_ntt_pass(const void* src, void* dst, const void* tbl,
                            const void* perm, long n, int batch,
                            const int32_t* geom, const void* consts,
                            void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  NttPass g;
  g.M = geom[0];
  g.Q = geom[1];
  g.C = geom[2];
  g.nlev = geom[3];
  if (n <= 0 || n > 0x3FFFFFFF || batch <= 0 || g.M < 1 || g.Q < 2 ||
      g.C < 1 || g.nlev < 1 || g.nlev > NTT_MAX_LEV ||
      (long)g.C * g.Q > NTT_MAX_TILE || n % ((long)g.M * g.Q) != 0 ||
      (perm != nullptr && g.M != 1))
    return (int)cudaErrorInvalidValue;
  long q = 1;
  for (int i = 0; i < g.nlev; ++i) {
    const int* v = geom + 4 + 4 * i;
    g.r[i] = v[0];
    g.ml[i] = v[1];
    g.nl[i] = v[2];
    g.stride[i] = v[3];
    if (v[0] < 2 || v[1] != q || (long)v[2] != (long)v[0] * q * g.M ||
        (long)v[2] * v[3] != n)
      return (int)cudaErrorInvalidValue;
    q *= v[0];
  }
  if (q != g.Q) return (int)cudaErrorInvalidValue;
  const long lines = n / g.Q * batch;
  const size_t bytes = ntt_smem_bytes(g.C, g.Q);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(NTT_THREADS);
  const dim3 grid((unsigned)((lines + g.C - 1) / g.C));
  ntt_pass_kernel<<<grid, block, bytes,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
      static_cast<const uint32_t*>(tbl), static_cast<const int32_t*>(perm),
      (int)n, lines, g, k);
  return (int)cudaGetLastError();
}
