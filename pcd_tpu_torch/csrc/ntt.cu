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
// blocks of 128 threads, at least 6 an SM (74 registers, no spills; with
// a prologue or an epilogue 74-78, both 5 an SM: PERF.md).  Of
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
// Prologue and epilogue.  The quotient's pointwise steps (the reference's
// separate XLA ops: the coset scalings and n^-1 of FFTTensorCtx.ifft /
// coset_fft / coset_ifft, pcd_tpu/ops/fft_tensor.py:111-123, and the
// (a b - c) Z_H^-1 and final from-Montgomery of pcd_tpu/snark/groth16/
// native.py:502-513) run in a pass's loads and stores, where the points
// already pass through registers, instead of a launch of K7 each.  Both
// are template parameters, so the plain instantiation is unchanged:
//   prologue (a pass at M = 1: the transform's first) on the point loaded
//   from source index a (after perm):
//     NTT_PRO_MUL  x_a P[a mod np], np = 1 (a scalar) or n (a table);
//     NTT_PRO_ABC  (x_A x_B - x_C) s of batch rows A, B, C of a (3, n, 10)
//                  source, or A, C of a (2, n, 10) one with B = A (the
//                  squaring case), s one element; the pass writes a batch
//                  of one;
//   epilogue, on the point stored at destination index i:
//     NTT_EPI_MUL  x_i E[i mod ne], ne = 1 or n.
// A Montgomery E keeps the output Montgomery; an E of plain residues (not
// times R) makes it canonical, mont_mul(x R, t) = x t, so the final
// from-Montgomery costs no product of its own.  With either, a thread
// takes a whole point (one product on 40 bytes) where the plain loads and
// stores move 8 bytes a thread.
//
// Bound: operations: one Montgomery product (210 partial products) per
// pair at radix 2 and r - 1 per output at radix r > 2, and those of the
// prologue and epilogue (one a point; ABC two), against the input and
// output read and written once each (ABC: two or three source rows), the
// permutation, the root table and the prologue's and epilogue's tables.
#include "rows.cuh"

#define NTT_THREADS 128
#define NTT_MINB 6
// a pass with both a prologue and an epilogue (a transform of one pass:
// small domains only) spilled at 6 blocks an SM, the 80-register cap
#define NTT_MINB_ENDS 5
#define NTT_MAX_TILE 4096
#define NTT_MAX_LEV 12
#define NTT_PRO_NONE 0
#define NTT_PRO_MUL 1
#define NTT_PRO_ABC 2
#define NTT_EPI_NONE 0
#define NTT_EPI_MUL 1

struct NttPass {
  int M, Q, C, nlev;
  int r[NTT_MAX_LEV], ml[NTT_MAX_LEV], nl[NTT_MAX_LEV], stride[NTT_MAX_LEV];
};

// the prologue's and epilogue's operands: P (or s) and np, E and ne
struct NttEnds {
  const uint32_t* pv;
  const uint32_t* ev;
  long np, ne;
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

template <int PRO, int EPI>
__global__ void __launch_bounds__(NTT_THREADS,
                                  PRO != NTT_PRO_NONE && EPI != NTT_EPI_NONE
                                      ? NTT_MINB_ENDS
                                      : NTT_MINB)
ntt_pass_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                const uint32_t* __restrict__ tbl,
                const int32_t* __restrict__ perm, int n, long lines,
                NttPass g, NttEnds e, FieldConsts k) {
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
  if constexpr (PRO == NTT_PRO_NONE) {
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
  } else {                                  // M = 1: u is the line's point
    for (int p = threadIdx.x; p < S; p += blockDim.x) {
      const int u = p / C, c = p - u * C;
      if (loff[c] < 0) continue;
      int a = loff[c] + u;
      if (perm) a = perm[a];
      uint32_t x[NL], y[NL], t[NL];
      if constexpr (PRO == NTT_PRO_MUL) {
        ld_row(x, src, lrow[c] + a);
        ld_row(y, e.pv, e.np == 1 ? 0 : a);
        fp_mul(t, x, y, k);
      } else {                              // ABC: batch 1, lrow[c] = 0
        ld_row(x, src, a);
        ld_row(y, src, e.np == 3 ? (long)n + a : (long)a);
        fp_mul(t, x, y, k);
        ld_row(x, src, (e.np - 1) * n + a);
        fp_sub(y, t, x, k.p);
        ld_row(x, e.pv, 0);
        fp_mul(t, y, x, k);
      }
      sm_st(sm, S, p, t);
    }
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
  if constexpr (EPI == NTT_EPI_NONE) {
    for (int i = threadIdx.x; i < S * (NL / 2); i += blockDim.x) {
      const int p = i / (NL / 2), q = i - p * (NL / 2);
      const int u = p / C, c = p - u * C;
      if (loff[c] < 0) continue;
      reinterpret_cast<uint2*>(dst + (lrow[c] + loff[c] + u * g.M) * NL)[q] =
          make_uint2(sm[2 * q * S + p], sm[(2 * q + 1) * S + p]);
    }
  } else {
    for (int p = threadIdx.x; p < S; p += blockDim.x) {
      const int u = p / C, c = p - u * C;
      if (loff[c] < 0) continue;
      const int i = loff[c] + u * g.M;
      uint32_t x[NL], y[NL], t[NL];
      sm_ld(x, sm, S, p);
      ld_row(y, e.ev, e.ne == 1 ? 0 : i);
      fp_mul(t, x, y, k);
      st_row(dst, lrow[c] + i, t);
    }
  }
}

typedef void (*NttKernel)(const uint32_t*, uint32_t*, const uint32_t*,
                          const int32_t*, int, long, NttPass, NttEnds,
                          FieldConsts);
// [prologue][epilogue]
static const NttKernel ntt_kernels[3][2] = {
    {ntt_pass_kernel<NTT_PRO_NONE, NTT_EPI_NONE>,
     ntt_pass_kernel<NTT_PRO_NONE, NTT_EPI_MUL>},
    {ntt_pass_kernel<NTT_PRO_MUL, NTT_EPI_NONE>,
     ntt_pass_kernel<NTT_PRO_MUL, NTT_EPI_MUL>},
    {ntt_pass_kernel<NTT_PRO_ABC, NTT_EPI_NONE>,
     ntt_pass_kernel<NTT_PRO_ABC, NTT_EPI_MUL>}};

// src, dst (batch, n, NL) u32 Montgomery, distinct buffers (with the ABC
// prologue src is (np, n, NL) and batch 1); tbl (n, NL) root powers; perm
// (n,) i32 or null (only at M = 1); geom a host int32 array [M, Q, C,
// nlev, then per level r, m / M, n_l, stride] as fft_tensor.passes gives
// it, checked here; consts points to a host FieldConsts; stream is a
// cudaStream_t.  pro: NTT_PRO_NONE, NTT_PRO_MUL (pv the (np, NL) table P,
// np 1 or n) or NTT_PRO_ABC (pv the element s, np the source rows, 2 or
// 3), only at M = 1; epi: NTT_EPI_NONE or NTT_EPI_MUL (ev the (ne, NL)
// table E, ne 1 or n).  Returns cudaGetLastError, or cudaErrorInvalidValue
// for a geometry that is not a pass of n or a mode, table or length the
// pass cannot take.
extern "C" int pcd_ntt_pass(const void* src, void* dst, const void* tbl,
                            const void* perm, long n, int batch,
                            const int32_t* geom, const void* consts,
                            void* stream, int pro, const void* pv, long np,
                            int epi, const void* ev, long ne) {
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
  if (pro < NTT_PRO_NONE || pro > NTT_PRO_ABC || epi < NTT_EPI_NONE ||
      epi > NTT_EPI_MUL ||
      (pro != NTT_PRO_NONE && (g.M != 1 || pv == nullptr)) ||
      (pro == NTT_PRO_MUL && np != 1 && np != n) ||
      (pro == NTT_PRO_ABC && (batch != 1 || (np != 2 && np != 3))) ||
      (epi == NTT_EPI_MUL && (ev == nullptr || (ne != 1 && ne != n))))
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
  const NttKernel kern = ntt_kernels[pro][epi];
  NttEnds e;
  e.pv = static_cast<const uint32_t*>(pv);
  e.ev = static_cast<const uint32_t*>(ev);
  e.np = np;
  e.ne = ne;
  const long lines = n / g.Q * batch;
  const size_t bytes = ntt_smem_bytes(g.C, g.Q);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(NTT_THREADS);
  const dim3 grid((unsigned)((lines + g.C - 1) / g.C));
  kern<<<grid, block, bytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
      static_cast<const uint32_t*>(tbl), static_cast<const int32_t*>(perm),
      (int)n, lines, g, e, k);
  return (int)cudaGetLastError();
}
