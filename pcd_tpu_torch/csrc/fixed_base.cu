// K8: fixed-base scalar multiplication, fixed_base<D>: [s_i] G for many
// scalars s_i and one base G, the SNARK setups' key generation.
//
// Replaces FixedBaseDevice.mul_digits (pcd_tpu/ops/fixed_base.py:63-75),
// an XLA program (no Pallas site): nwin gathers from a window table, each
// followed by a batched complete add.  For each window w with digit d != 0
// (the scalar's byte w: windows of c = 8 bits, the reference's) one
// complete mixed add of the table row T[w][d] = d 2^(8w) G, from the
// identity; then the point to affine canonical coordinates, the identity
// (scalar 0) to zeros with the infinity flag.  The add must be complete:
// in the top window d 2^(8w) wraps modulo the group order, so a sum can
// equal +-T[w][d] (and it starts at the identity).
//
// Table: (nwin, 256, 2, D, NL) u32 affine Montgomery rows, row 0 of each
// window flagged at infinity (bit 31 of X's top limb) and never read;
// digits: (nwin, n) u8, window-major; out: (n, 2, D, NL) u32.
//
// Bound: operations.  About 37.6 mixed adds a 298-bit scalar against 38
// bytes of digits in and 80 D bytes out; the table rows (20 D KB a window)
// stay in L2.  What held the one-thread-a-scalar kernel before this design
// back, and what each part here does about it (csrc/fixed_base.cuh holds
// the body):
//   - a Fermat inversion a scalar, 41% of its products at D = 1: here one
//     inversion a tile of scalars by Montgomery's trick, a product tree in
//     shared memory (3 Fp^D products a scalar), and that inversion a
//     binary extended Euclid (csrc/field.cuh fp_inv): it runs on one
//     thread while its tile waits, and a Fermat chain of 450 dependent
//     products (about 1.7 us each on one thread) would outlast the tile's
//     adds.  The tile is the block's groups over S, 64 or 128 scalars at
//     the shipped shape: the tree's 2 log2 levels stay short, and the
//     other resident blocks of the SM run while one block inverts;
//   - the RCB mixed add (3,570 / 9,010 / 16,320 partial products at D =
//     1, 2, 3): here the small-a group add of K3 (csrc/ec_group.cuh,
//     2,480 / 7,690 / 15,500 for the MNT curves; the full products by a
//     where SmallA.on is 0, the toy curves), one lane an add at every D:
//     the lanes of a larger group take different jobs of a round, which
//     diverge in the warp (kernel_ab.py --keygen --sweep: 2 and 3 lanes
//     at D = 2, 3 ran 30% and 60% slower);
//   - 4 warps an SM at 2^14 scalars, each running a chain of dependent
//     products: here each scalar's windows split over S groups, each
//     summing its windows from the identity, joined by S - 1 complete
//     adds (the group add); the launch takes the most S, up to K8S.s,
//     whose tiles fit in one wave of resident blocks (k8_plan): 2 at
//     2^14 scalars, 1 from 2^16 up, where the joins would only add work;
//   - 196 and 242 registers with 2,168 and 3,008 byte stack frames at D =
//     2, 3: here the values between the add's rounds live in the group's
//     slots in shared memory: 160 and 168 registers at D = 2, 3 (48
//     bytes of spills at D = 3); the
//     out-of-line Fp^D products (ext_mul, ext_mul_sum2) still take their
//     operands by reference from a stack frame (1,328 and 1,696 bytes):
//     inlined at each product of both adds they would multiply the code.
// A block takes tiles in turn; the grid is as many blocks as are resident
// at once, never more than the tiles.
#include "fixed_base.cuh"

constexpr int K8_THREADS = K8S.threads, K8_MINB = K8S.minb;

template <int D, bool SMALL>
__global__ void __launch_bounds__(K8_THREADS, K8_MINB)
fixed_base_kernel(const uint32_t* __restrict__ tbl,
                  const uint8_t* __restrict__ digits,
                  uint32_t* __restrict__ out, long n, int nwin, int S,
                  long ntiles, FieldConsts k, SmallA sa) {
  constexpr int G = K8_G(D), F = D * NL, PW = 3 * F;
  constexpr int NG = k8_ngrp<D>(), NS = GrpSlots<false>::N * F;
  const int TILE = NG / S, TP = k8_pow2(TILE);
  extern __shared__ __align__(16) uint32_t k8_smem[];
  uint32_t* accs = k8_smem;                       // NG x (3, D, NL)
  uint32_t* slots = accs + NG * PW;               // the tree after the join
  const GrpLane<G> g;
  const int split = g.grp % S, j = g.grp / S;     // scalar j of the tile
  const bool mine = !g.idle && j < TILE;
  uint32_t* acc = accs + g.grp * PW;
  uint32_t* S_ = slots + g.grp * NS;
  const int t = threadIdx.x;
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long i0 = tile * TILE;
    const int cnt = (int)(n - i0 < TILE ? n - i0 : TILE);
    const bool live = mine && j < cnt;
    if (live) {
      if (g.lane == 0) k8_identity<D>(acc, k);
      __syncwarp(g.mask);
      int w0, w1;
      k8_range(split, S, nwin, &w0, &w1);
      const uint8_t* dg = digits + i0 + j;
      for (int w = w0; w < w1; ++w) {
        const uint32_t d = dg[(long)w * n];
        if (d == 0) continue;
        const GrpRow row{acc, k8_row<D>(tbl, w, d), acc, false};
        grp_add_row<D, G, SMALL, true>(g.lane, g.mask, S_, row, k, sa);
      }
    }
    __syncthreads();
    for (int step = 1; step < S; step *= 2) {
      if (live && split % (2 * step) == 0 && split + step < S) {
        const GrpRow row{acc, acc + step * PW, acc, false};
        grp_add_row<D, G, SMALL, false>(g.lane, g.mask, S_, row, k, sa);
      }
      __syncthreads();
    }
    uint32_t* tree = slots;
    for (int q = t; q < TP; q += K8_THREADS)
      k8_leaf<D>(tree, TP, q, q < cnt ? accs + q * S * PW : nullptr, k);
    __syncthreads();
    for (int h = TP / 2; h >= 1; h /= 2) {
      for (int q = h + t; q < 2 * h; q += K8_THREADS) k8_up<D>(tree, q, k);
      __syncthreads();
    }
    if (t == 0) k8_root<D>(tree, k);
    __syncthreads();
    for (int h = 1; h < TP; h *= 2) {
      for (int q = h + t; q < 2 * h; q += K8_THREADS) k8_down<D>(tree, q, k);
      __syncthreads();
    }
    for (int q = t; q < cnt; q += K8_THREADS)
      k8_out<D>(out + (i0 + q) * (2 * F), accs + q * S * PW,
                tree + (TP + q) * F, k);
    __syncthreads();            // before the next tile's accumulators
  }
}

template <int D>
static size_t k8_smem_bytes() {
  return (size_t)k8_words<D>() * 4;
}

// The launch for n scalars: the splits a scalar S, the most (a power of
// two up to K8S.s) whose tiles of NG / S scalars still fit in one wave of
// resident blocks, so that S buys groups where n leaves SMs idle and
// costs no join where it does not; the tiles, and the grid: as many
// blocks as are resident, never more than the tiles.
struct K8Plan {
  int S, grid, per;
  long ntiles;
};

template <int D, bool SMALL>
static int k8_plan(long n, K8Plan* p) {
  auto kern = fixed_base_kernel<D, SMALL>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)k8_smem_bytes<D>());
    if (rc != cudaSuccess) return (int)rc;
    attr = true;
  }
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, kern, K8_THREADS, k8_smem_bytes<D>());
  if (rc != cudaSuccess) return (int)rc;
  const long resident = (long)(per > 0 ? per : 1) * sms;
  constexpr int NG = k8_ngrp<D>();
  int S = 1;
  while (2 * S <= K8S.s &&
         (n + NG / (2 * S) - 1) / (NG / (2 * S)) <= resident)
    S *= 2;
  p->S = S;
  p->per = per;
  p->ntiles = (n + NG / S - 1) / (NG / S);
  p->grid = (int)(p->ntiles < resident ? p->ntiles : resident);
  return 0;
}

template <int D, bool SMALL>
static int k8_launch(const uint32_t* tbl, const uint8_t* dg, uint32_t* o,
                     long n, int nwin, const FieldConsts& k, const SmallA& sa,
                     cudaStream_t s) {
  K8Plan p;
  const int rc = k8_plan<D, SMALL>(n, &p);
  if (rc) return rc;
  const size_t smem = k8_smem_bytes<D>();
  fixed_base_kernel<D, SMALL><<<p.grid, K8_THREADS, smem, s>>>(
      tbl, dg, o, n, nwin, p.S, p.ntiles, k, sa);
  return (int)cudaGetLastError();
}

// tbl: (nwin, 256, 2, D, NL) u32; digits: (nwin, n) u8; out: (n, 2, D, NL)
// u32; consts points to a host FieldConsts, small to a host SmallA; stream
// is a cudaStream_t.  Returns cudaGetLastError.
extern "C" int pcd_fixed_base_mul(int D, const void* tbl, const void* digits,
                                  void* out, long n, int nwin,
                                  const void* consts, const void* small,
                                  void* stream) {
  const FieldConsts k = *reinterpret_cast<const FieldConsts*>(consts);
  const SmallA sa = *reinterpret_cast<const SmallA*>(small);
  if (n <= 0) return 0;
  if (nwin <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* t = static_cast<const uint32_t*>(tbl);
  const uint8_t* dg = static_cast<const uint8_t*>(digits);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (D * 2 + (sa.on ? 1 : 0)) {
    case 2: return k8_launch<1, false>(t, dg, o, n, nwin, k, sa, s);
    case 3: return k8_launch<1, true>(t, dg, o, n, nwin, k, sa, s);
    case 4: return k8_launch<2, false>(t, dg, o, n, nwin, k, sa, s);
    case 5: return k8_launch<2, true>(t, dg, o, n, nwin, k, sa, s);
    case 6: return k8_launch<3, false>(t, dg, o, n, nwin, k, sa, s);
    case 7: return k8_launch<3, true>(t, dg, o, n, nwin, k, sa, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D, bool SMALL>
static int k8_info(long n, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fixed_base_kernel<D, SMALL>);
  if (e != cudaSuccess) return (int)e;
  K8Plan p;
  const int rc = k8_plan<D, SMALL>(n > 0 ? n : 1, &p);
  if (rc) return rc;
  const int tile = k8_ngrp<D>() / p.S;
  out[0] = K8_G(D);
  out[1] = K8_THREADS;
  out[2] = K8_MINB;
  out[3] = p.per;
  out[4] = a.numRegs;
  out[5] = (int)a.localSizeBytes;
  out[6] = (int)(k8_smem_bytes<D>() + a.sharedSizeBytes);
  out[7] = tile;
  out[8] = p.S;
  out[9] = k8_pow2(tile);
  out[10] = p.grid;
  return 0;
}

// out[11]: lanes an add, threads a block, minimum blocks, resident blocks per SM, registers, local bytes
// a thread, shared bytes a block, and for n scalars the scalars a tile,
// the splits a scalar, the tree's leaves and the grid, of the
// instantiation for D and small (0 or 1).
extern "C" int pcd_fixed_base_info(int D, int small, long n, int* out) {
  switch (D * 2 + (small ? 1 : 0)) {
    case 2: return k8_info<1, false>(n, out);
    case 3: return k8_info<1, true>(n, out);
    case 4: return k8_info<2, false>(n, out);
    case 5: return k8_info<2, true>(n, out);
    case 6: return k8_info<3, false>(n, out);
    case 7: return k8_info<3, true>(n, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
