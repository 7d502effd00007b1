"""The sharded Groth16 prover's data plane: the counterpart of
`pcd_tpu/parallel/dist.py` (DistHPoly, DistMatVec, DistContext) on
torch.distributed and the port's kernels.

Quotient (DistHPoly), every rank on its own blocks, no host round trip:
  A z, B z, C z on H, natural blocks --inverse 4-step-->  sigma coefficients
  --coset scale g^i (K7)-->  --forward 4-step-->  coset evaluations,
  natural blocks --(a b - c) Z_H^-1 (K7)-->  --inverse 4-step-->  --scale
  g^-i as plain residues (K7)-->  h, canonical, sigma block.
The 4-step's stages (parallel/fft.py) are K5 for the n1 and n2
transforms, K7 for the twiddles and two all_to_alls a transform; the
forward one is the inverse one's stages undone (`to_natural`), so no
global reorder is ever built.  Sigma position (k1, k2) holds coefficient
k2 n1 + k1.

Matvec (DistMatVec): K6 over this rank's rows.  Any partition of the rows
gives the same products, so for the prover each rank takes exactly the
rows of the quotient's natural input block (rows i n2 + j, j in its
column block): A z, B z and C z stay on the rank.  The reference's
contiguous row ranges stay for the standalone API.  The replayed-witness
check runs on each rank's rows, its flag is all-gathered and every rank
raises together, so no rank waits in a collective for one that raised.

DistContext(mesh) is what a prover's `.dist` holds: the sharded stream
MSMs, with this rank's tables cached on the pk by (query, device, rank,
size, layout) where the reference keys on id(points); `h_poly(F, N)`, a
DistHPoly per (F, N, size) with its tables, or None when N has no split
for this size (the prover then runs the unsharded device quotient on
every rank, the reference's behaviour); and `matvec`.  The reference's
`_padded_query` and `msm` serve its legacy scan MSM, which the port does
not have.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.field import NLIMB
from .fft import FourStep
from .mesh import Mesh


def _split(N: int, ndev: int):
    """N = n1*n2 with ndev | n1 and ndev | n2, n1 as square as possible."""
    best = None
    for n1 in range(ndev, N + 1):
        if N % n1:
            continue
        n2 = N // n1
        if n1 % ndev or n2 % ndev:
            continue
        score = abs(n1 - n2)
        if best is None or score < best[0]:
            best = (score, n1, n2)
    if best is None:
        raise ValueError(f"no (n1, n2) split of {N} for {ndev} devices")
    return best[1], best[2]


class SigmaH(NamedTuple):
    """A quotient h held as this rank's sigma block: `limbs` (m1 n2, 10)
    canonical on the rank's device, `dh` the DistHPoly that made it."""
    limbs: torch.Tensor
    dh: "DistHPoly"


class DistHPoly:
    """Sharded (A B - C) / Z_H coset pipeline of an N-point domain of F."""

    def __init__(self, F, N: int, mesh: Mesh):
        n1, n2 = _split(N, mesh.size)
        self.F, self.N, self.mesh = F, N, mesh
        self.n1, self.n2 = n1, n2
        self.fs = fs = FourStep(F, n1, n2, mesh)
        self.f = f = fs.f
        dom = fs.domain
        p = F.MODULUS
        g = dom.coset_shift
        self.tw_f = fs.table_stage(dom.omega)
        self.tw_i = fs.table_stage(dom.omega_inv)
        # the coset scales act on coefficients, which live in sigma order;
        # g^-i as plain residues leaves h canonical
        self.coset_s = fs.table_sigma(g, f.r)
        self.coset_inv_plain = fs.table_sigma(pow(g, -1, p), 1)
        self.zh_inv = f.mont(pow(dom.vanishing_poly_at(g), -1, p),
                             mesh.device)

    def h_block(self, evs) -> torch.Tensor:
        """evs: (3, n1 m2, 10) Montgomery evaluations of A z, B z, C z on
        this rank's natural block -> h's sigma block, (m1 n2, 10)
        canonical."""
        fs, f = self.fs, self.f
        X = evs.reshape(3, self.n1, fs.m2, NLIMB)
        S = fs.to_sigma(X, self.tw_i, inverse=True)
        S = f.vmul(S.reshape(3, -1, NLIMB), self.coset_s)
        E = fs.to_natural(S.reshape(3, fs.m1, self.n2, NLIMB),
                          self.tw_f).reshape(3, -1, NLIMB)
        P = f.abc(E[0], E[1], E[2], self.zh_inv)
        H = fs.to_sigma(P.reshape(1, self.n1, fs.m2, NLIMB), self.tw_i,
                        inverse=True)
        return f.vmul(H.reshape(-1, NLIMB), self.coset_inv_plain)

    def encode_evals(self, evals) -> torch.Tensor:
        """Evaluations (at most N, all of them on every rank) -> this
        rank's natural block (n1 m2, 10), Montgomery."""
        f = self.f
        vals = list(evals) + [0] * (self.N - len(evals))
        return self.fs.upload([int(vals[i]) * f.r % f.p
                               for i in self.fs.natural_index()])

    def gather(self, blk) -> torch.Tensor:
        """h's sigma block -> all N coefficients in natural order, (N, 10)
        canonical, on every rank."""
        return self.fs.gather_natural(blk)

    def h_poly(self, a_ev, b_ev, c_ev) -> list:
        """Host evaluation lists (every rank passes all of them) -> the
        host list of h's N coefficients, on every rank."""
        evs = torch.stack([self.encode_evals(v) for v in (a_ev, b_ev, c_ev)])
        h = self.gather(self.h_block(evs)).cpu().numpy()
        from ..ops.field import limbs_to_ints

        return limbs_to_ints(h)


class DistMatVec:
    """Row-sharded sparse matvec: K6 over this rank's rows of the three
    R1CS matrices, z (all columns, Montgomery) on every rank.

    rows: the (a_lc, b_lc, c_lc) dicts in column index space, n_rows >=
    len(rows) (rows past them are zero).  local: this rank's global row
    indices, ascending; None: the contiguous range r ceil(n_rows / size)
    onwards (the reference's partition, the last range cut at n_rows)."""

    def __init__(self, F, rows, n_rows: int, n_cols: int, mesh: Mesh,
                 local=None):
        from ..ops.matvec_tensor import SparseMatVec

        self.mesh = mesh
        if local is None:
            rpd = -(-n_rows // mesh.size)
            local = np.arange(mesh.rank * rpd,
                              min((mesh.rank + 1) * rpd, n_rows))
        self.local = local = np.asarray(local, dtype=np.int64)
        p = F.MODULUS
        coo = [([], [], []) for _ in range(3)]
        for li, g in enumerate(local):
            if g >= len(rows):
                continue
            for k in range(3):
                ri, ci, vi = coo[k]
                for c, v in sorted(rows[g][k].items()):
                    if v % p:
                        ri.append(li)
                        ci.append(c)
                        vi.append(v % p)
        self.mats = tuple(SparseMatVec(F, ri, ci, vi, len(local), n_cols,
                                       mesh.device) for ri, ci, vi in coo)
        self.f = self.mats[0].f
        self._masks = {}

    def apply_all(self, z_mont) -> torch.Tensor:
        """z (n_cols, 10) Montgomery on the rank's device -> (3, rows of
        this rank, 10) Montgomery row sums: K6 once a matrix."""
        out = torch.empty((3, len(self.local), NLIMB), dtype=torch.int32,
                          device=z_mont.device)
        for k, m in enumerate(self.mats):
            m.apply(z_mont, out=out[k])
        return out

    def check(self, evs, n_cons: int) -> None:
        """The replayed-witness check: raises ValueError on every rank
        when a z b z != c z on a row below n_cons of any rank (K7 on this
        rank's rows, the flag all-gathered)."""
        mask = self._masks.get(n_cons)
        if mask is None:
            mask = torch.from_numpy(self.local < n_cons).to(evs.device)
            self._masks[n_cons] = mask
        f = self.f
        bad = f.abc(evs[0], evs[1], evs[2], f.mont(1, evs.device))
        if self.mesh.any(((bad != 0).any(-1) & mask).any()):
            raise ValueError("unsatisfied constraint (replayed witness)")


class DistContext:
    """Mesh-wide prover context: sharded stream MSMs, the sharded
    quotient and matvec, injected into Groth16 by `prover.dist =
    DistContext(mesh)` on every rank."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.ndev = mesh.size
        self._smsm = {}
        self._h_cache = {}
        # (F name, N) of every quotient that ran unsharded (no split)
        self.unsharded = []

    # -- sharded stream MSMs ----------------------------------------------
    def sharded_msm(self, curve, scalar_bits: int):
        """The ShardedStreamMSM of (curve, scalar_bits) at msm_dispatch's
        window bits and lanes (the single-card path's)."""
        from ..snark import msm_dispatch
        from .stream_dist import ShardedStreamMSM

        key = (curve, scalar_bits, msm_dispatch.WINDOW_BITS,
               msm_dispatch.LANES)
        hit = self._smsm.get(key)
        if hit is None:
            hit = ShardedStreamMSM(curve, scalar_bits, self.mesh,
                                   c=key[2], lanes=key[3])
            self._smsm[key] = hit
        return hit

    def stream_table(self, pk, nm: str, curve, scalar_bits: int,
                     layout=None):
        """This rank's shard of pk.<nm> on the rank's device, cached on the
        pk by (nm, device, rank, size, layout).  layout None: the
        contiguous shard; a DistHPoly: the h-query rows of its sigma block
        (index N - 1 and up an infinity row).  The table must have the C++
        tier's encoding, as on one card."""
        from ..native import EncodedPoints
        from ..ops.msm_stream import stream_ok
        from ..snark.msm_dispatch import host_query

        if not stream_ok(curve):
            raise ValueError(f"stream MSM: unsupported coordinate field of "
                             f"{curve.name}")
        smsm = self.sharded_msm(curve, scalar_bits)
        tables = getattr(pk, "_stream_tables", None)
        if tables is None:
            tables = {}
            pk._stream_tables = tables
        lkey = None if layout is None else ("sigma", layout.n1, layout.n2)
        key = (nm, str(self.mesh.device), self.mesh.rank, self.ndev, lkey)
        hit = tables.get(key)
        if hit is None:
            enc = host_query(pk, nm)
            if not isinstance(enc, EncodedPoints):
                raise RuntimeError(f"stream MSM: {nm} has no native encoding "
                                   f"(the C++ tier is required)")
            if layout is None:
                rows = smsm.shard_rows(len(enc))
            else:
                rows = layout.fs.sigma_index()
                rows[rows >= len(enc)] = -1
            hit = smsm.table_at(enc.xs, enc.ys, enc.inf, rows)[0]
            tables[key] = hit
        return smsm, hit

    def stream_msm_async(self, pk, nm: str, curve, scalar_bits: int,
                         scalars, sched_stream=None, sched_cache=None):
        """Enqueue this rank's share of one query MSM: scalars are all of
        the query's ((n, NL) u64 host limbs, or (n, 10) device limbs,
        truncated to the table's n) or a SigmaH, whose block meets the
        h-query rows of its layout.  Returns a future for
        stream_collect."""
        if isinstance(scalars, SigmaH):
            smsm, table = self.stream_table(pk, nm, curve, scalar_bits,
                                            scalars.dh)
            local = scalars.limbs
        else:
            smsm, table = self.stream_table(pk, nm, curve, scalar_bits)
            qn = len(getattr(pk, nm))
            if scalars.shape[0] < qn:
                raise ValueError(f"stream MSM {nm}: {scalars.shape[0]} "
                                 f"scalars for {qn} points")
            local = smsm.shard_scalars(scalars[:qn])
        return smsm, smsm.window_sums_async(table, local, sched_stream,
                                            sched_cache)

    @staticmethod
    def stream_collect(fut):
        """All ranks' MSM from a stream_msm_async future: the gather and
        the Horner tail (every rank calls it in the same order)."""
        smsm, f = fut
        return smsm.collect(f)

    def stream_launch(self, pk, queries, scalar_bits: int, z_limbs,
                      sched_stream=None) -> dict:
        """Enqueue the (name, curve) queries' MSMs against z_limbs, one
        shared schedule of this rank's scalars; returns {name: future}."""
        cache = {}
        return {nm: self.stream_msm_async(pk, nm, curve, scalar_bits,
                                          z_limbs, sched_stream, cache)
                for nm, curve in queries}

    def stream_msm(self, pk, nm: str, curve, scalar_bits: int, scalars):
        """Point-sharded stream MSM of pk.<nm> (a host point list, its
        table cached on pk) against int scalars; the host point."""
        smsm = self.sharded_msm(curve, scalar_bits)
        nbytes = (scalar_bits + 63) // 64 * 8
        limbs = smsm.sctx.limb_rows([int(s) for s in scalars], nbytes)
        return self.stream_collect(self.stream_msm_async(
            pk, nm, curve, scalar_bits, limbs))

    # -- quotient and matvec ------------------------------------------------
    def h_poly(self, F, N: int):
        """The DistHPoly of (F, N), built once with its tables, or None
        when N has no (n1, n2) split with both factors divisible by the
        size."""
        key = (F.MODULUS, N, self.ndev)
        if key not in self._h_cache:
            try:
                _split(N, self.ndev)
            except ValueError:
                self._h_cache[key] = None
            else:
                self._h_cache[key] = DistHPoly(F, N, self.mesh)
        return self._h_cache[key]

    def matvec(self, F, rows, n_rows: int, n_cols: int, layout=None):
        """DistMatVec over this rank's rows: the contiguous range, or with
        `layout` (a DistHPoly) the rows of its natural block."""
        local = None if layout is None else layout.fs.natural_index()
        return DistMatVec(F, rows, n_rows, n_cols, self.mesh, local)

    def prover_matvec(self, pk, F, rows, n_rows: int, n_cols: int, layout):
        """`matvec` on the rows of `layout`'s natural block for the
        prover's quotient, built once per pk and cached there
        (partitioning touches every entry)."""
        cache = getattr(pk, "_dist_mats", None)
        if cache is None:
            cache = {}
            pk._dist_mats = cache
        key = (str(self.mesh.device), self.mesh.rank, self.ndev, n_rows,
               layout.n1)
        if key not in cache:
            cache[key] = self.matvec(F, rows, n_rows, n_cols, layout)
        return cache[key]
