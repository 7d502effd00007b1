"""Batched short-Weierstrass point arithmetic of the port: the counterpart
of EC32Ctx and EC32ExtCtx (`pcd_tpu/ops/ec32.py`).

Layout.  A projective point is an int32 tensor (..., 3, d, 10): X, Y, Z,
each d prime components of 10 u32 limbs in Montgomery form (ops/field.py);
d = 1 for G1, 2 (MNT4 Fq2) or 3 (MNT6 Fq3) for G2.  An MSM table row is
(2, d, 10): affine X, Y; bit 31 of X's top limb flags the point at
infinity, which the mixed-add kernel skips (the reference's pad-limb flag,
ec32.py:200-208).  The identity is (0 : 1 : 0).

Four kernels, each behind a wrapper that launches the CUDA kernel for a
CUDA tensor, runs the plain torch version beside it for a CPU tensor, and
raises for anything else:

  madd_accumulate  K1, csrc/madd_accumulate.cu: the stream-MSM lane loop
                   (replaces ec32.py:632-732 and 1224-1330 and the gather
                   at msm_stream.py:261-277);
  complete_add     K2, csrc/complete_add.cu: elementwise complete add
                   (replaces ec32.py:411-444; the finish's yardstick,
                   StreamMSMCtx.finish_steps, still runs on it);
  madd             K3, csrc/madd.cu: elementwise masked mixed add, in
                   place, G1 (replaces ec32.py:527-630);
  bucket_finish    K4, csrc/bucket_finish.cu: the stream-MSM finish, lane
                   accumulators to window sums in one launch (replaces
                   ec32.py:343-409, 457-513, 915-1012, 1152-1222 with the
                   finish glue of msm_stream.py:281-340).

Both formulas are RCB15 (alg. 1 any-a complete add, and its Z2 = 1 mixed
form) with the operation order of ec32._rcb_add / _rcb_maddT_ns, and the
curve constants a, 3b and a^2 come from the curve model (per component for
G2, as ec32._madd_consts).  Each wrapper counts its kernel launches per
curve (`launch_counts`).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from .field import INF_BIT, NLIMB, FieldCtx, ints_to_limbs

_LAUNCHES: Counter = Counter()   # (kernel, curve name) -> CUDA launches
_PLAIN: Counter = Counter()      # (kernel, curve name) -> plain-version calls


def launch_counts() -> dict:
    """{(kernel, curve name): CUDA kernel launches} since the last reset."""
    return dict(_LAUNCHES)


def plain_counts() -> dict:
    """{(kernel, curve name): wrapper calls served by the plain version
    (CPU tensors)} since the last reset."""
    return dict(_PLAIN)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
    _PLAIN.clear()


def _coeffs(e, d):
    return [int(c.n) for c in e.to_prime_coeffs()] if d > 1 else [int(e.n)]


class ECCtx:
    """Point arithmetic for one short-Weierstrass curve over Fp or Fp^d."""

    def __init__(self, curve):
        F = curve.F
        d = F.extension_degree_over_prime()
        nr = 0
        if d > 1:
            assert not hasattr(F.NR, "to_prime_coeffs"), "direct towers only"
            nr = int(F.NR.n)
        self.curve = curve
        self.name = curve.name
        self.d = d
        self.f = FieldCtx(F.prime_subfield().MODULUS, d, nr)
        f = self.f
        b3 = curve.b + curve.b + curve.b
        consts = {nm: _coeffs(e, d) for nm, e in
                  (("a", curve.a), ("b3", b3), ("a2", curve.a * curve.a))}
        # FieldConsts of csrc/field.cuh: p, n0, nr, one, a[3], b3[3], a2[3]
        words = [f.p_limbs, np.array([f.n0, nr], dtype=np.uint32),
                 ints_to_limbs([f.r])[0]]
        for nm in ("a", "b3", "a2"):
            m = np.zeros((3, NLIMB), dtype=np.uint32)
            m[:d] = ints_to_limbs([v * f.r % f.p for v in consts[nm]])
            words.append(m.reshape(-1))
        self.kconsts = np.ascontiguousarray(np.concatenate(words),
                                            dtype=np.uint32)
        self._cvals = consts
        self._cplain = {}
        self._one = {}

    @property
    def point_words(self) -> int:
        return 3 * self.d * NLIMB

    # -- host conversions ---------------------------------------------------
    def table_from_u64(self, xs, ys, inf) -> np.ndarray:
        """Canonical u64 limb coordinates in the C++ tier's EncodedPoints
        layout ((n, d*5) each) -> (n, 2, d, 10) int32 Montgomery table rows,
        infinity rows zeroed and flagged.  The counterpart of
        EC32Ctx.encode_from_limbs (ec32.py:242-301), exact the same way:
        five u64 limbs are ten u32 limbs."""
        n, d = xs.shape[0], self.d
        xy = np.stack([np.ascontiguousarray(c, dtype="<u8").reshape(n * d, -1)
                       for c in (xs, ys)])
        mont = self.f.encode_u64(xy.reshape(2 * n * d, -1))
        tab = np.ascontiguousarray(
            mont.reshape(2, n, d, NLIMB).transpose(1, 0, 2, 3))
        fin = np.asarray(inf, dtype=bool)
        if fin.any():
            tab[fin] = 0
            tab[fin, 0, 0, NLIMB - 1] = np.int32(-INF_BIT)   # bit 31 set
        return tab

    def decode_point(self, P):
        """(3, d, 10) Montgomery limbs -> host curve point."""
        F = self.curve.F
        vals = self.f.decode_ints(np.asarray(P, dtype=np.int32))
        d = self.d
        if d == 1:
            x, y, z = (F(v) for v in vals)
        else:
            prime = F.prime_subfield()
            x, y, z = (F.from_prime_coeffs([prime(v) for v in
                                            vals[k * d:(k + 1) * d]])
                       for k in range(3))
        if z.is_zero():
            return self.curve.infinity()
        zi = z.inv()
        return self.curve.point(x * zi, y * zi)

    def identity(self, shape, device) -> torch.Tensor:
        """(*shape, 3, d, 10) copies of (0 : 1 : 0), built on `device`
        from a cached limb row (no host-to-device copy on the finish's
        hot path)."""
        key = str(device)
        one = self._one.get(key)
        if one is None:
            one = torch.from_numpy(
                ints_to_limbs([self.f.r])[0].view(np.int32)).to(device)
            self._one[key] = one
        out = torch.zeros(tuple(shape) + (3, self.d, NLIMB),
                          dtype=torch.int32, device=device)
        out[..., 1, 0, :] = one
        return out

    # -- plain versions: coordinates are (nd, d, N) digit tensors ---------
    def _consts_plain(self, device):
        key = str(device)
        hit = self._cplain.get(key)
        if hit is None:
            hit = tuple(self.f.plain_const(self._cvals[nm], device)
                        for nm in ("a", "b3", "a2"))
            self._cplain[key] = hit
        return hit

    def _split(self, P):
        """(N, 3, d, 10) -> X, Y, Z as (nd, d, N) plain digit tensors."""
        D = self.f.to_plain(P)                     # (nd, N, 3, d)
        return tuple(D[:, :, k].movedim(-1, 1) for k in range(3))

    def _join(self, X, Y, Z):
        D = torch.stack([c.movedim(1, -1) for c in (X, Y, Z)], dim=2)
        return self.f.from_plain(D)

    def _rcb_tail(self, t0, t1, t2, t3, t4, t5):
        """Shared tail of RCB15 algs. 1-2 (csrc/ec.cuh rcb_tail), its
        independent products batched into one call each."""
        f = self.f
        A, B3, A2 = self._consts_plain(t0.device)
        at4, b3t2, at2, at0, a2t2, b3t4 = f.mul(
            torch.stack([A, B3, A, A, A2, B3], dim=2),
            torch.stack([t4, t2, t2, t0, t2, t4], dim=2)).unbind(2)
        zp = f.add(at4, b3t2)                      # a t4 + 3b t2
        x3 = f.sub(t1, zp)
        z3 = f.add(t1, zp)
        t1n = f.add(f.add(f.add(t0, t0), t0), at2)   # 3 t0 + a t2
        t2n = f.sub(at0, a2t2)                     # a t0 - a^2 t2
        t4n = f.add(b3t4, t2n)                     # 3b t4 + t2n
        y3, q, u, v, w, z = f.mul(
            torch.stack([x3, t1n, t3, t5, t5, t3], dim=2),
            torch.stack([z3, t4n, x3, t4n, z3, t1n], dim=2)).unbind(2)
        Y, Z = f.add(torch.stack([y3, w], dim=2),
                     torch.stack([q, z], dim=2)).unbind(2)
        return f.sub(u, v), Y, Z

    def _rcb_add(self, P, Q):
        f = self.f
        (X1, Y1, Z1), (X2, Y2, Z2) = P, Q
        s = f.add(torch.stack([X1, X1, Y1, X2, X2, Y2], dim=2),
                  torch.stack([Y1, Z1, Z1, Y2, Z2, Z2], dim=2)).unbind(2)
        t0, t1, t2, p3, p4, p5 = f.mul(
            torch.stack([X1, Y1, Z1, s[0], s[1], s[2]], dim=2),
            torch.stack([X2, Y2, Z2, s[3], s[4], s[5]], dim=2)).unbind(2)
        t3, t4, t5 = f.sub(
            f.sub(torch.stack([p3, p4, p5], dim=2),
                  torch.stack([t0, t0, t1], dim=2)),
            torch.stack([t1, t2, t2], dim=2)).unbind(2)
        return self._rcb_tail(t0, t1, t2, t3, t4, t5)

    def _rcb_madd(self, P, x2, y2):
        f = self.f
        X1, Y1, Z1 = P
        s1, s2 = f.add(torch.stack([X1, x2], dim=2),
                       torch.stack([Y1, y2], dim=2)).unbind(2)
        t0, t1, p3, u4, u5 = f.mul(
            torch.stack([X1, Y1, s1, x2, y2], dim=2),
            torch.stack([x2, y2, s2, Z1, Z1], dim=2)).unbind(2)
        t3 = f.sub(f.sub(p3, t0), t1)
        t4, t5 = f.add(torch.stack([u4, u5], dim=2),
                       torch.stack([X1, Y1], dim=2)).unbind(2)
        return self._rcb_tail(t0, t1, Z1, t3, t4, t5)

    def complete_add_plain(self, P, Q):
        """Plain version of K2: (..., 3, d, 10) + (..., 3, d, 10)."""
        shape = P.shape
        flat = (-1, 3, self.d, NLIMB)
        R = self._rcb_add(self._split(P.reshape(flat)),
                          self._split(Q.reshape(flat)))
        return self._join(*R).reshape(shape)

    def _madd_round(self, acc, rows, neg, active):
        """One masked mixed-add round on plain digits: acc (X, Y, Z) +=
        rows (N, 2, d, 10), an affine table rows' copy (modified here),
        with Y negated where neg and the old acc kept where not active or
        the row is flagged infinity."""
        f = self.f
        flagged = rows[:, 0, 0, NLIMB - 1] < 0
        rows[:, 0, 0, NLIMB - 1] &= 0x7FFFFFFF
        D = f.to_plain(rows)                       # (nd, N, 2, d)
        x2 = D[:, :, 0].movedim(-1, 1)
        y2 = D[:, :, 1].movedim(-1, 1)
        y2 = torch.where(neg, f.neg(y2), y2)
        new = self._rcb_madd(acc, x2, y2)
        act = active & ~flagged
        return tuple(torch.where(act, a, b) for a, b in zip(new, acc))

    def madd_accumulate_plain(self, table, perm, loads):
        """Plain version of K1 (see madd_accumulate).  Round t computes
        only the lanes still folding (loads > t); the others keep their
        accumulator, as the kernel's do."""
        nwin, T, L = perm.shape
        acc = self._split(self.identity((nwin * L,), table.device))
        lds = loads.reshape(-1)
        for t in range(T):
            live = torch.nonzero(lds > t).flatten()
            if not live.numel():
                break
            v = (perm[:, t, :].reshape(-1)[live].to(torch.int64)
                 & 0xFFFFFFFF)
            rows = table[v & 0x7FFFFFFF]                         # a copy
            every = torch.ones_like(live, dtype=torch.bool)
            self._put(acc, live, self._madd_round(
                self._take(acc, live), rows, (v >> 31) == 1, every))
        return self._join(*acc).reshape(nwin, L, 3, self.d, NLIMB)

    def madd_plain(self, acc, q, sign, active):
        """Plain version of K3 (see madd): returns the new accumulators
        and leaves acc as it was."""
        out = self._madd_round(self._split(acc), q.clone(), sign != 0,
                               active != 0)
        return self._join(*out).reshape(acc.shape)

    # K4's block: one thread per bucket, at most this many buckets (the
    # kernel's FB; bucket_finish checks that the two agree)
    FINISH_BLOCK = 128

    @staticmethod
    def _take(P, idx):
        return tuple(c[..., idx] for c in P)

    @staticmethod
    def _put(P, idx, V):
        for c, v in zip(P, V):
            c[..., idx] = v

    def _add_at(self, V, i, s):
        """V[i] = V[i] + V[i + s] for the index tensor i (one level of K4,
        every pair read before any is written)."""
        self._put(V, i, self._rcb_add(self._take(V, i),
                                      self._take(V, i + s)))

    def _scan(self, V, n):
        """Inclusive suffix scan within each group of n consecutive points,
        K4's Hillis-Steele levels: V_t += V_{t+s} for t + s < n."""
        t = torch.arange(V[0].shape[-1], device=V[0].device) % n
        s = 1
        while s < n:
            self._add_at(V, torch.nonzero(t + s < n).flatten(), s)
            s *= 2

    def _tree(self, V, n, off):
        """Pairwise sum of the points off..n-1 of each group of n into its
        point off, K4's tree levels: with u = t - off, V_u += V_{u+s} for
        u % 2s == 0 and u + s < n - off."""
        u = torch.arange(V[0].shape[-1], device=V[0].device) % n - off
        s = 1
        while s < n - off:
            self._add_at(V, torch.nonzero(
                (u >= 0) & (u % (2 * s) == 0) & (u + s < n - off)).flatten(),
                s)
            s *= 2

    def bucket_finish_plain(self, accs, bidx, runrem):
        """Plain version of K4 (see bucket_finish): the same adds in the
        same order, each level one batched plain add."""
        nwin, L = accs.shape[:2]
        B = bidx.shape[1]
        dev = accs.device
        U = self._split(accs.reshape(-1, 3, self.d, NLIMB))
        rr = runrem.reshape(-1)
        # (1) each bucket's run of lanes, pairwise into its first lane:
        # rl = a lane's position in its run (the last run start at or
        # before it; unused lanes have rr = 0 and never add)
        heads = bidx.reshape(-1).long()
        heads = heads[heads < nwin * L]
        first = torch.zeros(nwin * L, dtype=torch.long, device=dev)
        first[heads] = heads
        rl = torch.arange(nwin * L, device=dev) - torch.cummax(first, 0)[0]
        top = int(rr.max()) if rr.numel() else 0
        s = 1
        while s < top:
            self._add_at(U, torch.nonzero((rl % (2 * s) == 0) & (rr > s))
                         .flatten(), s)
            s *= 2
        # (2) per block of nb buckets: suffix scan C_t, then
        # W = sum_{t >= 1} C_t = sum_t t S_t, and S = C_0
        ident = self._split(self.identity((1,), dev))
        V = self._take(tuple(torch.cat([u, e], dim=-1)
                             for u, e in zip(U, ident)),
                       bidx.reshape(-1).long())
        nb = min(B, self.FINISH_BLOCK)
        nblk = B // nb
        self._scan(V, nb)
        self._tree(V, nb, 1)
        pos = torch.arange(nwin * B, device=dev) % nb
        S = self._take(V, torch.nonzero(pos == 0).flatten())
        W = self._take(V, torch.nonzero(pos == 1).flatten())
        # (3) per window: sum_k W_k + sum_k S_k + nb sum_k k S_k, the last
        # as a suffix scan E_k of the S_k, Y = sum_{k >= 1} E_k and
        # log2(nb) doublings
        self._scan(S, nblk)
        self._tree(S, nblk, 1)
        self._tree(W, nblk, 0)
        k = torch.arange(nwin * nblk, device=dev) % nblk
        first = torch.nonzero(k == 0).flatten()
        tot = self._rcb_add(self._take(W, first), self._take(S, first))
        if nblk > 1:
            Z = self._take(S, torch.nonzero(k == 1).flatten())
            for _ in range(nb.bit_length() - 1):
                Z = self._rcb_add(Z, Z)
            tot = self._rcb_add(tot, Z)
        return self._join(*tot).reshape(nwin, 3, self.d, NLIMB)

    # -- kernel wrappers ----------------------------------------------------
    def _check(self, t, shape_tail, what):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{what}: contiguous int32 expected")
        if tuple(t.shape[-len(shape_tail):]) != shape_tail:
            raise ValueError(f"{what}: trailing shape {shape_tail} expected, "
                             f"got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: 16-byte aligned storage expected")

    def madd_accumulate(self, table, perm, loads):
        """K1.  table (m, 2, d, 10) affine rows; perm (nwin, T, L) int32
        (row index in bits 0-30, digit sign in bit 31); loads (nwin, L)
        int32 active rounds per lane.  Returns the (nwin, L, 3, d, 10)
        lane accumulators, each started at the identity, after every lane
        folded perm[w, t, lane] for t < loads[w, lane], skipping flagged
        rows."""
        dev = table.device
        if dev.type == "cpu":
            _PLAIN[("madd_accumulate", self.name)] += 1
            return self.madd_accumulate_plain(table, perm, loads)
        if dev.type != "cuda":
            raise ValueError(f"madd_accumulate: unsupported device {dev}")
        nwin, T, L = perm.shape
        self._check(table, (2, self.d, NLIMB), "table")
        for t, nm in ((perm, "perm"), (loads, "loads")):
            if t.device != dev or t.dtype != torch.int32 \
                    or not t.is_contiguous():
                raise ValueError(f"{nm}: contiguous int32 on {dev} expected")
        if tuple(loads.shape) != (nwin, L):
            raise ValueError("loads: (nwin, L) expected")
        from .kernels import lib

        out = torch.empty((nwin, L, 3, self.d, NLIMB), dtype=torch.int32,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib("madd_accumulate").pcd_madd_accumulate(
            self.d, table.data_ptr(), perm.data_ptr(), loads.data_ptr(),
            out.data_ptr(), nwin * L, T, L,
            self.kconsts.ctypes.data_as(ctypes.c_void_p), stream)
        if rc != 0:
            raise RuntimeError(f"madd_accumulate launch failed: CUDA error "
                               f"{rc}")
        _LAUNCHES[("madd_accumulate", self.name)] += 1
        return out

    def bucket_finish(self, accs, bidx, runrem):
        """K4.  accs (nwin, L, 3, d, 10) lane accumulators (K1's output,
        not modified); bidx (nwin, B) int32 global first lane of each
        bucket (sentinel nwin * L: empty), its lanes a run in bucket
        order; runrem (nwin, L) int32 lanes left in the lane's run (0 on
        an unused lane).  Returns the (nwin, 3, d, 10) window sums
        sum_b b S_b, b = 1..B, S_b the sum of bucket b's lanes."""
        dev = accs.device
        nwin, L = accs.shape[:2]
        B = bidx.shape[1]
        if tuple(bidx.shape) != (nwin, B) or B < 2 or B & (B - 1):
            raise ValueError("bucket_finish: bidx must be (nwin, B), B a "
                             "power of two >= 2")
        if tuple(runrem.shape) != (nwin, L):
            raise ValueError("bucket_finish: runrem must be (nwin, L)")
        if dev.type == "cpu":
            _PLAIN[("bucket_finish", self.name)] += 1
            return self.bucket_finish_plain(accs, bidx, runrem)
        if dev.type != "cuda":
            raise ValueError(f"bucket_finish: unsupported device {dev}")
        self._check(accs, (L, 3, self.d, NLIMB), "accs")
        for t, nm in ((bidx, "bidx"), (runrem, "runrem")):
            if t.device != dev or t.dtype != torch.int32 \
                    or not t.is_contiguous():
                raise ValueError(f"{nm}: contiguous int32 on {dev} expected")
        from .kernels import lib

        L4 = lib("bucket_finish")
        if L4.pcd_finish_block() != self.FINISH_BLOCK:
            raise RuntimeError("bucket_finish: the kernel's block size is "
                               "not ECCtx.FINISH_BLOCK")
        nblk = B // min(B, self.FINISH_BLOCK)
        out = torch.empty((nwin, 3, self.d, NLIMB), dtype=torch.int32,
                          device=dev)
        scratch = torch.empty_like(accs)
        part = torch.empty((nwin, nblk, 2, 3, self.d, NLIMB),
                           dtype=torch.int32, device=dev)
        done = torch.empty((nwin,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L4.pcd_bucket_finish(
            self.d, accs.data_ptr(), bidx.data_ptr(), runrem.data_ptr(),
            scratch.data_ptr(), part.data_ptr(),
            done.data_ptr(), out.data_ptr(), nwin, L, B,
            self.kconsts.ctypes.data_as(ctypes.c_void_p), stream)
        if rc != 0:
            raise RuntimeError(f"bucket_finish launch failed: CUDA error "
                               f"{rc}")
        _LAUNCHES[("bucket_finish", self.name)] += 1
        return out

    def add(self, P, Q):
        """K2: elementwise complete add of (..., 3, d, 10) point tensors."""
        dev = P.device
        if Q.device != dev or P.shape != Q.shape:
            raise ValueError("complete_add: P and Q differ in device/shape")
        if dev.type == "cpu":
            _PLAIN[("complete_add", self.name)] += 1
            return self.complete_add_plain(P, Q)
        if dev.type != "cuda":
            raise ValueError(f"complete_add: unsupported device {dev}")
        self._check(P, (3, self.d, NLIMB), "P")
        self._check(Q, (3, self.d, NLIMB), "Q")
        from .kernels import lib

        out = torch.empty_like(P)
        n = P.numel() // self.point_words
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib("complete_add").pcd_complete_add(
            self.d, P.data_ptr(), Q.data_ptr(), out.data_ptr(), n,
            self.kconsts.ctypes.data_as(ctypes.c_void_p), stream)
        if rc != 0:
            raise RuntimeError(f"complete_add launch failed: CUDA error {rc}")
        _LAUNCHES[("complete_add", self.name)] += 1
        return out

    def madd(self, acc, q, sign, active):
        """K3: acc (n, 3, d, 10) += q (n, 2, d, 10) affine rows, in place
        and row by row: Y negated where sign (n,) is nonzero, the old acc
        kept where active (n,) is zero or the row is flagged infinity.
        Complete for acc = identity and acc = +-q.  Returns acc.  The
        CUDA kernel is built for G1 (d = 1), EC32Ctx.madd's only form."""
        dev = acc.device
        n = acc.shape[0]
        if q.device != dev or tuple(q.shape) != (n, 2, self.d, NLIMB):
            raise ValueError("madd: q must be (n, 2, d, 10) on acc's device")
        for t, nm in ((sign, "sign"), (active, "active")):
            if t.device != dev or tuple(t.shape) != (n,):
                raise ValueError(f"madd: {nm} must be (n,) on {dev}")
        if dev.type == "cpu":
            _PLAIN[("madd", self.name)] += 1
            acc.copy_(self.madd_plain(acc, q, sign, active))
            return acc
        if dev.type != "cuda":
            raise ValueError(f"madd: unsupported device {dev}")
        if self.d != 1:
            raise ValueError("madd: the kernel is built for G1 (d = 1)")
        self._check(acc, (3, 1, NLIMB), "acc")
        self._check(q, (2, 1, NLIMB), "q")
        for t, nm in ((sign, "sign"), (active, "active")):
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError(f"madd: {nm}: contiguous int32 expected")
        from .kernels import lib

        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib("madd").pcd_madd(
            self.d, acc.data_ptr(), q.data_ptr(), sign.data_ptr(),
            active.data_ptr(), n, self.kconsts.ctypes.data_as(
                ctypes.c_void_p), stream)
        if rc != 0:
            raise RuntimeError(f"madd launch failed: CUDA error {rc}")
        _LAUNCHES[("madd", self.name)] += 1
        return acc


@lru_cache(maxsize=None)
def ec_ctx(curve) -> ECCtx:
    return ECCtx(curve)
