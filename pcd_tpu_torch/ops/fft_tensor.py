"""Mixed-radix NTT over prime-field limb tensors, and the provers' device
quotient: the counterpart of `pcd_tpu/ops/fft_tensor.py` (FFTTensorCtx,
fft_ctx).

The plan is the reference's: the domain's prime factors (radixes 2..31,
poly/domain.py) taken bottom-up as levels (r, m), each building transforms
of length r m from r transforms of length m, after a mixed-radix digit
reversal of the input (the reference's `_plan` and `_input_permutation`,
here `plan` and `input_permutation`), with one table of
root powers per direction and two coset tables.  Values are (batch, n,
10) int32 Montgomery tensors in the layout of ops/field.py.

`passes` groups the levels into runs whose radixes multiply to at most
a tile of points (`ntt_tile`: 256 up to 2^17 points, else 512); on a card each run is one launch of K5 `ntt_pass`
(csrc/ntt.cu), which holds a block's lines in shared memory through all
of the run's levels; the digit reversal is folded into the first pass's
loads, and the passes alternate between two buffers.  The pointwise
steps around a transform run in K5 too: a prologue on the first pass's
loads (a product by a table or a scalar, or (a b - c) s of three batch
rows) and an epilogue on the last pass's stores (a product by a table or
a scalar), so `ifft` scales by n^-1, `coset_fft` by the coset table and
`coset_ifft` by n^-1 g^-i in the transform's own launches.  On the CPU a
pass runs its prologue, its levels and its epilogue as plain versions in
turn, the reference's `_transform` stage in torch on the plain products
of ops/field.py.

`hpoly` is the quotient h = (A B - C) / Z_H on a coset, the arguments and
meaning of the C++ tier's `native.hpoly` with the evaluations already on
the device, in three transforms: inverse with the epilogue n^-1 g^i (the
reference's ifft then coset_fft scaling), forward, and inverse with the
prologue (a b - c) Z_H^-1 and the epilogue n^-1 g^-i held as plain
residues, which leaves h canonical; `b is a` is GM17's squaring case.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..poly.domain import EvaluationDomain
from .field import _LAUNCHES, _PLAIN, NLIMB, FieldCtx, ints_to_limbs


def level_twiddles(n: int, r: int, m: int) -> np.ndarray:
    """Twiddle rows of level (r, m) of an n-point transform, (r, r m)
    int64: row j, column k holds (stride j k) mod n, stride = n / (r m),
    computed as K5 computes it: stride ((j k) mod r m), the residue
    stepped over j by adding k and subtracting r m once."""
    nl = r * m
    k = np.arange(nl, dtype=np.int64)
    e = np.zeros(nl, dtype=np.int64)
    rows = [e]
    for _ in range(1, r):
        e = e + k
        e = np.where(e >= nl, e - nl, e)
        rows.append(e)
    return np.stack(rows) * (n // nl)


def plan(factors) -> list:
    """Bottom-up levels [(r, m)] of a transform over the domain's prime
    factors (ascending): level (r, m) transforms length r m from r
    transforms of length m.  The recursion splits by the smallest factor
    first, so execution runs the factors reversed."""
    levels, m = [], 1
    for r in reversed(factors):
        levels.append((r, m))
        m *= r
    return levels


# points a block of K5 holds in shared memory (40 bytes each; at most
# NTT_MAX_TILE, 4096, of csrc/ntt.cu): NTT_TILE, or NTT_TILE_SMALL for a
# domain of at most NTT_SMALL_N points, where a pass of NTT_TILE-point
# blocks would not fill the card; csrc/ntt.cu's header says why
NTT_TILE, NTT_TILE_SMALL, NTT_SMALL_N = 512, 256, 1 << 17
# K5's prologue and epilogue modes (csrc/ntt.cu)
PRO_NONE, PRO_MUL, PRO_ABC = 0, 1, 2
EPI_NONE, EPI_MUL = 0, 1


def ntt_tile(n: int) -> int:
    """The K5 tile of an n-point domain."""
    return NTT_TILE_SMALL if n <= NTT_SMALL_N else NTT_TILE


class NttPass(NamedTuple):
    """The geometry of one K5 launch: the levels of the plan it runs and
    how its blocks cut the points (csrc/ntt.cu's header)."""
    M: int          # base stride: the transforms' length before the pass
    Q: int          # points a line: the product of the pass's radixes
    C: int          # lines a block
    levels: tuple   # per level (r, m / M, n_l = r m, stride = n / n_l)

    @property
    def points(self) -> int:
        """Points a block loads (the last block may hold fewer lines)."""
        return self.C * self.Q

    def geom(self) -> np.ndarray:
        """The int32 array the kernel's C entry takes."""
        flat = [self.M, self.Q, self.C, len(self.levels)]
        for lv in self.levels:
            flat += lv
        return np.asarray(flat, dtype=np.int32)


def passes(n: int, levels, tile: int | None = None) -> list:
    """The plan's bottom-up `levels` [(r, m)] of an n-point transform cut
    into K5 passes: each takes the next levels while their radixes
    multiply to at most `tile` (by default ntt_tile(n)), and its blocks
    hold tile // Q lines."""
    tile = ntt_tile(n) if tile is None else tile
    out, i = [], 0
    while i < len(levels):
        M, Q, lv = levels[i][1], 1, []
        while i < len(levels) and Q * levels[i][0] <= tile:
            r, m = levels[i]
            lv.append((r, m // M, r * m, n // (r * m)))
            Q *= r
            i += 1
        if not lv:
            raise ValueError(f"ntt_pass: radix {levels[i][0]} exceeds the "
                             f"tile of {tile} points")
        out.append(NttPass(M, Q, tile // Q, tuple(lv)))
    return out


def input_permutation(n: int, factors) -> np.ndarray:
    """(n,) int32 digit-reversal permutation matching the recursive
    decimation: mixed radix over `factors`, not a bit reversal."""
    def rec(ix, fs):
        if not fs:
            return ix
        r = fs[0]
        return np.concatenate([rec(ix[j::r], fs[1:]) for j in range(r)])

    return np.asarray(rec(np.arange(n), list(factors)), dtype=np.int32)


class FFTTensorCtx:
    """The transforms of one domain of `size` points of F, on `device`."""

    def __init__(self, F, size: int, device):
        self.domain = d = EvaluationDomain(F, size)
        self.n = size
        self.device = torch.device(device)
        self.f = FieldCtx(F.MODULUS, name=F.NAME)
        self.levels = plan(d.factors)
        self.passes = passes(size, self.levels)
        self.perm = torch.from_numpy(input_permutation(size, d.factors)).to(
            self.device)
        # root power tables and the scalings K5's prologues and epilogues
        # take (Montgomery form unless said otherwise); g the coset shift
        f, dev = self.f, self.device
        self.tbl_fwd = self._pow_table(d.omega)
        self.tbl_inv = self._pow_table(d.omega_inv)
        self.n_inv = f.mont(d.n_inv, dev)
        self.coset_tbl = self._pow_table(d.coset_shift)           # g^i
        # n^-1 g^i: ifft's scaling and then coset_fft's, in one product
        self.ninv_coset_tbl = self._pow_table(d.coset_shift, self.n_inv)
        # n^-1 g^-i: coset_ifft's; as plain residues (not times R) its
        # product leaves the result canonical
        self.ninv_coset_inv_tbl = self._pow_table(d.coset_shift_inv,
                                                  self.n_inv)
        self.ninv_coset_inv_plain = self._pow_table(
            d.coset_shift_inv, f.const(d.n_inv, dev))

    def _pow_table(self, w: int, first=None) -> torch.Tensor:
        """(n, 10) first w^i, i < n, first a (1, 10) element (Montgomery
        1 by default), built on the device by doubling: rows [s, 2 s) are
        rows [0, s) times w^s (K7)."""
        f, dev, n = self.f, self.device, self.n
        t = torch.empty((n, NLIMB), dtype=torch.int32, device=dev)
        t[0] = (f.mont(1, dev) if first is None else first)[0]
        s = 1
        while s < n:
            k = min(s, n - s)
            t[s:s + k] = f.vmul(t[:k], f.mont(pow(w, s, f.p), dev))
            s += k
        return t

    # -- K5 -------------------------------------------------------------------
    def ntt_pass(self, src, tbl, perm, ps: NttPass, out=None, pre=None,
                 abc=None, post=None):
        """K5: the levels of pass `ps` on src (batch, n, 10) against the
        root table tbl (n, 10), the input read through perm (n,) int32
        when given (the first pass); into `out` (a buffer other than src)
        or a new tensor.  Prologue (a pass at M = 1), at most one of:
        `pre` a (1 or n, 10) table P, the point of source index a loaded
        as x_a P[a]; `abc` one element s (1, 10), src then (3, n, 10)
        rows A, B, C or (2, n, 10) rows A, C with B = A, each point loaded
        as (x_A x_B - x_C) s into a batch of one.  Epilogue: `post` a (1
        or n, 10) table E, the point of destination index i stored as
        x_i E[i]."""
        batch = self._check_pass(src, tbl, perm, ps, pre, abc, post)
        dev = src.device
        key = ("ntt_pass", self.f.name)
        if dev.type == "cpu":
            _PLAIN[key] += 1
            res = self.ntt_pass_plain(src, tbl, perm, ps, pre, abc, post)
            if out is None:
                return res
            out.copy_(res)
            return out
        if dev.type != "cuda":
            raise ValueError(f"ntt_pass: unsupported device {dev}")
        shape = (batch,) + tuple(src.shape[1:])
        if out is None:
            out = src.new_empty(shape)
        ends = tuple(t for t in (perm, pre, abc, post) if t is not None)
        for t in (src, tbl, out) + ends:
            if t.device != dev or t.dtype != torch.int32 \
                    or not t.is_contiguous() or t.data_ptr() % 8:
                raise ValueError(f"ntt_pass: contiguous int32 on {dev} "
                                 f"expected")
        if tuple(out.shape) != shape or out.data_ptr() == src.data_ptr():
            raise ValueError("ntt_pass: out must be a distinct buffer of "
                             "the output's shape")
        from .kernels import lib

        if abc is not None:
            pro, pv, np_ = PRO_ABC, abc, src.shape[0]
        elif pre is not None:
            pro, pv, np_ = PRO_MUL, pre, pre.shape[0]
        else:
            pro, pv, np_ = PRO_NONE, None, 0
        epi, ne = (EPI_NONE, 0) if post is None else (EPI_MUL, post.shape[0])
        geom = ps.geom()
        rc = lib("ntt").pcd_ntt_pass(
            src.data_ptr(), out.data_ptr(), tbl.data_ptr(),
            None if perm is None else perm.data_ptr(), self.n, batch,
            geom.ctypes.data_as(ctypes.c_void_p),
            self.f.kconsts.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream,
            pro, None if pv is None else pv.data_ptr(), np_,
            epi, None if post is None else post.data_ptr(), ne)
        if rc != 0:
            raise RuntimeError(f"ntt_pass launch failed: CUDA error {rc}")
        _LAUNCHES[key] += 1
        return out

    def _check_pass(self, src, tbl, perm, ps, pre, abc, post) -> int:
        """Raises ValueError on operands K5 does not take; returns the
        output's batch."""
        n = self.n
        if src.dim() != 3 or src.shape[1] != n or tuple(tbl.shape) != (
                n, NLIMB) or n % (ps.M * ps.Q) or (perm is not None
                                                   and ps.M != 1):
            raise ValueError("ntt_pass: src (batch, n, 10), tbl (n, 10), "
                             "M Q dividing n, perm only at M = 1")
        for name, t in (("pre", pre), ("post", post)):
            if t is not None and (t.dim() != 2 or t.shape[0] not in (1, n)
                                  or t.shape[1] != NLIMB):
                raise ValueError(f"ntt_pass: {name} must be (1, 10) or "
                                 f"(n, 10), n = {n}")
        if (pre is not None or abc is not None) and ps.M != 1:
            raise ValueError("ntt_pass: a prologue only at M = 1")
        if abc is None:
            return src.shape[0]
        if pre is not None or tuple(abc.shape) != (1, NLIMB) \
                or src.shape[0] not in (2, 3):
            raise ValueError("ntt_pass: abc is one (1, 10) element on a "
                             "(3 or 2, n, 10) src, and excludes pre")
        return 1

    def ntt_pass_plain(self, src, tbl, perm, ps: NttPass, pre=None,
                       abc=None, post=None):
        """The plain version of K5: the prologue, the pass's levels in
        turn, the epilogue."""
        f = self.f
        if abc is not None:
            src = f.abc_plain(src[0], src[1 if src.shape[0] == 3 else 0],
                              src[-1], abc)[None]
        elif pre is not None:
            src = f.vmul_plain(src, pre)
        for r, ml, _, _ in ps.levels:
            src = self.ntt_level_plain(src, tbl, perm, r, ml * ps.M)
            perm = None
        return src if post is None else f.vmul_plain(src, post)

    def ntt_level_plain(self, src, tbl, perm, r: int, m: int):
        """One level (r, m) of K5's plain version: the reference's stage,
        out[g, k] = sum_j T[idx[j, k]] b[g, j, k mod m], on the digit
        products."""
        f, n, nl = self.f, self.n, r * m
        x = src if perm is None else src[:, perm.long()]
        X = f.to_plain(x)                            # (nd, batch, n)
        nd, batch = X.shape[0], X.shape[1]
        B = X.reshape(nd, batch, n // nl, r, m)
        idx = torch.from_numpy(level_twiddles(n, r, m)[1:]).to(src.device)
        T = f.to_plain(tbl[idx])                     # (nd, r - 1, nl)
        acc = B[:, :, :, 0].repeat(1, 1, 1, r)       # T[0] = 1
        for j in range(1, r):
            term = f.mul(T[:, j - 1].reshape(nd, 1, 1, nl),
                         B[:, :, :, j].repeat(1, 1, 1, r))
            acc = f.add(acc, term)
        return f.from_plain(acc.reshape(nd, batch, n))

    def _transform(self, a, tbl, pre=None, abc=None, post=None):
        """a (batch, n, 10) Montgomery coefficients -> evaluations: K5
        once per pass, between two buffers, the prologue (`pre` or `abc`,
        as ntt_pass takes them) on the first pass and the epilogue
        (`post`) on the last."""
        if a.dim() == 2:
            return self._transform(a[None], tbl, pre, abc, post)[0]
        shape = (1 if abc is not None else a.shape[0],) + tuple(a.shape[1:])
        bufs = (a.new_empty(shape), a.new_empty(shape))
        src, perm, last = a, self.perm, len(self.passes) - 1
        for i, ps in enumerate(self.passes):
            src = self.ntt_pass(src, tbl, perm, ps, out=bufs[i % 2],
                                pre=pre if i == 0 else None,
                                abc=abc if i == 0 else None,
                                post=post if i == last else None)
            perm = None
        return src

    # -- public ops ----------------------------------------------------------
    def fft(self, a):
        return self._transform(a, self.tbl_fwd)

    def ifft(self, a):
        return self._transform(a, self.tbl_inv, post=self.n_inv)

    def coset_fft(self, a):
        return self._transform(a, self.tbl_fwd, pre=self.coset_tbl)

    def coset_ifft(self, a):
        return self._transform(a, self.tbl_inv, post=self.ninv_coset_inv_tbl)

    # -- host conversions ----------------------------------------------------
    def encode(self, coeffs) -> torch.Tensor:
        """Canonical ints (at most n) -> (n, 10) Montgomery on the
        device, zero-padded."""
        assert len(coeffs) <= self.n
        f = self.f
        vals = [int(c) * f.r % f.p for c in coeffs]
        vals += [0] * (self.n - len(vals))
        return torch.from_numpy(ints_to_limbs(vals).view(np.int32)).to(
            self.device)

    def decode(self, arr) -> list:
        """Montgomery limbs -> canonical ints (flat)."""
        return self.f.decode_ints(arr.cpu().numpy() if isinstance(
            arr, torch.Tensor) else arr)


@lru_cache(maxsize=None)
def _fft_ctx(F, size: int, device: torch.device) -> FFTTensorCtx:
    return FFTTensorCtx(F, size, device)


def fft_ctx(F, size: int, device) -> FFTTensorCtx:
    """The cached FFTTensorCtx of (F, size) on `device`."""
    return _fft_ctx(F, size, torch.device(device))


def hpoly(fctx: FFTTensorCtx, a, b, c, zh_inv: int, check_rows: int = 0):
    """The quotient h = coset_ifft((coset_fft(ifft(A)) coset_fft(ifft(B))
    - coset_fft(ifft(C))) zh_inv) of domain evaluations a, b, c, (n, 10)
    Montgomery tensors on fctx's device (`b is a`: the squaring case,
    one transform fewer).  check_rows > 0 raises ValueError where
    a_j b_j != c_j for some j < check_rows (the replayed-witness check,
    K7).  Three transforms and no pass of its own for the pointwise
    steps: ifft and coset_fft's scalings in one epilogue, the forward
    transform, then the inverse one with (a b - c) zh_inv as its prologue
    and n^-1 g^-i as plain residues as its epilogue.  Returns h as (n, 10)
    canonical limbs on the device, the C++ tier's output values."""
    f, n = fctx.f, fctx.n
    for t in (a, b, c):
        if tuple(t.shape) != (n, NLIMB):
            raise ValueError(f"hpoly: (n, 10) evaluations expected, n = {n}")
    sq = b is a
    if check_rows:
        k = check_rows
        bad = f.abc(a[:k], b[:k], c[:k], f.mont(1, a.device))
        if bool(bad.any()):
            raise ValueError("unsatisfied constraint (replayed witness)")
    x = torch.stack((a, c) if sq else (a, b, c))
    ev = fctx.fft(fctx._transform(x, fctx.tbl_inv, post=fctx.ninv_coset_tbl))
    h = fctx._transform(ev, fctx.tbl_inv, abc=f.mont(zh_inv, a.device),
                        post=fctx.ninv_coset_inv_plain)
    return h[0]
