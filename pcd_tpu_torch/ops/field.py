"""Montgomery field arithmetic of the port: the counterpart of
`pcd_tpu/ops/fp32.py` (Fp32Ctx) and of its Fp2/Fp3 layer `_ExtOpsT`
(`pcd_tpu/ops/ec32.py:747-826`).

Layout.  An Fp element is 10 little-endian u32 limbs, held in int32 (the
bit pattern), in Montgomery form x*R mod p with R = 2^320, fully reduced
to [0, p).  An element of Fp^d = Fp[u]/(u^d - nr) is (..., d, 10).  The
JAX package's 8-bit limbs in f32 with bf16 Toeplitz reductions are a
TPU design; a GPU multiplies 32x32 -> 64 bits natively, so the card's
kernels (csrc/field.cuh) run CIOS over u32 limbs.  Moduli are held to
300 bits: the top limb then has spare bits, and bit 31 of X's top limb
is the point-at-infinity flag of an MSM table row (ops/ec.py), as the
reference's pad limb is (`pcd_tpu/ops/ec32.py:200-208`).

Because every value is fully reduced, the kernels and the plain torch
versions here agree limb for limb, so the port's tests compare them for
exact equality.  The plain versions carry 16-bit digits in int64
tensors (torch has no general u64 multiply, and an int64 product of two
32-bit limbs overflows); every column sum they form stays below 2^45.
They serve CPU tensors and are the kernels' yardstick on the card.

K7 `fp_vec` (csrc/fp_vec.cu) runs the quotient pipeline's elementwise
prime-field operations on the card (FieldCtx.vmul, abc, to_mont,
from_mont, sap); for a CPU tensor each runs its plain version here.  The
launch counters of every kernel wrapper of the port live here too (ops/ec.py
reads and resets them).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

NLIMB = 10                  # u32 limbs per prime-field element
R_BITS = 32 * NLIMB         # Montgomery radix R = 2^320
ND = 2 * NLIMB              # 16-bit digits per element (plain versions)
_M16 = 0xFFFF
INF_BIT = 1 << 31           # infinity flag: bit 31 of X's top limb

_LAUNCHES: Counter = Counter()   # (kernel, form) -> CUDA launches
_PLAIN: Counter = Counter()      # (kernel, form) -> plain-version calls


def ints_to_limbs(vals) -> np.ndarray:
    """Canonical ints -> (n, 10) u32 limbs."""
    buf = b"".join(int(v).to_bytes(4 * NLIMB, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), NLIMB).copy()


def upload_limbs(limbs: np.ndarray, device) -> torch.Tensor:
    """(n, 5) u64 canonical limb rows (the C++ tier's layout) -> (n, 10)
    int32 limbs on `device`: the same little-endian bytes."""
    w = np.ascontiguousarray(limbs, dtype="<u8").view("<i4").reshape(
        limbs.shape[0], NLIMB)
    return torch.from_numpy(w if w.flags.writeable else w.copy()).to(device)


def limbs_host(t: torch.Tensor) -> np.ndarray:
    """(n, 10) int32 canonical limbs on any device -> (n, 5) u64 numpy
    rows, the C++ tier's layout (a view of the fetched bytes)."""
    return np.ascontiguousarray(t.cpu().numpy()).view("<u8")


def limbs_to_ints(arr) -> list:
    """(..., 10) u32/int32 limbs -> flat list of ints."""
    flat = np.ascontiguousarray(np.asarray(arr).reshape(-1, NLIMB)
                                ).view("<u4")
    raw = flat.tobytes()
    w = 4 * NLIMB
    return [int.from_bytes(raw[i * w:(i + 1) * w], "little")
            for i in range(flat.shape[0])]


class FieldCtx:
    """Fp (d = 1) or the binomial extension Fp^d with u^d = nr (d = 2, 3;
    nr a small int of the prime field: 17 for MNT4's Fq2, 5 for MNT6's
    Fq3)."""

    def __init__(self, p: int, d: int = 1, nr: int = 0, name: str = ""):
        assert p % 2 == 1 and 2 < p.bit_length() <= 300
        assert d in (1, 2, 3) and (d == 1 or 0 < nr < 1 << 16)
        self.p, self.d, self.nr = p, d, nr
        self.name = name or f"{p.bit_length()}-bit p"    # counter key
        self.r = (1 << R_BITS) % p
        self.rinv = pow(1 << R_BITS, -1, p)
        self.n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)    # kernels (CIOS)
        self.p_limbs = ints_to_limbs([p])[0]
        # FieldConsts of csrc/field.cuh for the prime-field kernels (no
        # curve constants): p, n0, nr, one = R mod p
        self.kconsts = np.ascontiguousarray(np.concatenate([
            self.p_limbs, np.array([self.n0, nr], dtype=np.uint32),
            ints_to_limbs([self.r])[0],
            np.zeros(9 * NLIMB, dtype=np.uint32)]), dtype=np.uint32)
        self._dig = {}
        self._consts = {}
        self._plain_setup()

    # -- host conversions -------------------------------------------------
    def decode_ints(self, arr) -> list:
        """Montgomery limbs (..., 10) -> canonical ints (flat)."""
        return [v * self.rinv % self.p for v in limbs_to_ints(arr)]

    def encode_u64(self, comps: np.ndarray) -> np.ndarray:
        """(M, 5) u64 canonical limbs (the C++ tier's EncodedPoints layout)
        -> (M, 10) int32 Montgomery limbs.  The Montgomery multiply runs
        in the C++ tier (x * (R mod p) mod p); five u64 limbs are ten
        u32 limbs byte for byte, so the rest is a view."""
        from .. import native

        if not native.available():
            raise RuntimeError("the C++ tier (pcd_tpu_torch/native) is "
                               "required to encode MSM tables")
        M = comps.shape[0]
        if M == 0:
            return np.zeros((0, NLIMB), dtype=np.int32)
        rrow = np.broadcast_to(native.ints_to_limbs([self.r]), (M, native.NL))
        mont = native.vec_op(self.p, "mul", np.ascontiguousarray(comps),
                             np.ascontiguousarray(rrow))
        return np.ascontiguousarray(mont).view(np.int32).reshape(M, NLIMB)

    # -- plain versions: digit form ----------------------------------------
    # The plain versions run Montgomery arithmetic over nd 16-bit digits,
    # digit-major ((nd, *batch) int64), with their own radix R' = 2^(16 nd),
    # nd the fewest digits that keep every reduction below 2p (R' above
    # 2 (1 + 2 nr) p; 20 digits, R' = R, for the 298-bit fields).
    # `to_plain` / `from_plain` move values between the kernels' x R form
    # and x R' with one multiply each, so a toy field computes on 3 digits
    # instead of 20.  An Fp^d
    # element is (nd, d, *batch); the prime-field operations broadcast
    # over the d axis, and a group of independent products is one call.
    def _plain_setup(self):
        need = self.p.bit_length() + (2 * self.nr + 1).bit_length() + 1
        nd = -(-need // 16)
        self.nd = ND if nd > ND - 4 else nd
        rp = 1 << (16 * self.nd)
        self._rp = rp
        self._np = (-pow(self.p, -1, rp)) % rp
        self._k_in = rp * rp * self.rinv % self.p      # x R -> x R'
        self._k_out = self.r                           # x R' -> x R

    def digits(self, v: int) -> list:
        return [(v >> (16 * i)) & _M16 for i in range(self.nd)]

    def pdig(self, like: torch.Tensor) -> torch.Tensor:
        """p as digits, shaped to broadcast against the (nd, ...) `like`."""
        key = str(like.device)
        t = self._dig.get(key)
        if t is None:
            t = torch.tensor(self.digits(self.p), dtype=torch.int64,
                             device=like.device)
            self._dig[key] = t
        return t.reshape((self.nd,) + (1,) * (like.dim() - 1))

    def _cond_sub(self, x):
        """x (nd, ...) normalized digits, value < 2p -> x mod p."""
        t = carry(x - self.pdig(x))
        return torch.where(t[-1] < 0, x, t)

    def add(self, a, b):
        return self._cond_sub(carry(a + b))

    def sub(self, a, b):
        return self._cond_sub(carry(a - b + self.pdig(a)))

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def redc(self, T):
        """T (2 nd, ...) column sums of a value < p R' -> T/R' mod p as
        normalized (nd, ...) digits, in one shot: m = (T mod R')(-1/p) mod
        R', then (T + m p)/R' < 2p.  Every column stays below 2^45."""
        nd = self.nd
        T = carry(T)
        lo = wide_const(T[:nd], self.digits(self._np), nd + 1)
        lo[nd] = 0
        m = carry(lo)[:nd]
        U = carry(T + wide_const(m, self.digits(self.p), 2 * nd))
        return self._cond_sub(U[nd:])

    def mul(self, a, b):
        """Fp^d product of (nd, d, ...) digit tensors, broadcasting over
        the trailing axes.  As `_ExtOpsT.mul`, every output component sums
        its cross products at the wide level (nr folds the wrapped ones)
        and is reduced once: c_m = sum over i + j = m (mod d) of a_i b_j,
        times nr where i + j >= d.  Each sum is below (1 + 2 nr) p^2 <
        p R', so one reduction lands below 2p."""
        d = self.d
        if d == 1:
            return self.redc(wide(a, b))
        P = wide(a.unsqueeze(2), b.unsqueeze(1))     # (2nd, d, d, ...)
        out = []
        for m in range(d):
            T = None
            for i in range(d):
                j = (m - i) % d
                w = P[:, i, j]
                if i + j >= d:
                    w = w * self.nr
                T = w if T is None else T + w
            out.append(T)
        return self.redc(torch.stack(out, dim=1))

    def plain_const(self, vals, device) -> torch.Tensor:
        """One element's d canonical components -> (nd, d, 1) digits of
        its plain x R' form."""
        return torch.tensor([self.digits(v * self._rp % self.p)
                             for v in vals], dtype=torch.int64,
                            device=device).T.unsqueeze(-1)

    def to_plain(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 10) int32 Montgomery limbs (x R) -> (nd, ...) digits of
        x R'."""
        d = to_digits(x)[:self.nd]
        if self.nd == ND:
            return d
        return self.redc(wide_const(d, self.digits(self._k_in), 2 * self.nd))

    def from_plain(self, d: torch.Tensor) -> torch.Tensor:
        """(nd, ...) digits of x R' -> (..., 10) int32 limbs of x R."""
        if self.nd != ND:
            d = self.redc(wide_const(d, self.digits(self._k_out),
                                     2 * self.nd))
            d = torch.cat([d, d.new_zeros((ND - self.nd,)
                                          + tuple(d.shape[1:]))])
        return from_digits(d)


    # -- K7 fp_vec: elementwise prime-field ops (d = 1) ---------------------
    # Operands are (..., 10) int32 limbs, contiguous; the kernel for CUDA
    # tensors, the plain version (the digit products above) for CPU ones.
    FPV_MUL, FPV_ABC, FPV_SAP = 0, 1, 2

    def const(self, v: int, device) -> torch.Tensor:
        """(1, 10) int32 limbs of v mod p as they are (pass x R mod p for
        a Montgomery constant), cached per device."""
        key = (v % self.p, str(device))
        t = self._consts.get(key)
        if t is None:
            t = torch.from_numpy(ints_to_limbs([key[0]]).view(np.int32)
                                 ).to(device)
            self._consts[key] = t
        return t

    def mont(self, v: int, device) -> torch.Tensor:
        """(1, 10) Montgomery limbs of v (v R mod p)."""
        return self.const(v * self.r, device)

    def vmul(self, a, b):
        """a (..., rows, 10) times b, a (rows, 10) table or a (1, 10)
        element, broadcast over a's leading axes: Montgomery products."""
        if b.dim() != 2 or b.shape[0] not in (1, a.shape[-2]):
            raise ValueError("vmul: b must be (rows, 10) or (1, 10)")
        if a.device.type == "cpu":
            return self._plain("fp_vec", lambda: self.vmul_plain(a, b))
        out = torch.empty_like(a)
        self._fp_vec(self.FPV_MUL, out.numel() // NLIMB, b.shape[0], 0,
                     (a, b, None, None), (out, None, None))
        return out

    def abc(self, a, b, c, s):
        """(a b - c) s elementwise, a, b, c of one shape, s (1, 10)."""
        if not (a.shape == b.shape == c.shape) or tuple(s.shape) != (1,
                                                                     NLIMB):
            raise ValueError("abc: a, b, c of one shape and s (1, 10)")
        if a.device.type == "cpu":
            return self._plain("fp_vec", lambda: self.abc_plain(a, b, c, s))
        out = torch.empty_like(a)
        self._fp_vec(self.FPV_ABC, out.numel() // NLIMB, 1, 0, (a, b, c, s),
                     (out, None, None))
        return out

    def to_mont(self, a):
        """Canonical limbs -> Montgomery (a product by R^2 mod p)."""
        return self.vmul(a, self.const(self.r * self.r, a.device))

    def from_mont(self, a):
        """Montgomery limbs -> canonical (a product by 1)."""
        return self.vmul(a, self.const(1, a.device))

    def sap(self, az, bz, cz, zi, n: int):
        """GM17's SAP evaluations on a domain of n points from the R1CS
        row evaluations az, bz, cz (nc, 10) and the instance values zi
        (ni, 10), all Montgomery, as gm17/native.py builds them: a_ev
        rows 2j, 2j + 1 = az + bz, az - bz; c_ev rows 4 cz + w, w with
        w = (az - bz)^2; rows 2 nc + i: zi, zi^2; zero above.  Returns
        (a_ev, c_ev, ext), ext (nc + ni, 10) the w and zi^2 values, the
        assignment's SAP extension."""
        nc, ni = az.shape[0], zi.shape[0]
        if bz.shape != az.shape or cz.shape != az.shape \
                or 2 * nc + ni > n:
            raise ValueError("sap: az, bz, cz (nc, 10), 2 nc + ni <= n")
        if az.device.type == "cpu":
            return self._plain("fp_vec", lambda: self.sap_plain(
                az, bz, cz, zi, n))
        dev = az.device
        a_ev = torch.empty((n, NLIMB), dtype=torch.int32, device=dev)
        c_ev = torch.empty_like(a_ev)
        ext = torch.empty((nc + ni, NLIMB), dtype=torch.int32, device=dev)
        self._fp_vec(self.FPV_SAP, n, nc, ni, (az, bz, cz, zi),
                     (a_ev, c_ev, ext))
        return a_ev, c_ev, ext

    # the plain versions of K7, on the digit products above
    def vmul_plain(self, a, b):
        B = self.to_plain(b)
        B = B.reshape((B.shape[0],) + (1,) * (a.dim() - 2) + (b.shape[0],))
        return self.from_plain(self.mul(self.to_plain(a), B))

    def abc_plain(self, a, b, c, s):
        return self.from_plain(self.mul(
            self.sub(self.mul(self.to_plain(a), self.to_plain(b)),
                     self.to_plain(c)), self.to_plain(s)))

    def sap_plain(self, az, bz, cz, zi, n):
        A, B, C, Z = (self.to_plain(t) for t in (az, bz, cz, zi))
        d = self.sub(A, B)
        w = self.mul(d, d)
        c2 = self.add(C, C)
        c0 = self.add(self.add(c2, c2), w)
        zsq = self.mul(Z, Z)
        nc, ni = az.shape[0], zi.shape[0]
        a_ev = torch.zeros((n, NLIMB), dtype=torch.int32, device=az.device)
        c_ev = torch.zeros_like(a_ev)
        a_ev[0:2 * nc:2] = self.from_plain(self.add(A, B))
        a_ev[1:2 * nc:2] = self.from_plain(d)
        a_ev[2 * nc:2 * nc + ni] = zi
        c_ev[0:2 * nc:2] = self.from_plain(c0)
        c_ev[1:2 * nc:2] = self.from_plain(w)
        c_ev[2 * nc:2 * nc + ni] = self.from_plain(zsq)
        return a_ev, c_ev, self.from_plain(torch.cat([w, zsq], dim=-1))

    def _plain(self, kernel, fn):
        _PLAIN[(kernel, self.name)] += 1
        return fn()

    def _fp_vec(self, op, n, nb, ni, ins, outs):
        """Launch K7 on the current stream of the operands' card."""
        dev = outs[0].device
        if dev.type != "cuda" or self.d != 1:
            raise ValueError(f"fp_vec: a prime field on a CUDA device, not "
                             f"d = {self.d} on {dev}")
        for t in ins + outs:
            if t is not None and (t.device != dev or t.dtype != torch.int32
                                  or not t.is_contiguous()
                                  or t.shape[-1] != NLIMB
                                  or t.data_ptr() % 8):
                raise ValueError("fp_vec: contiguous 8-byte aligned (..., "
                                 f"10) int32 operands on {dev} expected")
        from .kernels import lib

        ptrs = [None if t is None else t.data_ptr() for t in ins + outs]
        rc = lib("fp_vec").pcd_fp_vec(
            op, n, nb, ni, *ptrs, self.kconsts.ctypes.data_as(
                ctypes.c_void_p), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fp_vec launch failed: CUDA error {rc}")
        _LAUNCHES[("fp_vec", self.name)] += 1


def carry(t):
    """Propagate carries (signed: arithmetic shifts floor) down the digit
    axis, one row after the other: rows 0..n-2 end in [0, 2^16), the last
    row keeps the rest (its sign is the sign of the whole value).  Row by
    row needs no data-dependent stop, so it never waits on the device."""
    t = t.clone()
    for i in range(t.shape[0] - 1):
        t[i + 1] += t[i] >> 16
        t[i] &= _M16
    return t


def wide(a, b):
    """(nd, ...) x (nd, ...) digits (broadcasting) -> (2 nd, ...) product
    column sums."""
    nd = a.shape[0]
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    T = torch.zeros((2 * nd,) + tuple(batch), dtype=torch.int64,
                    device=a.device)
    for i in range(nd):
        T[i:i + nd] += a[i] * b
    return T


def wide_const(a, v: list, rows: int):
    """(nd, ...) digits x a constant's digits v -> its first `rows`
    product column sums."""
    nd = a.shape[0]
    T = torch.zeros((2 * nd,) + tuple(a.shape[1:]), dtype=torch.int64,
                    device=a.device)
    for i, vi in enumerate(v):
        if vi:
            T[i:i + nd] += vi * a
    return T[:rows]


def to_digits(x: torch.Tensor) -> torch.Tensor:
    """(..., 10) int32 limbs -> (20, ...) int64 16-bit digits."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    d = torch.stack((v & _M16, v >> 16), dim=-1).reshape(
        tuple(x.shape[:-1]) + (ND,))
    return d.movedim(-1, 0)


def from_digits(d: torch.Tensor) -> torch.Tensor:
    """(20, ...) normalized digits -> (..., 10) int32 limbs, contiguous
    (the layout the kernels take)."""
    d = d.movedim(0, -1)
    v = d[..., 0::2] | (d[..., 1::2] << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(
        torch.int32).contiguous()
