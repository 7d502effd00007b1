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
"""

from __future__ import annotations

import numpy as np
import torch

NLIMB = 10                  # u32 limbs per prime-field element
R_BITS = 32 * NLIMB         # Montgomery radix R = 2^320
ND = 2 * NLIMB              # 16-bit digits per element (plain versions)
_M16 = 0xFFFF
INF_BIT = 1 << 31           # infinity flag: bit 31 of X's top limb


def ints_to_limbs(vals) -> np.ndarray:
    """Canonical ints -> (n, 10) u32 limbs."""
    buf = b"".join(int(v).to_bytes(4 * NLIMB, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), NLIMB).copy()


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

    def __init__(self, p: int, d: int = 1, nr: int = 0):
        assert p % 2 == 1 and 2 < p.bit_length() <= 300
        assert d in (1, 2, 3) and (d == 1 or 0 < nr < 1 << 16)
        self.p, self.d, self.nr = p, d, nr
        self.r = (1 << R_BITS) % p
        self.rinv = pow(1 << R_BITS, -1, p)
        self.n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)    # kernels (CIOS)
        self.p_limbs = ints_to_limbs([p])[0]
        self._dig = {}
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
    """(20, ...) normalized digits -> (..., 10) int32 limbs."""
    d = d.movedim(0, -1)
    v = d[..., 0::2] | (d[..., 1::2] << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
