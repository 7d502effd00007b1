"""Fixed-base scalar multiplication on the card, [s_i] G for many scalars
and one base: the counterpart of `pcd_tpu/ops/fixed_base.py`
(FixedBaseDevice, fixed_base_device), the SNARK setups' key generation
under msm_dispatch.KEYGEN = "device".

The window table is the reference's: c = 8 bits a window, nwin =
ceil(scalar_bits / 8) windows (38 for a 298-bit Fr, the top one holding 2
bits), rows d 2^(8w) G for d < 256, computed once per (curve, base, bits)
on the host, by the C++ tier's fixed-base from the integers d 2^(8w), and
held on the device as affine Montgomery rows in the port's table layout
(ECCtx.table_from_u64), row 0 of each window flagged as the identity.
The digits are the scalars' bytes (reference fixed_base.py:46-60).

K8 `fixed_base_mul` (csrc/fixed_base.cu) takes one scalar a thread: from
the identity one complete mixed add of T[w][d] for each nonzero digit,
then one inversion to affine canonical limbs, the identity flagged; its
plain version, `mul_digits_plain`, runs the same windows on ECCtx's plain
RCB mixed add and FieldCtx.inv_plain.  A CPU tensor takes the plain
version, a CUDA tensor the kernel; there is no fallback.  The wrapper
counts its launches with the other kernels' (ops/ec.py launch_counts).
The cache is keyed by the curve's name and the base's coordinates, not
by the curve object's id as the reference's is.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .ec import ec_ctx
from ..utils.profiling import span
from .field import _LAUNCHES, _PLAIN, INF_BIT, NLIMB

C = 8                       # window bits: the digits are the bytes
ROWS = 1 << C


class FixedBaseDevice:
    def __init__(self, curve, base, scalar_bits: int):
        from .. import native
        from ..msm.host import _native_curve_ok

        if not (native.available() and _native_curve_ok(curve)):
            raise RuntimeError(f"fixed_base: the C++ tier is required to "
                               f"build the window table of {curve.name}")
        self.curve, self.base = curve, base
        self.ec = ec_ctx(curve)
        self.nwin = (scalar_bits + C - 1) // C
        ints = [d << (C * w) for w in range(self.nwin) for d in range(ROWS)]
        xs, ys, inf = raw_fixed_base(base, ints, C * self.nwin)
        self.table_host = self.ec.table_from_u64(xs, ys, inf).reshape(
            self.nwin, ROWS, 2, self.ec.d, NLIMB)
        self._tables = {}

    def table(self, device) -> torch.Tensor:
        """The (nwin, 256, 2, d, 10) int32 window table on `device`."""
        key = str(device)
        t = self._tables.get(key)
        if t is None:
            t = torch.from_numpy(self.table_host).to(device)
            self._tables[key] = t
        return t

    def digits_from_ints(self, scalars) -> np.ndarray:
        """(nwin, n) uint8: the scalars' little-endian bytes, window-major
        (a scalar of 8 nwin bits or more raises OverflowError)."""
        n = len(scalars)
        buf = b"".join(int(s).to_bytes(self.nwin, "little") for s in scalars)
        arr = np.frombuffer(buf, dtype=np.uint8).reshape(n, self.nwin)
        return np.ascontiguousarray(arr.T)

    # -- K8 and its plain version ------------------------------------------
    def mul_digits(self, digits: torch.Tensor) -> torch.Tensor:
        """K8: digits (nwin, n) uint8 on the table's device -> (n, 2, d, 10)
        int32 affine canonical limbs, the identity zero with bit 31 of x's
        top limb set."""
        dev = digits.device
        nwin, n = digits.shape
        if nwin != self.nwin or digits.dtype != torch.uint8 \
                or not digits.is_contiguous():
            raise ValueError(f"fixed_base: contiguous (nwin = {self.nwin}, "
                             f"n) uint8 digits expected")
        key = ("fixed_base_mul", self.ec.name)
        if dev.type == "cpu":
            _PLAIN[key] += 1
            return self.mul_digits_plain(digits)
        if dev.type != "cuda":
            raise ValueError(f"fixed_base: unsupported device {dev}")
        from .kernels import lib

        tbl = self.table(dev)
        out = torch.empty((n, 2, self.ec.d, NLIMB), dtype=torch.int32,
                          device=dev)
        rc = lib("fixed_base").pcd_fixed_base_mul(
            self.ec.d, tbl.data_ptr(), digits.data_ptr(), out.data_ptr(), n,
            nwin, self.ec.kconsts.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fixed_base_mul launch failed: CUDA error "
                               f"{rc}")
        _LAUNCHES[key] += 1
        return out

    def mul_digits_plain(self, digits: torch.Tensor) -> torch.Tensor:
        """Plain version of K8: the same windows in torch ops, ECCtx's
        plain RCB mixed add on the scalars whose digit is not 0, then
        FieldCtx.inv_plain for the affine conversion."""
        ec, f = self.ec, self.ec.f
        dev, n = digits.device, digits.shape[1]
        tbl = self.table(dev)
        acc = ec._split(ec.identity((n,), dev))          # (nd, d, n) each
        for w in range(self.nwin):
            dw = digits[w].long()
            live = torch.nonzero(dw).flatten()
            if not live.numel():
                continue
            D = f.to_plain(tbl[w][dw[live]])             # (nd, k, 2, d)
            new = ec._rcb_madd(ec._take(acc, live),
                               D[:, :, 0].movedim(-1, 1),
                               D[:, :, 1].movedim(-1, 1))
            ec._put(acc, live, new)
        X, Y, Z = acc
        zi = f.inv_plain(Z)
        xy = torch.stack([f.mul(X, zi), f.mul(Y, zi)], dim=1)  # (nd, 2, d, n)
        out = f.canonical_plain(xy).permute(2, 0, 1, 3).contiguous()
        inf = (Z == 0).flatten(0, 1).all(dim=0)
        out[inf, 0, 0, NLIMB - 1] |= -INF_BIT              # bit 31
        return out

    # -- host conversions ----------------------------------------------------
    def to_host(self, out: torch.Tensor) -> list:
        """(n, 2, d, 10) K8 output on any device -> host affine points, as
        the C++ tier's fixed_base_batch builds them."""
        from ..native import _point_from_limbs

        arr = np.ascontiguousarray(out.cpu().numpy()).view(np.uint32)
        n, d = arr.shape[0], self.ec.d
        inf = (arr[:, 0, 0, NLIMB - 1] >> 31).astype(bool)
        xy = arr.reshape(n, -1).view("<u8")
        curve = self.curve
        return [curve.infinity() if inf[i]
                else _point_from_limbs(curve, d, xy[i]) for i in range(n)]

    def mul_many(self, scalars, device) -> list:
        """[s_i] G as host points through K8 (or its plain version on a
        CPU device).  The digits, the upload, the kernel, the download and
        the point objects each run in a span ("fixed_base/<part>"), the
        upload and the kernel synchronised so that their spans hold them."""
        dev = torch.device(device)
        with span("fixed_base/digits"):
            dg = self.digits_from_ints(scalars)
        with span("fixed_base/upload"):
            digits = torch.from_numpy(dg).to(dev)
            _sync(dev)
        with span("fixed_base/kernel"):
            out = self.mul_digits(digits)
            _sync(dev)
        with span("fixed_base/download"):
            host = out.cpu()
        with span("fixed_base/points"):
            return self.to_host(host)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def raw_fixed_base(base, scalars, bits: int):
    """[s base] by the C++ tier's windowed fixed-base as its EncodedPoints
    arrays (xs, ys, inf), with no host point objects."""
    from .. import native

    curve = base.curve
    h, deg, _ = native.curve_handle(curve)
    NL = native.NL
    bxy = np.zeros(2 * deg * NL, dtype="<u8")
    for d, c in enumerate(native._coeffs(base.x, deg)):
        bxy[d * NL:(d + 1) * NL] = native.ints_to_limbs([c])[0]
    for d, c in enumerate(native._coeffs(base.y, deg)):
        bxy[(deg + d) * NL:(deg + d + 1) * NL] = native.ints_to_limbs([c])[0]
    n = len(scalars)
    sc = native.ints_to_limbs([int(s) for s in scalars])
    xs = np.zeros((n, deg * NL), dtype="<u8")
    ys = np.zeros((n, deg * NL), dtype="<u8")
    inf = np.zeros(n, dtype=np.uint8)
    rc = native._load().pcd_fixed_base(
        h, native._u64p(bxy), bits, n, native._u64p(sc), native._u64p(xs),
        native._u64p(ys), native._u8p(inf))
    if rc != 0:
        raise RuntimeError("pcd_fixed_base failed")
    return xs, ys, inf.astype(bool)


_fb_cache: dict = {}
_fb_lock = threading.Lock()


def fixed_base_device(curve, base, scalar_bits: int) -> FixedBaseDevice:
    """The cached FixedBaseDevice of (curve, base, bits), keyed by the
    curve's name and the base's coordinates."""
    key = (curve.name, None if base.is_infinity() else (base.x, base.y),
           scalar_bits)
    with _fb_lock:
        hit = _fb_cache.get(key)
        if hit is None:
            hit = FixedBaseDevice(curve, base, scalar_bits)
            _fb_cache[key] = hit
        return hit
