"""Host-side MSM (control plane / small sizes / correctness oracle).

The production MSM is the device Pippenger in pcd_tpu/msm/tensor.py
(SURVEY.md D4 — the #1 hot loop of Groth16/GM17 prove).  The host versions
here use windowed methods over Python-int points: adequate for toy-cycle
tests and key derivation at small scale.

The port's copy of `pcd_tpu/msm/host.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

_NATIVE_MSM_MIN = 32


def _native_curve_ok(curve) -> bool:
    """The C++ backend covers short-Weierstrass curves over prime or
    direct Fp2/Fp3 extension coordinate fields below 320 bits."""
    from ..curves.short_weierstrass import SWCurve

    if not isinstance(curve, SWCurve):
        return False
    F = curve.F
    prime = F.prime_subfield()
    if prime.MODULUS.bit_length() > 320:
        return False
    deg = F.extension_degree_over_prime()
    if deg == 1:
        return True
    if deg > 3:
        return False
    nr = F.NR
    return not hasattr(nr, "to_prime_coeffs")  # direct tower only


def _native():
    from .. import native

    return native if native.available() else None


def encode_query(points):
    """Pre-marshal a fixed query table (pk queries, SRS powers) for
    repeated native MSMs; returns the list unchanged when the native
    tier can't take this curve.  Zero scalars need no host-side
    filtering against an encoded table — the C++ bucket loop skips
    zero digits."""
    if len(points) >= _NATIVE_MSM_MIN and _native_curve_ok(points[0].curve):
        native = _native()
        if native is not None:
            return native.encode_points(points)
    return points


def msm(points, scalars):
    """Variable-base MSM: sum scalars[i] * points[i].  Dispatches to the
    C++ backend (pcd_tpu/native — threaded Pippenger, ~100x the Python
    path at production sizes) when available; the Python window method
    below remains the oracle and the fallback.  `points` may be an
    `native.EncodedPoints` table from encode_query()."""
    assert len(points) == len(scalars)
    if not len(points):
        raise ValueError("empty MSM")
    from ..native import EncodedPoints

    if isinstance(points, EncodedPoints):
        # scalars may already be a (n, NL) limb array (prover fast path)
        return _native().msm(points, scalars)
    curve = points[0].curve
    if len(points) >= _NATIVE_MSM_MIN and _native_curve_ok(curve):
        native = _native()
        if native is not None:
            return native.msm(points, scalars)
    acc_total = curve.infinity()
    c = 4
    nbits = max((int(s).bit_length() for s in scalars), default=1) or 1
    nwin = (nbits + c - 1) // c
    for w in range(nwin - 1, -1, -1):
        buckets = [None] * (1 << c)
        for pt, s in zip(points, scalars):
            idx = (int(s) >> (w * c)) & ((1 << c) - 1)
            if idx:
                buckets[idx] = pt if buckets[idx] is None else buckets[idx] + pt
        running = curve.infinity()
        window_sum = curve.infinity()
        for b in range((1 << c) - 1, 0, -1):
            if buckets[b] is not None:
                running = running + buckets[b]
            window_sum = window_sum + running
        if w != nwin - 1:
            for _ in range(c):
                acc_total = acc_total.double()
        acc_total = acc_total + window_sum
    return acc_total


class FixedBaseTable:
    """Windowed fixed-base table: scalar * G for many scalars sharing G."""

    def __init__(self, base, max_bits: int, window: int = 8):
        self.window = window
        self.nwin = (max_bits + window - 1) // window
        self.tables = []
        cur = base
        for _ in range(self.nwin):
            row = [base.curve.infinity()]
            for _ in range((1 << window) - 1):
                row.append(row[-1] + cur)
            self.tables.append(row)
            for _ in range(window):
                cur = cur.double()
        self.curve = base.curve

    def mul(self, scalar: int):
        acc = self.curve.infinity()
        s = int(scalar)
        for w in range(self.nwin):
            idx = (s >> (w * self.window)) & ((1 << self.window) - 1)
            if idx:
                acc = acc + self.tables[w][idx]
        return acc

    def mul_many(self, scalars):
        return [self.mul(s) for s in scalars]


def fixed_base_many(base, scalars, max_bits: int, window: int = 8):
    """[s*G for s in scalars] — native windowed batch when available
    (threaded + Montgomery batch-affine), else a Python table (plain
    double-and-add when the batch is too small to amortize one)."""
    if len(scalars) >= 16 and not base.is_infinity() \
            and _native_curve_ok(base.curve):
        native = _native()
        if native is not None:
            return native.fixed_base_batch(base, [int(s) for s in scalars],
                                           max_bits)
    if len(scalars) < 16:
        return [base * int(s) for s in scalars]
    return FixedBaseTable(base, max_bits, window).mul_many(scalars)
