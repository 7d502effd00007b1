"""Host-side short-Weierstrass curve groups, generic over any field class.

Control-plane only (key generation, test oracles, generator derivation);
bulk point arithmetic runs on the limb-tensor path (pcd_tpu/curves/sw_tensor.py).

Reference behavior pinned by `ark-ec` use-sites (SURVEY.md D3):
MNT4-298 / MNT6-298 G1 and G2 groups.

A frozen copy of the port's `pcd_tpu_torch/curves/short_weierstrass.py` for the
benchmark's plain reference; it imports nothing of the program.
"""

from __future__ import annotations

import random as _random


class SWCurve:
    """A short-Weierstrass curve y^2 = x^3 + a x + b over field F.

    Instances are lightweight configs; points are SWPoint (affine with
    explicit infinity flag — host side favors clarity; device side uses
    projective complete formulas).
    """

    def __init__(self, F, a, b, order: int, cofactor: int = 1, name: str = "sw"):
        self.F = F
        self.a = a
        self.b = b
        self.order = order          # prime order of the subgroup of interest
        self.cofactor = cofactor
        self.name = name

    def infinity(self):
        return SWPoint(self, None, None)

    def point(self, x, y, check: bool = True):
        p = SWPoint(self, x, y)
        if check and not p.is_on_curve():
            raise ValueError(f"point not on curve {self.name}")
        return p

    def point_ints(self, x: int, y: int, check: bool = True):
        return self.point(self.F.from_int(x), self.F.from_int(y), check)

    def lift_x(self, x):
        """Return a point with abscissa x, or None."""
        rhs = x * x * x + self.a * x + self.b
        y = rhs.sqrt()
        if y is None:
            return None
        return SWPoint(self, x, y)

    def hash_to_curve(self, seed: bytes):
        """Deterministic try-and-increment point derivation (internal use:
        generator/SRS derivation — not a security-critical RO instantiation).
        Clears cofactor."""
        import hashlib

        ctr = 0
        k = self.F.extension_degree_over_prime()
        prime = self.F.prime_subfield()
        nbytes = (prime.BITS + 7) // 8 + 16
        while True:
            coeffs = []
            for i in range(k):
                h = hashlib.sha256(seed + ctr.to_bytes(4, "little") + i.to_bytes(2, "little")).digest()
                # widen to reduce mod-p bias
                h2 = hashlib.sha256(h).digest()
                wide = int.from_bytes((h + h2)[:nbytes], "little")
                coeffs.append(prime.from_int(wide))
            x = self.F.from_prime_coeffs(coeffs) if k > 1 else coeffs[0]
            pt = self.lift_x(x)
            if pt is not None:
                pt = pt * self.cofactor
                if not pt.is_infinity():
                    return pt
            ctr += 1

    def rand_point(self, rng: _random.Random | None = None):
        r = rng or _random
        while True:
            x = self.F.rand(rng)
            pt = self.lift_x(x)
            if pt is not None:
                if r.randrange(2):
                    pt = -pt
                q = pt * self.cofactor
                if not q.is_infinity():
                    return q


class SWPoint:
    __slots__ = ("curve", "x", "y")

    def __init__(self, curve, x, y):
        self.curve = curve
        self.x = x  # None for infinity
        self.y = y

    def is_infinity(self) -> bool:
        return self.x is None

    def is_on_curve(self) -> bool:
        if self.is_infinity():
            return True
        x, y, c = self.x, self.y, self.curve
        return (y * y - (x * x * x + c.a * x + c.b)).is_zero()

    def __eq__(self, o):
        if not isinstance(o, SWPoint):
            return NotImplemented
        if self.is_infinity() or o.is_infinity():
            return self.is_infinity() and o.is_infinity()
        return self.x == o.x and self.y == o.y

    def __hash__(self):
        if self.is_infinity():
            return hash((self.curve.name, "inf"))
        return hash((self.curve.name, self.x, self.y))

    def __neg__(self):
        if self.is_infinity():
            return self
        return SWPoint(self.curve, self.x, -self.y)

    def double(self):
        if self.is_infinity():
            return self
        x, y, c = self.x, self.y, self.curve
        if y.is_zero():
            return c.infinity()
        lam = (x * x * 3 + c.a) / (y.double())
        x3 = lam * lam - x.double()
        y3 = lam * (x - x3) - y
        return SWPoint(c, x3, y3)

    def __add__(self, o):
        if self.is_infinity():
            return o
        if o.is_infinity():
            return self
        if self.x == o.x:
            if (self.y + o.y).is_zero():
                return self.curve.infinity()
            return self.double()
        lam = (o.y - self.y) / (o.x - self.x)
        x3 = lam * lam - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return SWPoint(self.curve, x3, y3)

    def __sub__(self, o):
        return self + (-o)

    def __mul__(self, k: int):
        if isinstance(k, int):
            e = k
        else:  # field element scalar
            e = k.n
        if e < 0:
            return (-self) * (-e)
        r = self.curve.infinity()
        base = self
        while e:
            if e & 1:
                r = r + base
            base = base.double()
            e >>= 1
        return r

    __rmul__ = __mul__

    def to_bytes(self) -> bytes:
        """arkworks-style uncompressed-ish serialization used for hashing:
        x || y as field bytes, with an infinity byte flag appended.

        Note: exact arkworks flag packing can't be byte-verified here (dep
        sources not vendored — SURVEY.md D15); the framework is internally
        consistent, which is what the PCD construction requires."""
        F = self.curve.F
        if self.is_infinity():
            zero = F.zero() if hasattr(F, "zero") else F.from_int(0)
            return zero.to_bytes() + zero.to_bytes() + b"\x01"
        return self.x.to_bytes() + self.y.to_bytes() + b"\x00"

    def __repr__(self):  # pragma: no cover
        if self.is_infinity():
            return f"{self.curve.name}(inf)"
        return f"{self.curve.name}({self.x}, {self.y})"
