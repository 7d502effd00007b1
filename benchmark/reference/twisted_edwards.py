"""Host-side twisted Edwards curve groups: a x^2 + y^2 = 1 + d x^2 y^2.

Used by the variable-length CRH family (reference:
src/variable_length_crh/{pedersen,bowe_hopwood}/mod.rs operate on
`ark-ec` twisted_edwards_extended points).  Addition is the standard
complete TE law (complete when a is a square and d a non-square).

A frozen copy of the port's `pcd_tpu_torch/curves/twisted_edwards.py` for the
benchmark's plain reference; it imports nothing of the program.
"""

from __future__ import annotations

import random as _random


class TECurve:
    def __init__(self, F, a, d, order: int, cofactor: int, name: str = "te"):
        self.F = F
        self.a = a
        self.d = d
        self.order = order      # prime subgroup order
        self.cofactor = cofactor
        self.name = name

    def identity(self):
        return TEPoint(self, self.F.zero(), self.F.one())

    def point(self, x, y, check: bool = True):
        p = TEPoint(self, x, y)
        if check and not p.is_on_curve():
            raise ValueError(f"point not on TE curve {self.name}")
        return p

    def point_ints(self, x: int, y: int, check: bool = True):
        return self.point(self.F.from_int(x), self.F.from_int(y), check)

    def lift_y(self, y, sign_x: int = 0):
        """Point with given ordinate, x parity chosen by sign_x, or None.
        x^2 = (1 - y^2) / (a - d y^2)."""
        F = self.F
        y2 = y * y
        num = F.one() - y2
        den = self.a - self.d * y2
        if den.is_zero():
            return None
        x2 = num / den
        x = x2.sqrt()
        if x is None:
            return None
        if sign_x and (x.n & 1) != (sign_x & 1):
            x = -x
        return TEPoint(self, x, y)

    def rand_point(self, rng: _random.Random | None = None):
        """Uniform point in the prime-order subgroup (excluding identity
        with overwhelming probability)."""
        while True:
            y = self.F.rand(rng)
            p = self.lift_y(y)
            if p is not None:
                q = p * self.cofactor
                if not q.is_identity():
                    return q


class TEPoint:
    __slots__ = ("curve", "x", "y")

    def __init__(self, curve, x, y):
        self.curve = curve
        self.x = x
        self.y = y

    def is_identity(self) -> bool:
        return self.x.is_zero() and self.y.is_one()

    def is_on_curve(self) -> bool:
        c, x, y = self.curve, self.x, self.y
        x2, y2 = x * x, y * y
        return (c.a * x2 + y2 - (c.F.one() + c.d * x2 * y2)).is_zero()

    def __eq__(self, o):
        return isinstance(o, TEPoint) and self.x == o.x and self.y == o.y

    def __hash__(self):
        return hash((self.curve.name, self.x, self.y))

    def __neg__(self):
        return TEPoint(self.curve, -self.x, self.y)

    def __add__(self, o):
        c = self.curve
        x1, y1, x2, y2 = self.x, self.y, o.x, o.y
        x1x2, y1y2 = x1 * x2, y1 * y2
        x1y2, y1x2 = x1 * y2, y1 * x2
        dxy = c.d * x1x2 * y1y2
        one = c.F.one()
        x3 = (x1y2 + y1x2) / (one + dxy)
        y3 = (y1y2 - c.a * x1x2) / (one - dxy)
        return TEPoint(c, x3, y3)

    def double(self):
        return self + self

    def __sub__(self, o):
        return self + (-o)

    def __mul__(self, k: int):
        e = k if isinstance(k, int) else k.n
        if e < 0:
            return (-self) * (-e)
        r = self.curve.identity()
        base = self
        while e:
            if e & 1:
                r = r + base
            base = base.double()
            e >>= 1
        return r

    __rmul__ = __mul__

    def to_bytes(self) -> bytes:
        return self.x.to_bytes() + self.y.to_bytes()

    def __repr__(self):  # pragma: no cover
        return f"{self.curve.name}({self.x}, {self.y})"
