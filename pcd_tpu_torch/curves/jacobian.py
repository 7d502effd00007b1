"""Host group arithmetic in Jacobian coordinates on plain integers: the
prover's scalar products and the Horner combine of a stream MSM's window
sums, each with one field inversion in all where the affine `SWPoint`
(curves/short_weierstrass.py) pays one for every add and doubling.

A coordinate is an int (a prime field) or a tuple of d ints (MNT4's Fq2
and MNT6's Fq3, binomial extensions F_p[v]/(v^d - nr) of the prime
field).  Products are reduced mod p, sums and differences are not, and
every sum feeds a product a step later, so no value grows past a few p.
A point is (X, Y, Z), x = X / Z^2 and y = Y / Z^3; None is the point at
infinity.  Formulas: dbl-2007-bl, add-2007-bl and madd-2007-bl of the
Explicit-Formulas Database (any a)."""

from __future__ import annotations

from functools import lru_cache


class _Prime:
    """A prime field's elements as ints."""

    def __init__(self, F):
        self.F, self.p = F, F.MODULUS

    def mul(self, a, b):
        return a * b % self.p

    def sqr(self, a):
        return a * a % self.p

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def sub(a, b):
        return a - b

    def is_zero(self, a) -> bool:
        return a % self.p == 0

    def inv(self, a):
        return pow(a, -1, self.p)

    @staticmethod
    def raw(e):
        return e.n

    def elem(self, a):
        return self.F(a)


class _Ext:
    """A degree-2 or degree-3 binomial extension of a prime field, its
    elements as tuples of ints (coefficients of 1, v, v^2)."""

    def __init__(self, F):
        base = F.BASE
        if base.extension_degree_over_prime() != 1 or F.DEGREE not in (2, 3):
            raise ValueError(f"{F.NAME}: not an extension of degree 2 or 3 "
                             f"of a prime field")
        self.F, self.base, self.p = F, base, base.MODULUS
        p, nr = self.p, F.NR.n
        if F.DEGREE == 2:
            def mul(a, b):
                a0, a1 = a
                b0, b1 = b
                return ((a0 * b0 + nr * (a1 * b1)) % p,
                        (a0 * b1 + a1 * b0) % p)

            def sqr(a):
                a0, a1 = a
                return ((a0 * a0 + nr * (a1 * a1)) % p, 2 * a0 * a1 % p)

            def add(a, b):
                return (a[0] + b[0], a[1] + b[1])

            def sub(a, b):
                return (a[0] - b[0], a[1] - b[1])
        else:
            def mul(a, b):
                a0, a1, a2 = a
                b0, b1, b2 = b
                return ((a0 * b0 + nr * (a1 * b2 + a2 * b1)) % p,
                        (a0 * b1 + a1 * b0 + nr * (a2 * b2)) % p,
                        (a0 * b2 + a1 * b1 + a2 * b0) % p)

            def sqr(a):
                return mul(a, a)

            def add(a, b):
                return (a[0] + b[0], a[1] + b[1], a[2] + b[2])

            def sub(a, b):
                return (a[0] - b[0], a[1] - b[1], a[2] - b[2])
        self.mul, self.sqr, self.add, self.sub = mul, sqr, add, sub

    def is_zero(self, a) -> bool:
        return all(v % self.p == 0 for v in a)

    def inv(self, a):
        return self.raw(self.elem(a).inv())

    @staticmethod
    def raw(e):
        return tuple(c.n for c in e.c)

    def elem(self, a):
        return self.F([self.base(v) for v in a])


class Jacobian:
    """Jacobian arithmetic of one short-Weierstrass curve (an SWCurve)."""

    def __init__(self, curve):
        F = curve.F
        self.curve = curve
        self.f = _Prime(F) if F.extension_degree_over_prime() == 1 \
            else _Ext(F)
        self.a = self.f.raw(curve.a)
        self.one = self.f.raw(F.one())
        if isinstance(self.f, _Prime):     # the hot pair, on ints inline
            self.dbl, self.madd = self._dbl_int, self._madd_int

    # -- conversions -----------------------------------------------------
    def of_affine(self, P):
        """An SWPoint -> Jacobian."""
        if P.is_infinity():
            return None
        return (self.f.raw(P.x), self.f.raw(P.y), self.one)

    def of_projective(self, X, Y, Z):
        """Homogeneous (X : Y : Z), x = X / Z and y = Y / Z, as the card's
        window sums hold them (ops/ec.py) -> Jacobian."""
        f = self.f
        if f.is_zero(Z):
            return None
        return (f.mul(X, Z), f.mul(Y, f.sqr(Z)), Z)

    def to_affine(self, J, check: bool = True):
        """Jacobian -> SWPoint, one inversion; `check` holds the result to
        the curve equation (a faulty window sum fails it)."""
        if J is None:
            return self.curve.infinity()
        f = self.f
        X, Y, Z = J
        zi = f.inv(Z)
        zi2 = f.sqr(zi)
        return self.curve.point(f.elem(f.mul(X, zi2)),
                                f.elem(f.mul(f.mul(Y, zi2), zi)), check)

    # -- the group law ---------------------------------------------------
    def dbl(self, J):
        if J is None:
            return None
        f = self.f
        mul, sqr, add, sub = f.mul, f.sqr, f.add, f.sub
        X, Y, Z = J
        XX, YY, ZZ = sqr(X), sqr(Y), sqr(Z)
        YYYY = sqr(YY)
        S = sqr(add(X, YY))
        S = sub(sub(S, XX), YYYY)
        S = add(S, S)
        M = add(add(add(XX, XX), XX), mul(self.a, sqr(ZZ)))
        X3 = sub(sqr(M), add(S, S))
        Y8 = add(YYYY, YYYY)
        Y8 = add(Y8, Y8)
        Y8 = add(Y8, Y8)
        Y3 = sub(mul(M, sub(S, X3)), Y8)
        Z3 = sub(sub(sqr(add(Y, Z)), YY), ZZ)
        if f.is_zero(Z3):           # a point of order two
            return None
        return (X3, Y3, Z3)

    def add(self, J1, J2):
        if J1 is None:
            return J2
        if J2 is None:
            return J1
        f = self.f
        mul, sqr, add, sub = f.mul, f.sqr, f.add, f.sub
        X1, Y1, Z1 = J1
        X2, Y2, Z2 = J2
        Z1Z1, Z2Z2 = sqr(Z1), sqr(Z2)
        U1, U2 = mul(X1, Z2Z2), mul(X2, Z1Z1)
        S1 = mul(mul(Y1, Z2), Z2Z2)
        S2 = mul(mul(Y2, Z1), Z1Z1)
        H = sub(U2, U1)
        r = sub(S2, S1)
        if f.is_zero(H):
            return self.dbl(J1) if f.is_zero(r) else None
        r = add(r, r)
        I = sqr(add(H, H))
        J = mul(H, I)
        V = mul(U1, I)
        X3 = sub(sub(sqr(r), J), add(V, V))
        S1J = mul(S1, J)
        Y3 = sub(mul(r, sub(V, X3)), add(S1J, S1J))
        Z3 = mul(sub(sub(sqr(add(Z1, Z2)), Z1Z1), Z2Z2), H)
        return (X3, Y3, Z3)

    def madd(self, J1, x2, y2):
        """J1 + (x2, y2), an affine point given by its coordinates."""
        if J1 is None:
            return (x2, y2, self.one)
        f = self.f
        mul, sqr, add, sub = f.mul, f.sqr, f.add, f.sub
        X1, Y1, Z1 = J1
        Z1Z1 = sqr(Z1)
        U2 = mul(x2, Z1Z1)
        S2 = mul(mul(y2, Z1), Z1Z1)
        H = sub(U2, X1)
        r = sub(S2, Y1)
        if f.is_zero(H):
            return self.dbl(J1) if f.is_zero(r) else None
        r = add(r, r)
        HH = sqr(H)
        I = add(HH, HH)
        I = add(I, I)
        J = mul(H, I)
        V = mul(X1, I)
        X3 = sub(sub(sqr(r), J), add(V, V))
        YJ = mul(Y1, J)
        Y3 = sub(mul(r, sub(V, X3)), add(YJ, YJ))
        Z3 = sub(sub(sqr(add(Z1, H)), Z1Z1), HH)
        return (X3, Y3, Z3)

    def _dbl_int(self, J):
        """dbl over a prime field, its arithmetic written out."""
        if J is None:
            return None
        p = self.f.p
        X, Y, Z = J
        XX, YY, ZZ = X * X % p, Y * Y % p, Z * Z % p
        YYYY = YY * YY % p
        S = 2 * ((X + YY) * (X + YY) - XX - YYYY) % p
        M = (3 * XX + self.a * (ZZ * ZZ % p)) % p
        X3 = (M * M - 2 * S) % p
        Y3 = (M * (S - X3) - 8 * YYYY) % p
        Z3 = ((Y + Z) * (Y + Z) - YY - ZZ) % p
        return None if Z3 == 0 else (X3, Y3, Z3)

    def _madd_int(self, J1, x2, y2):
        """madd over a prime field, its arithmetic written out."""
        if J1 is None:
            return (x2, y2, 1)
        p = self.f.p
        X1, Y1, Z1 = J1
        Z1Z1 = Z1 * Z1 % p
        H = (x2 * Z1Z1 - X1) % p
        r = (y2 * Z1 * Z1Z1 - Y1) % p
        if H == 0:
            return self.dbl(J1) if r == 0 else None
        r = 2 * r
        HH = H * H % p
        I = 4 * HH
        J = H * I % p
        V = X1 * I % p
        X3 = (r * r - J - 2 * V) % p
        Y3 = (r * (V - X3) - 2 * Y1 * J) % p
        Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % p
        return (X3, Y3, Z3)

    # -- products and sums -----------------------------------------------
    def mul(self, P, k):
        """k P for an SWPoint P and an int (or field element) k, as
        `SWPoint.__mul__` gives it: left to right, double and add."""
        e = k if isinstance(k, int) else k.n
        if e < 0:
            P, e = -P, -e
        if e == 0 or P.is_infinity():
            return self.curve.infinity()
        x, y, _ = self.of_affine(P)
        acc = None
        for bit in bin(e)[2:]:
            acc = self.dbl(acc)
            if bit == "1":
                acc = self.madd(acc, x, y)
        return self.to_affine(acc, check=False)

    def horner(self, c: int, windows) -> object:
        """sum_w 2^(c w) W_w -> SWPoint, where `windows` gives, from the
        top window down, each window's Jacobian points (W_w their sum)."""
        acc = None
        for pts in windows:
            for _ in range(c):
                acc = self.dbl(acc)
            for J in pts:
                acc = self.add(acc, J)
        return self.to_affine(acc)


@lru_cache(maxsize=None)
def jacobian(curve) -> Jacobian:
    """The Jacobian arithmetic of `curve`, made once a curve."""
    return Jacobian(curve)


def mul(P, k):
    """k P for an SWPoint P, in Jacobian coordinates: the affine
    `P * k`'s result with one inversion in all."""
    return jacobian(P.curve).mul(P, k)
