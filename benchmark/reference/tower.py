"""Host-side binomial extension-field towers: Fp2, Fp3, Fp4 = Fp2[v]/(v^2-u),
Fp6 = Fp3[v]/(v^2-u).

Generic over any base field class following the protocol in
:mod:`pcd_tpu.fields.prime`.  An extension of degree k is F[v]/(v^k - NR)
with NR an element of the base field (possibly itself an extension element,
e.g. the MNT4 tower uses Fq4 = Fq2[v]/(v^2 - u) where u is the Fq2 generator).

The reference delegates all of this to `ark-ff` (Cargo.toml:17); tower shapes
are pinned by the MNT4/MNT6 pairings used at tests/mnt4_*.rs.

A frozen copy of the port's `pcd_tpu_torch/fields/tower.py` for the
benchmark's plain reference; it imports nothing of the program.
"""

from __future__ import annotations

import random as _random
from functools import lru_cache


class ExtElem:
    """Element of a binomial extension; `c` is a tuple of base elements,
    c[i] the coefficient of v^i."""

    __slots__ = ("c",)

    BASE = None          # base field class
    DEGREE = 0           # extension degree over BASE
    NR = None            # non-residue: v^DEGREE = NR (element of BASE)
    NAME = "Ext"
    _FROB = None         # cache: frobenius coefficient tables

    def __init__(self, coeffs):
        assert len(coeffs) == self.DEGREE
        self.c = tuple(coeffs)

    # -- constructors --------------------------------------------------
    @classmethod
    def zero(cls):
        return cls([cls.BASE.zero()] * cls.DEGREE)

    @classmethod
    def one(cls):
        return cls([cls.BASE.one()] + [cls.BASE.zero()] * (cls.DEGREE - 1))

    @classmethod
    def gen_v(cls):
        """The adjoined root v."""
        z, o = cls.BASE.zero(), cls.BASE.one()
        return cls([z, o] + [z] * (cls.DEGREE - 2))

    @classmethod
    def from_base(cls, x):
        return cls([x] + [cls.BASE.zero()] * (cls.DEGREE - 1))

    @classmethod
    def from_int(cls, n: int):
        return cls.from_base(cls.BASE.from_int(n))

    @classmethod
    def rand(cls, rng: _random.Random | None = None):
        return cls([cls.BASE.rand(rng) for _ in range(cls.DEGREE)])

    # -- protocol ------------------------------------------------------
    @classmethod
    def base_field(cls):
        return cls.BASE

    @classmethod
    def extension_degree_over_prime(cls) -> int:
        return cls.DEGREE * cls.BASE.extension_degree_over_prime()

    @classmethod
    def prime_subfield(cls):
        return cls.BASE.prime_subfield()

    @classmethod
    def characteristic(cls) -> int:
        return cls.BASE.characteristic()

    @classmethod
    def order(cls) -> int:
        return cls.BASE.order() ** cls.DEGREE

    def to_base_coeffs(self):
        return list(self.c)

    @classmethod
    def from_base_coeffs(cls, coeffs):
        return cls(coeffs)

    def to_prime_coeffs(self):
        """Flatten to a list of prime-subfield elements (tower order:
        lower-degree coefficients first — matches arkworks' flattening)."""
        out = []
        for ci in self.c:
            if hasattr(ci, "to_prime_coeffs"):
                out.extend(ci.to_prime_coeffs())
            else:
                out.append(ci)
        return out

    @classmethod
    def from_prime_coeffs(cls, coeffs):
        k = cls.BASE.extension_degree_over_prime()
        cs = []
        for i in range(cls.DEGREE):
            chunk = coeffs[i * k : (i + 1) * k]
            if k == 1:
                cs.append(chunk[0])
            else:
                cs.append(cls.BASE.from_prime_coeffs(chunk))
        return cls(cs)

    def to_bytes(self) -> bytes:
        return b"".join(x.to_bytes() for x in self.to_prime_coeffs())

    # -- arithmetic ----------------------------------------------------
    def __add__(self, o):
        return type(self)([a + b for a, b in zip(self.c, o.c)])

    def __sub__(self, o):
        return type(self)([a - b for a, b in zip(self.c, o.c)])

    def __neg__(self):
        return type(self)([-a for a in self.c])

    def double(self):
        return self + self

    def mul_base(self, s):
        return type(self)([a * s for a in self.c])

    def __mul__(self, o):
        if isinstance(o, int):
            return type(self)([a * o for a in self.c])
        if not isinstance(o, ExtElem):
            # base-field scalar
            return self.mul_base(o)
        k = self.DEGREE
        nr = self.NR
        a, b = self.c, o.c
        if k == 2:
            # Karatsuba: 3 base muls
            v0 = a[0] * b[0]
            v1 = a[1] * b[1]
            m = (a[0] + a[1]) * (b[0] + b[1])
            return type(self)([v0 + nr * v1, m - v0 - v1])
        if k == 3:
            # Karatsuba: 6 base muls
            v0 = a[0] * b[0]
            v1 = a[1] * b[1]
            v2 = a[2] * b[2]
            m01 = (a[0] + a[1]) * (b[0] + b[1])
            m02 = (a[0] + a[2]) * (b[0] + b[2])
            m12 = (a[1] + a[2]) * (b[1] + b[2])
            c0 = v0 + nr * (m12 - v1 - v2)
            c1 = m01 - v0 - v1 + nr * v2
            c2 = m02 - v0 - v2 + v1
            return type(self)([c0, c1, c2])
        # generic schoolbook fallback
        z = self.BASE.zero()
        acc = [z] * (2 * k - 1)
        for i in range(k):
            ai = a[i]
            if ai.is_zero():
                continue
            for j in range(k):
                acc[i + j] = acc[i + j] + ai * b[j]
        out = list(acc[:k])
        for t in range(k - 1):
            out[t] = out[t] + acc[k + t] * nr
        return type(self)(out)

    __rmul__ = __mul__

    def square(self):
        k = self.DEGREE
        nr = self.NR
        a = self.c
        if k == 2:
            # complex squaring: 2 base muls
            v0 = a[0] * a[1]
            m = (a[0] + a[1]) * (a[0] + nr * a[1])
            return type(self)([m - v0 - nr * v0, v0 + v0])
        if k == 3:
            # Chung–Hasan SQR2: 5 base muls
            s0 = a[0] * a[0]
            ab = a[0] * a[1]
            s1 = ab + ab
            s2 = (a[0] - a[1] + a[2]) * (a[0] - a[1] + a[2])
            bc = a[1] * a[2]
            s3 = bc + bc
            s4 = a[2] * a[2]
            return type(self)([s0 + nr * s3,
                               s1 + nr * s4,
                               s1 + s2 + s3 - s0 - s4])
        return self * self

    def is_zero(self):
        return all(a.is_zero() for a in self.c)

    def is_one(self):
        return self.c[0].is_one() and all(a.is_zero() for a in self.c[1:])

    def __eq__(self, o):
        return type(self) is type(o) and self.c == o.c

    def __hash__(self):
        return hash((self.NAME, self.c))

    def __repr__(self):  # pragma: no cover
        return f"{self.NAME}{list(self.c)}"

    def __pow__(self, e: int):
        if e < 0:
            return self.inv() ** (-e)
        r = type(self).one()
        b = self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def inv(self):
        k = self.DEGREE
        if k == 2:
            a0, a1 = self.c
            # (a0 + a1 v)^-1 = (a0 - a1 v) / (a0^2 - NR a1^2)
            norm = a0 * a0 - self.NR * (a1 * a1)
            ninv = norm.inv()
            return type(self)([a0 * ninv, -(a1 * ninv)])
        if k == 3:
            a0, a1, a2 = self.c
            nr = self.NR
            t0 = a0 * a0 - nr * (a1 * a2)
            t1 = nr * (a2 * a2) - a0 * a1
            t2 = a1 * a1 - a0 * a2
            norm = a0 * t0 + nr * (a2 * t1) + nr * (a1 * t2)
            ninv = norm.inv()
            return type(self)([t0 * ninv, t1 * ninv, t2 * ninv])
        raise NotImplementedError(f"inv for degree {k}")

    def __truediv__(self, o):
        return self * o.inv()

    def conjugate(self):
        """Only for quadratic extensions: a0 - a1 v."""
        assert self.DEGREE == 2
        return type(self)([self.c[0], -self.c[1]])

    # -- frobenius -----------------------------------------------------
    @classmethod
    def _frob_coeff(cls, power: int):
        """v^(p^power) = FROB[power] * v, where FROB[power] = NR^((p^power - 1)/k).

        Valid because k | p-1 for all towers we instantiate (the binomial
        nonresidue exists in the base field's prime subfield structure)."""
        if cls._FROB is None:
            cls._FROB = {}
        if power not in cls._FROB:
            p = cls.characteristic()
            k = cls.DEGREE
            e = (p**power - 1) // k
            cls._FROB[power] = cls.NR ** e
        return cls._FROB[power]

    def frobenius(self, power: int = 1):
        """x -> x^(p^power) (p = characteristic)."""
        deg_total = self.extension_degree_over_prime()
        power = power % deg_total
        if power == 0:
            return self
        out = []
        for i, ci in enumerate(self.c):
            cf = ci.frobenius(power)
            if i > 0:
                # v^(i p^power) = (frob_coeff)^i * v^i
                cf = cf * (self._frob_coeff(power) ** i)
            out.append(cf)
        return type(self)(out)

    # -- square root (generic Tonelli–Shanks over the full group) ------
    def legendre(self):
        n = (self.order() - 1) // 2
        r = self**n
        if r.is_one():
            return 1
        if r.is_zero():
            return 0
        return -1

    def is_square(self):
        return self.is_zero() or self.legendre() == 1

    @classmethod
    @lru_cache(maxsize=None)
    def _sqrt_consts(cls):
        n = cls.order() - 1
        s = 0
        while n % 2 == 0:
            n //= 2
            s += 1
        # find a quadratic nonresidue deterministically
        rng = _random.Random(12345)
        while True:
            z = cls.rand(rng)
            if not z.is_zero() and z.legendre() == -1:
                return n, s, z**n
        # unreachable

    def sqrt(self):
        if self.is_zero():
            return type(self).zero()
        if self.legendre() != 1:
            return None
        q, s, c = self._sqrt_consts()
        m = s
        t = self**q
        r = self ** ((q + 1) // 2)
        one = type(self).one()
        while not t.is_one():
            i, t2 = 0, t
            while not t2.is_one():
                t2 = t2 * t2
                i += 1
            b = c
            for _ in range(m - i - 1):
                b = b * b
            m, c = i, b * b
            r = r * b
            t = t * c
        return r


@lru_cache(maxsize=None)
def make_ext_field(base, degree: int, nr_key, name: str):
    """Create a binomial extension field class base[v]/(v^degree - nr).

    `nr_key` must be hashable: either an int (interpreted in `base`'s prime
    subfield and lifted) or a tuple of ints giving base-coefficients of NR.
    """
    if isinstance(nr_key, int):
        nr = base.from_int(nr_key)
    else:
        prime = base.prime_subfield()
        nr = base.from_prime_coeffs([prime.from_int(x) for x in nr_key])
    cls = type(
        name,
        (ExtElem,),
        dict(__slots__=(), BASE=base, DEGREE=degree, NR=nr, NAME=name, _FROB=None),
    )
    return cls
