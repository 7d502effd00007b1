"""Host-side prime field arithmetic (Python big-int backed).

This is the *control-plane* field layer: circuit synthesis, key management,
small-scale group ops, and test oracles run on these exact-integer elements.
The *data-plane* (bulk witness evaluation, MSM, FFT) runs on the limb-tensor
JAX implementation in :mod:`pcd_tpu.fields.fp_tensor`.

Design note (TPU-first, not a port): the reference (arkworks `ark-ff`,
pinned at the reference's Cargo.toml:17) implements Montgomery-form scalar
arithmetic in Rust. Here the host layer deliberately stays in canonical
(non-Montgomery) form — Python's big ints are already fast C bignums — and
Montgomery form exists only on-device where it matters.

Byte layout parity: `ark_ff` serializes an `Fp` as the little-endian bytes of
its 64-bit limb array, i.e. ``8 * ceil(bits/64)`` bytes (e.g. 40 bytes for the
298-bit MNT fields).  Hash preimages in the PCD construction are exactly these
bytes (reference: src/ec_cycle_pcd/mod.rs:123-141), so `to_bytes` matches that
layout.

A frozen copy of the port's `pcd_tpu_torch/fields/prime.py` for the
benchmark's plain reference; it imports nothing of the program.
"""

from __future__ import annotations

import random as _random
from functools import lru_cache


class FpMeta(type):
    def __repr__(cls):  # pragma: no cover
        return getattr(cls, "NAME", cls.__name__)


class Fp(metaclass=FpMeta):
    """A prime-field element. Subclasses bind MODULUS via make_prime_field."""

    __slots__ = ("n",)

    MODULUS: int = 0
    NAME: str = "Fp"
    # Filled in by make_prime_field:
    BITS: int = 0              # modulus bit length
    BYTES: int = 0             # serialized length: 8 * ceil(BITS / 64)
    CAPACITY: int = 0          # BITS - 1 (bits that always fit)
    TWO_ADICITY: int = 0
    TWO_ADIC_ROOT: int = 0     # generator of the 2-Sylow subgroup
    GENERATOR: int = 0         # multiplicative group generator (small)

    def __init__(self, n: int):
        self.n = n % self.MODULUS

    # -- constructors -------------------------------------------------
    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def from_int(cls, n: int):
        return cls(n)

    @classmethod
    def rand(cls, rng: _random.Random | None = None):
        r = rng or _random
        return cls(r.randrange(cls.MODULUS))

    @classmethod
    def from_bytes(cls, b: bytes):
        n = int.from_bytes(b, "little")
        if n >= cls.MODULUS:
            raise ValueError("non-canonical field bytes")
        return cls(n)

    @classmethod
    def from_bytes_mod_order(cls, b: bytes):
        return cls(int.from_bytes(b, "little"))

    # -- serialization (arkworks LE limb layout) ----------------------
    def to_bytes(self) -> bytes:
        return self.n.to_bytes(self.BYTES, "little")

    def to_bits_le(self, nbits: int | None = None) -> list:
        nb = self.BITS if nbits is None else nbits
        return [(self.n >> i) & 1 == 1 for i in range(nb)]

    @classmethod
    def from_bits_le(cls, bits) -> "Fp":
        n = 0
        for i, b in enumerate(bits):
            if b:
                n |= 1 << i
        return cls(n)

    # -- arithmetic ----------------------------------------------------
    def __add__(self, o):
        return type(self)(self.n + o.n)

    def __sub__(self, o):
        return type(self)(self.n - o.n)

    def __neg__(self):
        return type(self)(-self.n)

    def __mul__(self, o):
        if isinstance(o, int):
            return type(self)(self.n * o)
        return type(self)(self.n * o.n)

    __rmul__ = __mul__

    def square(self):
        return type(self)(self.n * self.n)

    def double(self):
        return type(self)(self.n << 1)

    def inv(self):
        if self.n == 0:
            raise ZeroDivisionError(f"inverse of zero in {self.NAME}")
        return type(self)(pow(self.n, -1, self.MODULUS))

    def __truediv__(self, o):
        return self * o.inv()

    def __pow__(self, e: int):
        if e < 0:
            return self.inv() ** (-e)
        return type(self)(pow(self.n, e, self.MODULUS))

    def __eq__(self, o):
        return isinstance(o, Fp) and self.MODULUS == o.MODULUS and self.n == o.n

    def __hash__(self):
        return hash((self.MODULUS, self.n))

    def __repr__(self):  # pragma: no cover
        return f"{self.NAME}({self.n})"

    def is_zero(self) -> bool:
        return self.n == 0

    def is_one(self) -> bool:
        return self.n == 1

    # -- square roots --------------------------------------------------
    def legendre(self) -> int:
        p = self.MODULUS
        if self.n == 0:
            return 0
        return 1 if pow(self.n, (p - 1) // 2, p) == 1 else -1

    def is_square(self) -> bool:
        return self.n == 0 or self.legendre() == 1

    def sqrt(self):
        """Tonelli–Shanks; returns the 'smaller' root or None if non-square."""
        p = self.MODULUS
        a = self.n
        if a == 0:
            return type(self)(0)
        if self.legendre() != 1:
            return None
        s, q = self.TWO_ADICITY, (p - 1) >> self.TWO_ADICITY
        z = pow(self.GENERATOR, q, p)  # generator of 2-Sylow subgroup
        m, c = s, z
        t = pow(a, q, p)
        r = pow(a, (q + 1) // 2, p)
        while t != 1:
            # find least i with t^(2^i) == 1
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            r = r * b % p
            t = t * c % p
        if r > p - r:
            r = p - r
        return type(self)(r)

    # Extension-field protocol glue (a prime field is a degree-1 extension
    # of itself); lets generic tower code treat Fp uniformly.
    DEGREE = 1

    @classmethod
    def base_field(cls):
        return cls

    def to_base_coeffs(self):
        return [self]

    @classmethod
    def from_base_coeffs(cls, coeffs):
        assert len(coeffs) == 1
        return coeffs[0]

    @classmethod
    def extension_degree_over_prime(cls) -> int:
        return 1

    @classmethod
    def prime_subfield(cls):
        return cls

    @classmethod
    def order(cls) -> int:
        return cls.MODULUS

    @classmethod
    def characteristic(cls) -> int:
        return cls.MODULUS

    def frobenius(self, power: int = 1):
        return self


def _two_adicity(n: int) -> int:
    a = 0
    while n % 2 == 0:
        n //= 2
        a += 1
    return a


def _find_generator(p: int) -> int:
    """Smallest generator of Fp^* (matches common practice; value is only
    used internally for Tonelli–Shanks and FFT twiddle derivation)."""
    n = p - 1
    factors = []
    m = n
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1 if d == 2 else 2
        if d > 1_000_000 and m > 1:
            # m's remaining factor(s) are large; treat m as prime-ish factor
            break
    if m > 1:
        factors.append(m)
    g = 2
    while True:
        if all(pow(g, n // f, p) != 1 for f in factors):
            return g
        g += 1


@lru_cache(maxsize=None)
def make_prime_field(modulus: int, name: str, generator: int | None = None):
    """Create (and cache) a prime-field class for `modulus`."""
    bits = modulus.bit_length()
    g = generator if generator is not None else _find_generator(modulus)
    adic = _two_adicity(modulus - 1)
    cls = FpMeta(
        name,
        (Fp,),
        dict(
            __slots__=(),
            MODULUS=modulus,
            NAME=name,
            BITS=bits,
            BYTES=8 * ((bits + 63) // 64),
            CAPACITY=bits - 1,
            TWO_ADICITY=adic,
            GENERATOR=g,
            TWO_ADIC_ROOT=pow(g, (modulus - 1) >> adic, modulus),
        ),
    )
    return cls
