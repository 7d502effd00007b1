"""Core R1CS gadgets: FpVar, Boolean, UInt8 (replaces ark-r1cs-std's
fields::fp / bits::boolean / bits::uint8 — reference Cargo.toml:26; required
ops pinned at SURVEY.md D8).

A per-ConstraintSystem FpVar *class* is created by `fpvar_class(cs)`.  The
class satisfies the same field protocol as the host fields
(pcd_tpu/fields/prime.py), so the generic binomial-tower code in
pcd_tpu/fields/tower.py runs unchanged over FpVars to give in-circuit
Fp2/Fp3/Fp4/Fp6 arithmetic — one tower implementation for host ints and
symbolic circuit values (this replaces arkworks' separate Fp2Var/Fp3Var/... ).

Byte layout: `to_bytes` emits 8*ceil(bits/64) bytes (little-endian bit order
within bytes), identical to the native field `to_bytes` — the PCD hash
preimages depend on native/gadget agreement (reference src/ec_cycle_pcd/
mod.rs:101-105 and data_structures.rs:222-249).
Bit decomposition is canonical: booleanity + recomposition + an
enforced value <= p-1 comparison (arkworks' `enforce_in_field_le`).

The port's copy of `pcd_tpu/gadgets/fp.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from ..r1cs.system import ConstraintSystem, SynthesisError


class FpVarBase:
    """Symbolic field element in a circuit: linear combination + value.

    lc is None for constants (no variables involved)."""

    __slots__ = ("lc", "val")

    CS: ConstraintSystem = None
    F = None
    MODULUS = 0
    DEGREE = 1

    def __init__(self, lc, val: int):
        self.lc = lc
        self.val = val

    # -- protocol / constructors ---------------------------------------
    @classmethod
    def constant(cls, n):
        if hasattr(n, "n"):
            n = n.n
        return cls(None, n % cls.MODULUS)

    @classmethod
    def zero(cls):
        return cls(None, 0)

    @classmethod
    def one(cls):
        return cls(None, 1)

    @classmethod
    def from_int(cls, n: int):
        return cls.constant(n)

    @classmethod
    def new_witness(cls, value):
        if hasattr(value, "n"):
            value = value.n
        v = cls.CS.new_witness(value)
        return cls({v: 1}, value % cls.MODULUS)

    @classmethod
    def new_instance(cls, value):
        if hasattr(value, "n"):
            value = value.n
        v = cls.CS.new_instance(value)
        return cls({v: 1}, value % cls.MODULUS)

    new_input = new_instance

    @classmethod
    def base_field(cls):
        return cls

    @classmethod
    def prime_subfield(cls):
        return cls

    @classmethod
    def extension_degree_over_prime(cls):
        return 1

    @classmethod
    def characteristic(cls):
        return cls.MODULUS

    def to_base_coeffs(self):
        return [self]

    @classmethod
    def from_base_coeffs(cls, coeffs):
        assert len(coeffs) == 1
        return coeffs[0]

    @classmethod
    def from_prime_coeffs(cls, coeffs):
        c = coeffs[0]
        if isinstance(c, FpVarBase):
            return c
        return cls.constant(c)

    def frobenius(self, power: int = 1):
        return self

    # -- predicates -----------------------------------------------------
    @property
    def is_constant(self) -> bool:
        return self.lc is None

    def is_zero(self) -> bool:
        """Protocol hook (used by generic tower code to skip terms):
        True only for the *constant* zero."""
        return self.lc is None and self.val == 0

    def is_one(self) -> bool:
        return self.lc is None and self.val == 1

    def value(self):
        return self.F(self.val)

    # -- linear arithmetic (constraint-free) -----------------------------
    def _as_lc(self):
        if self.lc is None:
            return {0: self.val} if self.val else {}
        return self.lc

    # LCs longer than this are materialized into a fresh witness (one
    # extra constraint).  Without the cap, iterative gadgets (the Miller
    # loop above all) grow coordinate LCs by a few terms per round and
    # then multiply them: measured 82M total LC terms in the real-scale
    # MainCircuit (dominating synthesis, matrix nnz, and witness replay).
    LC_CAP = 16

    def _capped(self):
        """Materialize an over-long LC as a witness wire: w = <lc>."""
        cls = type(self)
        w = cls.new_witness(self.val)
        self.CS.set_last_recipe(("lc", self.lc))
        self.CS.enforce(self.lc, {0: 1}, w.lc)
        return w

    def __add__(self, o):
        cls = type(self)
        if isinstance(o, int):
            o = cls.constant(o)
        if self.lc is None and o.lc is None:
            return cls(None, (self.val + o.val) % self.MODULUS)
        # lazy coefficients: no per-key mod (consumers reduce); additive
        # growth only, so magnitudes stay tiny multiples of p
        lc = dict(self._as_lc())
        for v, c in o._as_lc().items():
            x = lc.get(v)
            lc[v] = c if x is None else x + c
        out = cls(lc, (self.val + o.val) % self.MODULUS)
        if len(lc) > self.LC_CAP:
            return out._capped()
        return out

    def __sub__(self, o):
        return self + (-o)

    def __neg__(self):
        cls = type(self)
        if self.lc is None:
            return cls(None, (-self.val) % self.MODULUS)
        return cls({v: -c for v, c in self.lc.items()},
                   (-self.val) % self.MODULUS)

    def double(self):
        return self + self

    def scale(self, k: int):
        """Multiply by an integer/constant — constraint-free."""
        cls = type(self)
        p = self.MODULUS
        k = k % p
        if k == 0:
            return cls.zero()
        if self.lc is None:
            return cls(None, self.val * k % p)
        return cls({v: c * k % p for v, c in self.lc.items()},
                   self.val * k % p)

    def __mul__(self, o):
        cls = type(self)
        if isinstance(o, int):
            return self.scale(o)
        if not isinstance(o, FpVarBase):
            # host field element constant
            return self.scale(o.n)
        if o.lc is None:
            return self.scale(o.val)
        if self.lc is None:
            return o.scale(self.val)
        # both symbolic: allocate product witness
        p = self.MODULUS
        prod = self.val * o.val % p
        out = cls.new_witness(prod)
        self.CS.set_last_recipe(("mul", self.lc, o.lc))
        self.CS.enforce(self.lc, o.lc, out.lc)
        return out

    __rmul__ = __mul__

    def square(self):
        return self * self

    def inv(self):
        cls = type(self)
        p = self.MODULUS
        if self.lc is None:
            if self.val == 0:
                raise SynthesisError("inverse of zero constant in circuit")
            return cls(None, pow(self.val, -1, p))
        if self.val == 0:
            raise SynthesisError("inverse of zero in circuit (witness)")
        out = cls.new_witness(pow(self.val, -1, p))
        self.CS.set_last_recipe(("inv", self.lc))
        self.CS.enforce(self.lc, out.lc, {0: 1})
        return out

    def __truediv__(self, o):
        if isinstance(o, int):
            o = type(self).constant(o)
        return self * o.inv()

    def __pow__(self, e: int):
        if e < 0:
            return self.inv() ** (-e)
        r = type(self).one()
        b = self
        while e:
            if e & 1:
                r = r * b
            b = b * b
            e >>= 1
        return r

    # -- constraints -----------------------------------------------------
    def enforce_equal(self, o):
        if isinstance(o, int):
            o = type(self).constant(o)
        d = self - o
        if d.lc is None:
            if d.val != 0:
                raise SynthesisError("constant equality violated")
            return
        self.CS.enforce(d.lc, {0: 1}, {})

    def enforce_not_equal(self, o):
        # (a - b) has an inverse
        (self - o).inv()

    def conditional_enforce_equal(self, o, cond: "Boolean"):
        # cond * (a - b) == 0
        d = self - o
        self.CS.enforce(cond.fp._as_lc(), d._as_lc(), {})

    def __eq__(self, o):  # structural/value equality for host-side checks
        if not isinstance(o, FpVarBase):
            return NotImplemented
        return self.val == o.val and self.lc == o.lc

    def __hash__(self):
        return hash(self.val)

    # -- bit decomposition ----------------------------------------------
    def to_bits_le(self, canonical: bool = True):
        """LSB-first booleans of length F.BITS; canonical (< p) enforced
        unless canonical=False (arkworks to_non_unique_bits_le)."""
        cls = type(self)
        nbits = self.F.BITS
        if self.lc is None:
            return [Boolean.constant(cls, (self.val >> i) & 1 == 1)
                    for i in range(nbits)]
        bits = []
        v = self.val
        src_lc = self.lc  # shared object -> replay groups the bits
        for i in range(nbits):
            bits.append(Boolean.new_witness(cls, (v >> i) & 1 == 1))
            cls.CS.set_last_recipe(("bit", src_lc, i))
        # recomposition: sum b_i 2^i == self (single fused LC)
        Boolean.le_bits_to_fp(cls, bits).enforce_equal(self)
        if canonical:
            Boolean.enforce_in_field_le(cls, bits)
        return bits

    def to_bytes(self):
        """UInt8 gadgets, length 8*ceil(bits/64) — matches native to_bytes."""
        cls = type(self)
        bits = self.to_bits_le()
        total = self.F.BYTES * 8
        bits = bits + [Boolean.constant(cls, False)] * (total - len(bits))
        return [UInt8(bits[i : i + 8]) for i in range(0, total, 8)]


class Boolean:
    """A 0/1 circuit value, wrapping an FpVar."""

    __slots__ = ("fp",)

    def __init__(self, fp):
        self.fp = fp

    @staticmethod
    def constant(fpcls, b: bool):
        return Boolean(fpcls.constant(1 if b else 0))

    @staticmethod
    def new_witness(fpcls, b: bool):
        fp = fpcls.new_witness(1 if b else 0)
        # booleanity: b * (1 - b) = 0
        fpcls.CS.enforce(fp.lc, (fpcls.one() - fp)._as_lc(), {})
        return Boolean(fp)

    @staticmethod
    def from_fp_unchecked(fp):
        return Boolean(fp)

    @property
    def value(self) -> bool:
        return self.fp.val == 1

    @property
    def is_constant(self) -> bool:
        return self.fp.is_constant

    def __and__(self, o: "Boolean"):
        if self.is_constant:
            return o if self.value else self
        if o.is_constant:
            return self if o.value else o
        return Boolean(self.fp * o.fp)

    def __or__(self, o: "Boolean"):
        if self.is_constant:
            return self if self.value else o
        if o.is_constant:
            return o if o.value else self
        return Boolean(self.fp + o.fp - self.fp * o.fp)

    def __xor__(self, o: "Boolean"):
        if self.is_constant:
            return o.negate() if self.value else o
        if o.is_constant:
            return self.negate() if o.value else self
        return Boolean(self.fp + o.fp - (self.fp * o.fp).scale(2))

    def negate(self):
        return Boolean(type(self.fp).one() - self.fp)

    def enforce_equal(self, o: "Boolean"):
        self.fp.enforce_equal(o.fp)

    def enforce_true(self):
        self.fp.enforce_equal(type(self.fp).one())

    def select(self, t, f):
        """self ? t : f  for FpVar/Boolean/ExtElem-of-FpVar operands
        (CondSelectGadget — reference variable_length_crh/constraints.rs:16)."""
        if isinstance(t, Boolean):
            return Boolean(self.select(t.fp, f.fp))
        if isinstance(t, FpVarBase):
            return f + self.fp * (t - f)
        # extension element (generic tower type): select coefficient-wise
        tc, fc = t.to_base_coeffs(), f.to_base_coeffs()
        return type(t).from_base_coeffs([self.select(a, b) for a, b in zip(tc, fc)])

    @staticmethod
    def le_bits_to_fp(fpcls, bits):
        """sum b_i 2^i as one fused linear combination (no quadratic blowup)."""
        p = fpcls.MODULUS
        lc = {}
        val = 0
        const_acc = 0
        for i, b in enumerate(bits):
            w = (1 << i) % p
            fp = b.fp
            if fp.lc is None:
                const_acc += fp.val * w
            else:
                for v, c in fp.lc.items():
                    lc[v] = (lc.get(v, 0) + c * w) % p
            val += fp.val * w
        if const_acc:
            lc[0] = (lc.get(0, 0) + const_acc) % p
        lc = {v: c for v, c in lc.items() if c}
        if not lc:
            return fpcls(None, val % p)
        return fpcls(lc, val % p)

    @staticmethod
    def enforce_in_field_le(fpcls, bits):
        """Enforce value(bits) <= p - 1 (canonical decomposition)."""
        m = fpcls.MODULUS - 1
        # scan MSB -> LSB tracking `eq_so_far`; forbid b_i=1 where m_i=0
        # while still equal.  gt = OR_i (eq_{>i} AND b_i AND NOT m_i)
        eq = Boolean.constant(fpcls, True)
        gt = Boolean.constant(fpcls, False)
        for i in reversed(range(len(bits))):
            b = bits[i]
            mi = (m >> i) & 1
            if mi:
                eq = eq & b
            else:
                gt = gt | (eq & b)
        gt.negate().enforce_true()


class UInt8:
    """8 LSB-first booleans (reference ark-r1cs-std bits::uint8)."""

    __slots__ = ("bits",)

    def __init__(self, bits):
        assert len(bits) == 8
        self.bits = list(bits)

    @staticmethod
    def constant(fpcls, byte: int):
        return UInt8([Boolean.constant(fpcls, (byte >> i) & 1 == 1)
                      for i in range(8)])

    @staticmethod
    def constant_vec(fpcls, data: bytes):
        return [UInt8.constant(fpcls, b) for b in data]

    @staticmethod
    def new_witness(fpcls, byte: int):
        return UInt8([Boolean.new_witness(fpcls, (byte >> i) & 1 == 1)
                      for i in range(8)])

    @staticmethod
    def new_witness_vec(fpcls, data: bytes):
        return [UInt8.new_witness(fpcls, b) for b in data]

    @property
    def value(self) -> int:
        v = 0
        for i, b in enumerate(self.bits):
            if b.value:
                v |= 1 << i
        return v

    def to_bits_le(self):
        return list(self.bits)


def fpvar_class(cs: ConstraintSystem):
    """The (cached) FpVar class bound to `cs`."""
    cls = getattr(cs, "_fpvar_cls", None)
    if cls is None:
        cls = type(f"FpVar[{cs.F.NAME}]", (FpVarBase,),
                   dict(__slots__=(), CS=cs, F=cs.F, MODULUS=cs.F.MODULUS))
        cs._fpvar_cls = cls
    return cls
