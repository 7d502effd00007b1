"""Twisted Edwards curve gadget (replaces ark-r1cs-std
groups::curves::twisted_edwards::AffineVar; required ops pinned at reference
src/variable_length_crh/pedersen/constraints.rs:74 and
bowe_hopwood/constraints.rs:92).

Addition uses the complete TE law (the CRH curves are complete: a square,
d non-square — see pcd_tpu/fields/constants.py), at 5 constraints per add:
  t = x1*x2;  s = y1*y2;  ts = t*s
  x3 * (1 + d*ts) = x1*y2 + y1*x2   (x1*y2+y1*x2 via (x1+y1)(x2+y2)-t-s)
  y3 * (1 - d*ts) = s - a*t

The port's copy of `pcd_tpu/gadgets/te.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from .fp import Boolean, FpVarBase


class TEAffineVar:
    __slots__ = ("curve", "x", "y")

    def __init__(self, curve, x, y):
        self.curve = curve  # host TECurve (source of a, d constants)
        self.x = x
        self.y = y

    # -- constructors ---------------------------------------------------
    @staticmethod
    def identity(fpcls, curve):
        return TEAffineVar(curve, fpcls.zero(), fpcls.one())

    @staticmethod
    def constant(fpcls, pt):
        return TEAffineVar(pt.curve, fpcls.constant(pt.x.n), fpcls.constant(pt.y.n))

    @staticmethod
    def new_witness(fpcls, pt, check: bool = True):
        v = TEAffineVar(pt.curve, fpcls.new_witness(pt.x.n), fpcls.new_witness(pt.y.n))
        if check:
            v.enforce_on_curve()
        return v

    def enforce_on_curve(self):
        c = self.curve
        x2 = self.x * self.x
        y2 = self.y * self.y
        lhs = x2.scale(c.a.n) + y2
        rhs = x2 * y2
        one = type(self.x).one()
        lhs.enforce_equal(one + rhs.scale(c.d.n))

    def value(self):
        from ..curves.twisted_edwards import TEPoint

        F = self.curve.F
        return TEPoint(self.curve, F(self.x.val), F(self.y.val))

    # -- group law ------------------------------------------------------
    def add(self, o: "TEAffineVar"):
        c = self.curve
        x1, y1, x2, y2 = self.x, self.y, o.x, o.y
        t = x1 * x2
        s = y1 * y2
        ts = t * s
        xy = (x1 + y1) * (x2 + y2) - t - s
        d_ts = ts.scale(c.d.n)
        one = type(x1).one()
        # division constraints
        den_x = one + d_ts
        den_y = one - d_ts
        x3 = xy / den_x
        y3 = (s - t.scale(c.a.n)) / den_y
        return TEAffineVar(c, x3, y3)

    __add__ = add

    def add_constant(self, pt):
        """Add a host constant point (cheaper: 3 muls)."""
        c = self.curve
        x1, y1 = self.x, self.y
        x2, y2 = pt.x.n, pt.y.n
        t = x1.scale(x2)       # x1*x2 — linear
        s = y1.scale(y2)
        ts = t * s             # 1 constraint
        xy = x1.scale(y2) + y1.scale(x2)
        d_ts = ts.scale(c.d.n)
        one = type(x1).one()
        x3 = xy / (one + d_ts)
        y3 = (s - t.scale(c.a.n)) / (one - d_ts)
        return TEAffineVar(c, x3, y3)

    def negate(self):
        return TEAffineVar(self.curve, -self.x, self.y)

    def conditional_negate(self, b: Boolean):
        """x -> x * (1 - 2b): one constraint."""
        new_x = self.x - (b.fp * self.x).scale(2)
        return TEAffineVar(self.curve, new_x, self.y)

    def enforce_equal(self, o: "TEAffineVar"):
        self.x.enforce_equal(o.x)
        self.y.enforce_equal(o.y)

    # -- fixed-base scalar multiplication gadgets -----------------------
    @staticmethod
    def precomputed_base_scalar_mul_le(fpcls, bits, bases):
        """sum_i bits[i] * bases[i] for host constant points bases
        (the Pedersen CRH gadget core — reference pedersen/constraints.rs:74).

        Conditional add: acc' = select(b, acc + base, acc)."""
        acc = TEAffineVar.identity(fpcls, bases[0].curve)
        for b, base in zip(bits, bases):
            added = acc.add_constant(base)
            nx = b.select(added.x, acc.x)
            ny = b.select(added.y, acc.y)
            acc = TEAffineVar(acc.curve, nx, ny)
        return acc

    @staticmethod
    def precomputed_base_3_bit_signed_digit_scalar_mul(fpcls, generators, bit_chunks):
        """Bowe-Hopwood core (reference bowe_hopwood/constraints.rs:92 and
        the native encoding at bowe_hopwood/mod.rs:129-149):

        generators: list of windows; window = list of host points (slot i
        holds 16^i * base).  bit_chunks: windows of 3-bit chunks (Booleans,
        LSB-first: [c0, c1, c2]).  Encoded point per chunk:
        (1 + c0 + 2*c1) * g, then negated iff c2."""
        curve = generators[0][0].curve
        acc = None
        for win_gens, win_chunks in zip(generators, bit_chunks):
            for g, chunk in zip(win_gens, win_chunks):
                c0, c1, c2 = chunk
                # table of constant multiples: g, 2g, 3g, 4g
                t = [g, g + g, g + g + g, (g + g) + (g + g)]
                # two-bit constant lookup: val = t0 + c0(t1-t0) + c1(t2-t0)
                #                              + c0c1(t3-t2-t1+t0)
                c0c1 = (c0 & c1).fp
                def lookup(coord):
                    v0, v1, v2, v3 = (getattr(tt, coord).n for tt in t)
                    out = fpcls.constant(v0)
                    out = out + c0.fp.scale(v1 - v0)
                    out = out + c1.fp.scale(v2 - v0)
                    out = out + c0c1.scale(v3 - v2 - v1 + v0)
                    return out
                px = lookup("x")
                py = lookup("y")
                enc = TEAffineVar(curve, px, py).conditional_negate(c2)
                acc = enc if acc is None else acc + enc
        return acc
