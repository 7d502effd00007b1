"""Symbolic (in-circuit) extension towers, bound per ConstraintSystem.

Reuses the generic binomial tower (pcd_tpu/fields/tower.py) with the
per-CS FpVar class as base field — the same Karatsuba/Chung-Hasan formulas
generate both host arithmetic and circuit constraints.  Replaces
ark-r1cs-std's Fp2Var/Fp3Var/... zoo (SURVEY.md D8/D10).

The port's copy of `pcd_tpu/gadgets/fields_ext.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from ..fields.tower import make_ext_field
from .fp import fpvar_class


class CircuitTower:
    """Symbolic Fq^{k/2} / Fq^k for one MNTCurveConfig, over one cs.

    The outer circuit field must equal cfg.Fq (the cycle guarantees this:
    the SNARK being verified lives on the partner curve)."""

    def __init__(self, cs, cfg):
        assert cs.F.MODULUS == cfg.Fq.MODULUS, \
            "circuit field must be the verified SNARK's base field"
        self.cs = cs
        self.cfg = cfg
        self.V = fpvar_class(cs)
        k_half = cfg.Fq_half.DEGREE
        nr_host = cfg.Fq_half.NR  # element of host Fq
        self.ExtHalf = make_ext_field(self.V, k_half, nr_host.n,
                                      f"{cfg.name}.Fq{k_half}V@{id(cs)}")
        # top: quadratic with NR = v (the generator of ExtHalf)
        nr_top = tuple([0, 1] + [0] * (k_half - 2))
        self.ExtK = make_ext_field(self.ExtHalf, 2, nr_top,
                                   f"{cfg.name}.FqkV@{id(cs)}")

    # -- lifting host values into the circuit ---------------------------
    def lift_half_const(self, e):
        return self.ExtHalf([self.V.constant(c.n) for c in e.c])

    def lift_half_witness(self, e):
        return self.ExtHalf([self.V.new_witness(c.n) for c in e.c])

    def lift_k_const(self, e):
        return self.ExtK([self.lift_half_const(c) for c in e.c])

    def base_to_k(self, fpvar):
        """FpVar -> ExtK (degree-1 embedding)."""
        z = self.V.zero()
        half = self.ExtHalf([fpvar] + [z] * (self.ExtHalf.DEGREE - 1))
        zh = self.ExtHalf.zero()
        return self.ExtK([half, zh])

    def half_to_k(self, e):
        return self.ExtK([e, self.ExtHalf.zero()])

    # -- extracting host values (for tests / native interop) -------------
    def half_value(self, e):
        return self.cfg.Fq_half([self.cfg.Fq(c.val) for c in e.c])

    def k_value(self, e):
        return self.cfg.Fq_k([self.half_value(c) for c in e.c])


def circuit_tower(cs, cfg) -> CircuitTower:
    key = ("_tower_" + cfg.name)
    t = getattr(cs, key, None)
    if t is None:
        t = CircuitTower(cs, cfg)
        setattr(cs, key, t)
    return t
