"""Curve model registry: assembles fields, towers, G1/G2 curves, TE curves
and pairing configurations for MNT4-298/MNT6-298 and the toy test cycle.

This is the framework's equivalent of the reference's pinned curve crates
(`ark-mnt4-298`, `ark-mnt6-298`, `ark-ed-on-mnt4-298` — Cargo.toml:31-34),
re-expressed as explicit config objects rather than Rust trait impls.

An `MNTCurveConfig` packages everything one pairing-friendly curve needs:
fields Fq/Fr, the tower Fq -> Fq^{k/2} -> Fq^k, G1/G2 groups (G2 on the
quadratic twist over Fq^{k/2} by the tower generator u), and ate-pairing
parameters.  `CycleConfig` pairs two of them (main/help) such that
main.Fr == help.Fq and vice versa (the EC-cycle PCD requirement,
reference src/ec_cycle_pcd/mod.rs:24-33).

A frozen copy of the port's `pcd_tpu_torch/curves/models.py` for the
benchmark's plain reference; it imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

from . import constants as C
from .prime import make_prime_field
from .tower import make_ext_field
from .short_weierstrass import SWCurve
from .twisted_edwards import TECurve


@dataclass(frozen=True)
class MNTCurveConfig:
    """One MNT-style pairing-friendly curve (embedding degree 4 or 6)."""

    name: str
    embedding_degree: int      # 4 or 6
    Fq: type                   # base prime field
    Fr: type                   # scalar prime field
    Fq_half: type              # Fq^{k/2} (G2 coordinate field)
    Fq_k: type                 # Fq^k (pairing target field)
    g1: SWCurve
    g2: SWCurve
    g1_gen: object
    g2_gen: object
    ate_loop: int              # |trace - 1|
    ate_is_neg: bool
    trace: int

    @property
    def twist(self):
        """gamma = u: the element of Fq^{k/2} the twist is by (G2 untwists
        into E(Fq^k) via (x/gamma, y/(omega*gamma)), omega^2 = gamma)."""
        return self.Fq_half.gen_v()


@dataclass(frozen=True)
class CycleConfig:
    """A 2-cycle of pairing-friendly curves (main/help)."""

    name: str
    main: MNTCurveConfig       # main SNARK curve; its Fr = MainField
    help: MNTCurveConfig       # help SNARK curve; its Fr = HelpField
    crh_te: TECurve            # TE curve over MainField for the CRH

    def __post_init__(self):
        assert self.main.Fr.MODULUS == self.help.Fq.MODULUS
        assert self.main.Fq.MODULUS == self.help.Fr.MODULUS
        assert self.crh_te.F.MODULUS == self.main.Fr.MODULUS


def _build_mnt4(name, q, r, a, b, nr2, g1, tw_a, tw_b, g2x, g2y, g2_cof,
                ate_loop, ate_neg, trace):
    Fq = make_prime_field(q, f"{name}.Fq")
    Fr = make_prime_field(r, f"{name}.Fr")
    Fq2 = make_ext_field(Fq, 2, nr2, f"{name}.Fq2")
    Fq4 = make_ext_field(Fq2, 2, (0, 1), f"{name}.Fq4")  # v^2 = u
    g1_curve = SWCurve(Fq, Fq.from_int(a), Fq.from_int(b), order=r, cofactor=1,
                       name=f"{name}.G1")
    A2 = Fq2([Fq.from_int(tw_a[0]), Fq.from_int(tw_a[1])])
    B2 = Fq2([Fq.from_int(tw_b[0]), Fq.from_int(tw_b[1])])
    g2_curve = SWCurve(Fq2, A2, B2, order=r, cofactor=g2_cof, name=f"{name}.G2")
    g1_gen = g1_curve.point_ints(*g1)
    g2_gen = g2_curve.point(
        Fq2([Fq.from_int(g2x[0]), Fq.from_int(g2x[1])]),
        Fq2([Fq.from_int(g2y[0]), Fq.from_int(g2y[1])]),
    )
    return MNTCurveConfig(name, 4, Fq, Fr, Fq2, Fq4, g1_curve, g2_curve,
                          g1_gen, g2_gen, ate_loop, ate_neg, trace)


def _build_mnt6(name, q, r, a, b, nr3, g1, tw_a, tw_b, g2x, g2y, g2_cof,
                ate_loop, ate_neg, trace):
    Fq = make_prime_field(q, f"{name}.Fq")
    Fr = make_prime_field(r, f"{name}.Fr")
    Fq3 = make_ext_field(Fq, 3, nr3, f"{name}.Fq3")
    Fq6 = make_ext_field(Fq3, 2, (0, 1, 0), f"{name}.Fq6")  # v^2 = u
    g1_curve = SWCurve(Fq, Fq.from_int(a), Fq.from_int(b), order=r, cofactor=1,
                       name=f"{name}.G1")
    A3 = Fq3([Fq.from_int(x) for x in tw_a])
    B3 = Fq3([Fq.from_int(x) for x in tw_b])
    g2_curve = SWCurve(Fq3, A3, B3, order=r, cofactor=g2_cof, name=f"{name}.G2")
    g1_gen = g1_curve.point_ints(*g1)
    g2_gen = g2_curve.point(
        Fq3([Fq.from_int(x) for x in g2x]),
        Fq3([Fq.from_int(x) for x in g2y]),
    )
    return MNTCurveConfig(name, 6, Fq, Fr, Fq3, Fq6, g1_curve, g2_curve,
                          g1_gen, g2_gen, ate_loop, ate_neg, trace)


@lru_cache(maxsize=None)
def mnt4_298() -> MNTCurveConfig:
    return _build_mnt4(
        "mnt4_298", C.MNT4_Q, C.MNT4_R, C.MNT4_A, C.MNT4_B, C.MNT4_NR2,
        C.MNT4_G1, C.MNT4_TWIST_A, C.MNT4_TWIST_B, C.MNT4_G2_GX, C.MNT4_G2_GY,
        C.MNT4_G2_COFACTOR, C.MNT4_ATE_LOOP, C.MNT4_ATE_IS_NEG, C.MNT4_TRACE)


@lru_cache(maxsize=None)
def mnt6_298() -> MNTCurveConfig:
    return _build_mnt6(
        "mnt6_298", C.MNT6_Q, C.MNT6_R, C.MNT6_A, C.MNT6_B, C.MNT6_NR3,
        C.MNT6_G1, C.MNT6_TWIST_A, C.MNT6_TWIST_B, C.MNT6_G2_GX, C.MNT6_G2_GY,
        C.MNT6_G2_COFACTOR, C.MNT6_ATE_LOOP, C.MNT6_ATE_IS_NEG, C.MNT6_TRACE)


@lru_cache(maxsize=None)
def toy_mnt4() -> MNTCurveConfig:
    return _build_mnt4(
        "toy4", C.TOY_MNT4_Q, C.TOY_MNT4_R, C.TOY_MNT4_A, C.TOY_MNT4_B,
        C.TOY_MNT4_NR2, C.TOY_MNT4_G1, C.TOY_MNT4_TWIST_A, C.TOY_MNT4_TWIST_B,
        C.TOY_MNT4_G2_GX, C.TOY_MNT4_G2_GY, C.TOY_MNT4_G2_COFACTOR,
        C.TOY_MNT4_ATE_LOOP, C.TOY_MNT4_ATE_IS_NEG, C.TOY_MNT4_TRACE)


@lru_cache(maxsize=None)
def toy_mnt6() -> MNTCurveConfig:
    return _build_mnt6(
        "toy6", C.TOY_MNT6_Q, C.TOY_MNT6_R, C.TOY_MNT6_A, C.TOY_MNT6_B,
        C.TOY_MNT6_NR3, C.TOY_MNT6_G1, C.TOY_MNT6_TWIST_A, C.TOY_MNT6_TWIST_B,
        C.TOY_MNT6_G2_GX, C.TOY_MNT6_G2_GY, C.TOY_MNT6_G2_COFACTOR,
        C.TOY_MNT6_ATE_LOOP, C.TOY_MNT6_ATE_IS_NEG, C.TOY_MNT6_TRACE)


@lru_cache(maxsize=None)
def ed_on_mnt4_298() -> TECurve:
    """Complete TE curve over MNT4.Fr for the CRH (role of ark-ed-on-mnt4-298)."""
    F = mnt4_298().Fr
    return TECurve(F, F.from_int(C.ED_MNT4_A), F.from_int(C.ED_MNT4_D),
                   order=C.ED_MNT4_ORDER, cofactor=C.ED_MNT4_COFACTOR,
                   name="ed_on_mnt4_298")


@lru_cache(maxsize=None)
def toy_te() -> TECurve:
    F = toy_mnt4().Fr
    return TECurve(F, F.from_int(C.TOY_TE_A), F.from_int(C.TOY_TE_D),
                   order=C.TOY_TE_ORDER, cofactor=C.TOY_TE_COFACTOR,
                   name="toy_te")


@lru_cache(maxsize=None)
def jubjub() -> TECurve:
    """ed-on-bls12-381; the reference uses it only for CRH unit tests."""
    F = make_prime_field(C.BLS12_381_R, "bls12_381.Fr")
    d = F.from_int(C.JUBJUB_D_NUM) / F.from_int(C.JUBJUB_D_DEN)
    return TECurve(F, F.from_int(C.JUBJUB_A), d, order=C.JUBJUB_ORDER,
                   cofactor=C.JUBJUB_COFACTOR, name="jubjub")


@lru_cache(maxsize=None)
def mnt_cycle() -> CycleConfig:
    """The production cycle: main = MNT4-298, help = MNT6-298 (the reference's
    ECCyclePCDConfig<Fr, Fq> with Fr/Fq of MNT4 — tests/mnt4_groth16.rs:23)."""
    return CycleConfig("mnt4_mnt6_298", mnt4_298(), mnt6_298(), ed_on_mnt4_298())


@lru_cache(maxsize=None)
def toy_cycle() -> CycleConfig:
    return CycleConfig("toy_cycle", toy_mnt4(), toy_mnt6(), toy_te())
