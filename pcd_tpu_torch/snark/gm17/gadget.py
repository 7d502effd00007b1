"""GM17 verifier gadget (replaces ark-gm17::constraints::GM17VerifierGadget,
reference tests/mnt4_gm17.rs:29-30).  Both verification equations are
evaluated in-circuit and ANDed into one Boolean:

  (1) e(A, B) * e(-psi, gamma_2) * e(-C, delta_2) * e(-alpha_1, alpha_2) == 1
  (2) e(A, gamma_2) * e(-gamma_1, B) == 1

Shares the pairing/SW/input machinery with the Groth16 gadget.

The port's copy of `pcd_tpu/snark/gm17/gadget.py`; the paths named here
are the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...gadgets.fields_ext import circuit_tower
from ...gadgets.fp import fpvar_class
from ...gadgets.inputs import BooleanInputVar, repack_native
from ...gadgets.pairing import PairingGadget
from ...gadgets.sw import AffinePointVar, SWProjVar, sym_eq_boolean


@dataclass
class GM17VKVar:
    alpha_g1: AffinePointVar
    alpha_g2: AffinePointVar
    gamma_g1: AffinePointVar
    gamma_g2: AffinePointVar
    delta_g2: AffinePointVar
    query: list


@dataclass
class GM17ProofVar:
    a: AffinePointVar
    b: AffinePointVar
    c: AffinePointVar


@dataclass
class GM17PVKVar:
    vk: GM17VKVar
    alpha_alpha: object


class GM17VerifierGadget:
    def __init__(self, cfg):
        self.cfg = cfg

    def _ctx(self, cs):
        V = fpvar_class(cs)
        tower = circuit_tower(cs, self.cfg)
        key = "_gm17pg_" + self.cfg.name
        pg = getattr(cs, key, None)
        if pg is None:
            pg = PairingGadget(cs, self.cfg)
            setattr(cs, key, pg)
        return V, tower, pg

    def _g1(self, V, pt, mode, check):
        alloc = V.constant if mode == "constant" else V.new_witness
        return AffinePointVar.alloc(self.cfg.g1, pt, lambda e: alloc(e.n),
                                    check=check)

    def _g2(self, cs, pt, mode, check):
        _, tower, _ = self._ctx(cs)
        lift = (tower.lift_half_const if mode == "constant"
                else tower.lift_half_witness)
        return AffinePointVar.alloc(self.cfg.g2, pt, lift, check=check)

    def alloc_vk(self, cs, vk, mode: str = "witness"):
        V, _, _ = self._ctx(cs)
        return GM17VKVar(
            alpha_g1=self._g1(V, vk.alpha_g1, mode, False),
            alpha_g2=self._g2(cs, vk.alpha_g2, mode, False),
            gamma_g1=self._g1(V, vk.gamma_g1, mode, False),
            gamma_g2=self._g2(cs, vk.gamma_g2, mode, False),
            delta_g2=self._g2(cs, vk.delta_g2, mode, False),
            query=[self._g1(V, p, mode, False) for p in vk.query],
        )

    def alloc_proof(self, cs, proof):
        V, _, _ = self._ctx(cs)
        return GM17ProofVar(
            a=self._g1(V, proof.a, "witness", True),
            b=self._g2(cs, proof.b, "witness", True),
            c=self._g1(V, proof.c, "witness", True),
        )

    def alloc_pvk(self, cs, pvk):
        _, tower, _ = self._ctx(cs)
        return GM17PVKVar(vk=self.alloc_vk(cs, pvk.vk, mode="constant"),
                          alpha_alpha=tower.lift_k_const(pvk.alpha_alpha))

    # -- inputs -----------------------------------------------------------
    def input_var_from_field_elements(self, cf_fpvars):
        return BooleanInputVar.from_field_elements(self.cfg.Fr, cf_fpvars)

    def input_var_new_input(self, cs, values):
        V, _, _ = self._ctx(cs)
        return BooleanInputVar.new_input(V, self.cfg.Fr, values)

    def repack_input(self, elems):
        return repack_native(self.cfg.Fr, self.cfg.Fq, elems)

    def _input_msm(self, cs, query, input_var):
        assert len(input_var.bits) == len(query) - 1
        acc = query[0].to_proj()
        for bits, base in zip(input_var.bits, query[1:]):
            acc = acc.add(SWProjVar.scalar_mul_bits(base.to_proj(), bits))
        x, y = acc.to_affine()
        return AffinePointVar(self.cfg.g1, x, y)

    # -- verification ------------------------------------------------------
    def verify(self, cs, vk_var: GM17VKVar, input_var, proof_var):
        _, _, pg = self._ctx(cs)
        psi = self._input_msm(cs, vk_var.query, input_var)
        eq1 = pg.product_of_pairings_is_one([
            (proof_var.a, proof_var.b),
            (psi.negate(), vk_var.gamma_g2),
            (proof_var.c.negate(), vk_var.delta_g2),
            (vk_var.alpha_g1.negate(), vk_var.alpha_g2),
        ])
        eq2 = pg.product_of_pairings_is_one([
            (proof_var.a, vk_var.gamma_g2),
            (vk_var.gamma_g1.negate(), proof_var.b),
        ])
        return eq1 & eq2

    def verify_with_processed_vk(self, cs, pvk_var: GM17PVKVar, input_var,
                                 proof_var):
        V, _, pg = self._ctx(cs)
        vk = pvk_var.vk
        psi = self._input_msm(cs, vk.query, input_var)
        f = pg.miller_loop(proof_var.a, proof_var.b)
        f = f * pg.miller_loop(psi.negate(), vk.gamma_g2)
        f = f * pg.miller_loop(proof_var.c.negate(), vk.delta_g2)
        eq1 = sym_eq_boolean(V, pg.final_exponentiation(f), pvk_var.alpha_alpha)
        eq2 = pg.product_of_pairings_is_one([
            (proof_var.a, vk.gamma_g2),
            (vk.gamma_g1.negate(), proof_var.b),
        ])
        return eq1 & eq2

    # -- witness-program external inputs -----------------------------------
    def flatten_vk(self, vk):
        """Flat ints in alloc_vk's witness allocation order (replay)."""
        from ...gadgets.sw import flatten_g1_point, flatten_g2_point

        out = flatten_g1_point(vk.alpha_g1)
        out += flatten_g2_point(vk.alpha_g2)
        out += flatten_g1_point(vk.gamma_g1)
        out += flatten_g2_point(vk.gamma_g2)
        out += flatten_g2_point(vk.delta_g2)
        for p in vk.query:
            out += flatten_g1_point(p)
        return out

    def flatten_proof(self, proof):
        from ...gadgets.sw import flatten_g1_point, flatten_g2_point

        return (flatten_g1_point(proof.a) + flatten_g2_point(proof.b)
                + flatten_g1_point(proof.c))

    def flatten_input(self, values):
        from ...gadgets.inputs import repack_chunk_ints

        return repack_chunk_ints(self.cfg.Fr, self.cfg.Fq, values)

    # -- vk hashing --------------------------------------------------------
    def vk_to_bytes(self, vk_var: GM17VKVar):
        out = []
        for pt in [vk_var.alpha_g1, vk_var.alpha_g2, vk_var.gamma_g1,
                   vk_var.gamma_g2, vk_var.delta_g2] + list(vk_var.query):
            out.extend(pt.to_bytes())
        return out

    def vk_bytes_native(self, vk) -> bytes:
        from ...r1cs.system import ConstraintSystem

        scratch = ConstraintSystem(self.cfg.Fq)
        vk_var = self.alloc_vk(scratch, vk, mode="witness")
        return bytes(b.value for b in self.vk_to_bytes(vk_var))
