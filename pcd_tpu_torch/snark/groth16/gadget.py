"""Groth16 verifier gadget (replaces ark-groth16::constraints::
Groth16VerifierGadget, reference tests/mnt4_groth16.rs:26-29; SNARKGadget
surface pinned at SURVEY.md D10).

Verifies a Groth16 proof over curve `cfg` inside an R1CS over cfg.Fq (the
partner field of the cycle).  The pairing-product equation is checked as

    e(A, B) * e(-acc, gamma) * e(-C, delta) * e(-alpha_g1, beta_g2) == 1

with one shared final exponentiation, returning a Boolean (NOT enforcing) —
the PCD MainCircuit ORs it with the base-case bit
(reference src/ec_cycle_pcd/data_structures.rs:296-308).

vk serialization for hashing (`vk_to_bytes`) is defined as the concatenation
of each vk element's coordinates (prime-subfield flattening, canonical field
bytes), gamma_abc last.  The native side reuses the gadget on a scratch
circuit exactly like the reference does (src/ec_cycle_pcd/mod.rs:101-127),
so native/gadget agreement is by construction.

The port's copy of `pcd_tpu/snark/groth16/gadget.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...gadgets.fields_ext import circuit_tower
from ...gadgets.fp import fpvar_class
from ...gadgets.inputs import BooleanInputVar, repack_native
from ...gadgets.pairing import PairingGadget
from ...gadgets.sw import AffinePointVar, SWProjVar


@dataclass
class Groth16VKVar:
    alpha_g1: AffinePointVar
    beta_g2: AffinePointVar
    gamma_g2: AffinePointVar
    delta_g2: AffinePointVar
    gamma_abc: list


@dataclass
class Groth16ProofVar:
    a: AffinePointVar
    b: AffinePointVar
    c: AffinePointVar


@dataclass
class Groth16PVKVar:
    vk: Groth16VKVar          # constants
    alpha_beta: object        # lifted constant in symbolic ExtK


class Groth16VerifierGadget:
    def __init__(self, cfg):
        """cfg: MNTCurveConfig of the *verified* SNARK's curve."""
        self.cfg = cfg

    # -- context -------------------------------------------------------
    def _ctx(self, cs):
        V = fpvar_class(cs)
        tower = circuit_tower(cs, self.cfg)
        key = "_g16pg_" + self.cfg.name
        pg = getattr(cs, key, None)
        if pg is None:
            pg = PairingGadget(cs, self.cfg)
            setattr(cs, key, pg)
        return V, tower, pg

    # -- allocation ------------------------------------------------------
    def _g1(self, V, pt, mode, check):
        alloc = V.constant if mode == "constant" else V.new_witness
        return AffinePointVar.alloc(self.cfg.g1, pt,
                                    lambda e: alloc(e.n), check=check)

    def _g2(self, cs, pt, mode, check):
        V, tower, _ = self._ctx(cs)
        lift = (tower.lift_half_const if mode == "constant"
                else tower.lift_half_witness)
        return AffinePointVar.alloc(self.cfg.g2, pt, lift, check=check)

    def alloc_vk(self, cs, vk, mode: str = "witness"):
        """`new_verification_key_unchecked` parity: no curve/subgroup checks
        (reference data_structures.rs:153-162)."""
        V, _, _ = self._ctx(cs)
        return Groth16VKVar(
            alpha_g1=self._g1(V, vk.alpha_g1, mode, False),
            beta_g2=self._g2(cs, vk.beta_g2, mode, False),
            gamma_g2=self._g2(cs, vk.gamma_g2, mode, False),
            delta_g2=self._g2(cs, vk.delta_g2, mode, False),
            gamma_abc=[self._g1(V, p, mode, False) for p in vk.gamma_abc],
        )

    def alloc_proof(self, cs, proof):
        """Proof points as witnesses with on-curve checks (no subgroup
        checks — completeness caveat shared with the reference)."""
        V, _, _ = self._ctx(cs)
        return Groth16ProofVar(
            a=self._g1(V, proof.a, "witness", True),
            b=self._g2(cs, proof.b, "witness", True),
            c=self._g1(V, proof.c, "witness", True),
        )

    def alloc_pvk(self, cs, pvk):
        _, tower, _ = self._ctx(cs)
        vk_var = self.alloc_vk(cs, pvk.vk, mode="constant")
        return Groth16PVKVar(vk=vk_var,
                             alpha_beta=tower.lift_k_const(pvk.alpha_beta))

    # -- input handling ---------------------------------------------------
    def input_var_from_field_elements(self, cf_fpvars):
        """Circuit CF values -> inner public-input bits."""
        return BooleanInputVar.from_field_elements(self.cfg.Fr, cf_fpvars)

    def input_var_new_input(self, cs, values):
        V, _, _ = self._ctx(cs)
        return BooleanInputVar.new_input(V, self.cfg.Fr, values)

    def repack_input(self, elems):
        """Native: this SNARK's Fr elements -> constraint-field (cfg.Fq)
        elements, matching `input_var_new_input`'s public-input layout
        (reference FromFieldElementsGadget::repack_input, used at
        ec_cycle_pcd/mod.rs:233-237)."""
        return repack_native(self.cfg.Fr, self.cfg.Fq, elems)

    # -- the MSM over public inputs --------------------------------------
    def _input_msm(self, cs, gamma_abc, input_var):
        V, _, _ = self._ctx(cs)
        assert len(input_var.bits) == len(gamma_abc) - 1, \
            f"input length {len(input_var.bits)} vs vk {len(gamma_abc) - 1}"
        acc = gamma_abc[0].to_proj()
        for bits, base in zip(input_var.bits, gamma_abc[1:]):
            term = SWProjVar.scalar_mul_bits(base.to_proj(), bits)
            acc = acc.add(term)
        x, y = acc.to_affine()
        return AffinePointVar(self.cfg.g1, x, y)

    # -- verification ------------------------------------------------------
    def verify(self, cs, vk_var: Groth16VKVar, input_var, proof_var):
        """Boolean: proof verifies under a (witness) vk."""
        _, _, pg = self._ctx(cs)
        acc = self._input_msm(cs, vk_var.gamma_abc, input_var)
        return pg.product_of_pairings_is_one([
            (proof_var.a, proof_var.b),
            (acc.negate(), vk_var.gamma_g2),
            (proof_var.c.negate(), vk_var.delta_g2),
            (vk_var.alpha_g1.negate(), vk_var.beta_g2),
        ])

    def verify_with_processed_vk(self, cs, pvk_var: Groth16PVKVar,
                                 input_var, proof_var):
        """Boolean: proof verifies under a constant pvk (3 Miller loops +
        comparison against the precomputed e(alpha, beta))."""
        from ...gadgets.sw import sym_eq_boolean

        V, _, pg = self._ctx(cs)
        vk = pvk_var.vk
        acc = self._input_msm(cs, vk.gamma_abc, input_var)
        f = pg.miller_loop(proof_var.a, proof_var.b)
        f = f * pg.miller_loop(acc.negate(), vk.gamma_g2)
        f = f * pg.miller_loop(proof_var.c.negate(), vk.delta_g2)
        out = pg.final_exponentiation(f)
        return sym_eq_boolean(V, out, pvk_var.alpha_beta)

    # -- witness-program external inputs -----------------------------------
    def flatten_vk(self, vk):
        """Flat ints in alloc_vk's witness allocation order (replay)."""
        from ...gadgets.sw import flatten_g1_point, flatten_g2_point

        out = flatten_g1_point(vk.alpha_g1)
        out += flatten_g2_point(vk.beta_g2)
        out += flatten_g2_point(vk.gamma_g2)
        out += flatten_g2_point(vk.delta_g2)
        for p in vk.gamma_abc:
            out += flatten_g1_point(p)
        return out

    def flatten_proof(self, proof):
        from ...gadgets.sw import flatten_g1_point, flatten_g2_point

        return (flatten_g1_point(proof.a) + flatten_g2_point(proof.b)
                + flatten_g1_point(proof.c))

    def flatten_input(self, values):
        """Instance chunk ints allocated by input_var_new_input."""
        from ...gadgets.inputs import repack_chunk_ints

        return repack_chunk_ints(self.cfg.Fr, self.cfg.Fq, values)

    # -- vk hashing --------------------------------------------------------
    def vk_to_bytes(self, vk_var: Groth16VKVar):
        """list[UInt8] — fixed layout: alpha_g1, beta_g2, gamma_g2,
        delta_g2, gamma_abc[..] (x then y, prime-coeff flattening)."""
        out = []
        for pt in [vk_var.alpha_g1, vk_var.beta_g2, vk_var.gamma_g2,
                   vk_var.delta_g2] + list(vk_var.gamma_abc):
            out.extend(pt.to_bytes())
        return out

    def vk_bytes_native(self, vk) -> bytes:
        """Native counterpart of vk_to_bytes (same layout), computed via a
        scratch circuit to guarantee agreement (the reference does exactly
        this — src/ec_cycle_pcd/mod.rs:101-127)."""
        from ...r1cs.system import ConstraintSystem

        scratch = ConstraintSystem(self.cfg.Fq)
        vk_var = self.alloc_vk(scratch, vk, mode="witness")
        return bytes(b.value for b in self.vk_to_bytes(vk_var))
