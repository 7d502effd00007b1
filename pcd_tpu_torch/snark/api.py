"""SNARK interface family (replaces ark-snark / ark-crypto-primitives::snark,
reference Cargo.toml:24,29; surface pinned by use-sites SURVEY.md D9/D10).

A `Circuit` is any object with `generate_constraints(cs)` — the reference's
ConstraintSynthesizer (it must synthesize identical *structure* regardless of
whether real or default values are loaded, like the reference circuits do).

A SNARK object (e.g. Groth16 bound to a curve config) provides:
  circuit_specific_setup(circuit, rng) -> (pk, vk)
  prove(pk, circuit, rng) -> proof
  verify(vk, public_input, proof) -> bool          (public_input: host Fr list)
  process_vk(vk) -> pvk
  verify_with_processed_vk(pvk, public_input, proof) -> bool

A SNARKVerifierGadget (the in-circuit counterpart over the *other* field of
the cycle) provides the SNARKGadget surface (SURVEY.md D10):
  vk_var / proof_var / input_var allocation, verify(), repack_input(), ...

The port's copy of `pcd_tpu/snark/api.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations


class SNARKError(Exception):
    pass


class NeedLargerBound(Exception):
    """Universal-setup index error (reference UniversalSetupIndexError::
    NeedLargerBound, used by the SRS sizing loop ec_cycle_pcd/mod.rs:345-470)."""

    def __init__(self, bound):
        self.bound = bound
        super().__init__(f"need larger bound: {bound}")


class Circuit:
    """Duck-typed; subclass or just provide generate_constraints(cs)."""

    def generate_constraints(self, cs):  # pragma: no cover
        raise NotImplementedError
