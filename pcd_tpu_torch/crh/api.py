"""Variable-length CRH abstraction (reference src/variable_length_crh/mod.rs:8-15
and constraints.rs:10-30).

Unlike the reference's trait-generic form, implementations here are *objects*
configured with a concrete TE curve (TPU-first stance: configs are data, not
types).  Each CRH object provides both the native methods and the in-circuit
gadget methods (the reference splits these into two traits).

The port's copy of `pcd_tpu/crh/api.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CRHParams:
    """Parameters = the ChaCha seed (reference pedersen/mod.rs:16-18)."""

    seed: bytes

    def __hash__(self):
        return hash(self.seed)


def bytes_to_bits(data: bytes):
    """LSB-first bit expansion (reference pedersen/mod.rs:95-104 —
    consensus-critical bit order for all CRH preimages)."""
    bits = []
    for byte in data:
        for i in range(8):
            bits.append((byte >> i) & 1 == 1)
    return bits


class VariableLengthCRH:
    """Interface (documentation; implementations duck-type):

    native:
      setup(rng) -> CRHParams
      evaluate(pp, data: bytes) -> Output
      convert_output_to_field_elements(out) -> list[host field elems]
      output_to_bytes(out) -> bytes
      default_output() -> Output
    gadget:
      check_evaluation_gadget(fpcls, pp, input: list[UInt8]) -> OutputVar
      convert_output_to_field_gadgets(out_var) -> list[FpVar]
      output_var_to_bytes(out_var) -> list[UInt8]
      new_output_input(fpcls, out) -> OutputVar    (allocate as public input)
      output_var_enforce_equal(a, b)
    """
