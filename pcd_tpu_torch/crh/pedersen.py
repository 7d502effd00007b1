"""Plain bit-per-generator Pedersen variable-length CRH + x-only compressor
(reference src/variable_length_crh/pedersen/{mod,constraints}.rs and
injective_map/{mod,constraints}.rs).

Layout parity: 4-byte LE length prefix || input (pedersen/mod.rs:64-69),
bits LSB-first, one generator per bit, output = affine TE point (x,y);
the compressor keeps only x (injective_map/mod.rs:35-38).

The port's copy of `pcd_tpu/crh/pedersen.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

import struct

from ..gadgets.te import TEAffineVar
from ..utils.rng import ChaChaRng
from .api import CRHParams, bytes_to_bits


class PedersenCRH:
    def __init__(self, curve):
        self.curve = curve
        self._gen_cache = {}

    def setup(self, rng) -> CRHParams:
        if hasattr(rng, "fill_bytes"):
            seed = rng.fill_bytes(ChaChaRng.SEED_LEN)
        else:
            seed = bytes(rng.randrange(256) for _ in range(ChaChaRng.SEED_LEN))
        return CRHParams(seed=seed)

    def get_generators(self, pp: CRHParams, n: int):
        cached = self._gen_cache.get(pp.seed)
        if cached is None or len(cached) < n:
            rng = ChaChaRng(pp.seed)
            gens = [rng.te_point(self.curve) for _ in range(n)]
            self._gen_cache[pp.seed] = gens
            cached = gens
        return cached[:n]

    @staticmethod
    def _prefixed(data: bytes) -> bytes:
        assert len(data) < (1 << 32)
        return struct.pack("<I", len(data)) + data

    def evaluate(self, pp: CRHParams, data: bytes):
        bits = bytes_to_bits(self._prefixed(data))
        gens = self.get_generators(pp, len(bits))
        acc = self.curve.identity()
        for b, g in zip(bits, gens):
            if b:
                acc = acc + g
        return acc  # affine TE point

    def convert_output_to_field_elements(self, out):
        return [out.x, out.y]

    def output_to_bytes(self, out) -> bytes:
        return out.x.to_bytes() + out.y.to_bytes()

    def default_output(self):
        return self.curve.identity()

    # -- gadget -----------------------------------------------------------
    def check_evaluation_gadget(self, fpcls, pp: CRHParams, input_bytes):
        from ..gadgets.fp import UInt8

        prefix = UInt8.constant_vec(fpcls, struct.pack("<I", len(input_bytes)))
        padded = prefix + list(input_bytes)
        bits = []
        for byte in padded:
            bits.extend(byte.to_bits_le())
        gens = self.get_generators(pp, len(bits))
        return TEAffineVar.precomputed_base_scalar_mul_le(fpcls, bits, gens)

    def convert_output_to_field_gadgets(self, out_var):
        return [out_var.x, out_var.y]

    def output_var_to_bytes(self, out_var):
        return out_var.x.to_bytes() + out_var.y.to_bytes()

    def new_output_input(self, fpcls, out):
        x = fpcls.new_instance(out.x)
        y = fpcls.new_instance(out.y)
        return TEAffineVar(self.curve, x, y)

    def flatten_output(self, out):
        """Witness-program external-input image of new_output_input."""
        return [out.x.n, out.y.n]

    def new_output_witness(self, fpcls, out):
        return TEAffineVar(self.curve,
                           fpcls.new_witness(out.x), fpcls.new_witness(out.y))

    def output_var_enforce_equal(self, a, b):
        a.enforce_equal(b)


class PedersenCRHCompressor(PedersenCRH):
    """Pedersen, keeping only the x-coordinate (reference injective_map/)."""

    def evaluate(self, pp: CRHParams, data: bytes):
        return super().evaluate(pp, data).x

    def convert_output_to_field_elements(self, out):
        return [out]

    def output_to_bytes(self, out) -> bytes:
        return out.to_bytes()

    def default_output(self):
        return self.curve.F.zero()

    def check_evaluation_gadget(self, fpcls, pp, input_bytes):
        return super().check_evaluation_gadget(fpcls, pp, input_bytes).x

    def convert_output_to_field_gadgets(self, out_var):
        return [out_var]

    def output_var_to_bytes(self, out_var):
        return out_var.to_bytes()

    def new_output_input(self, fpcls, out):
        return fpcls.new_instance(out)

    def new_output_witness(self, fpcls, out):
        return fpcls.new_witness(out)

    def flatten_output(self, out):
        return [out.n if hasattr(out, "n") else int(out)]

    def output_var_enforce_equal(self, a, b):
        a.enforce_equal(b)
