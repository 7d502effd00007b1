"""Bowe-Hopwood chunked-Pedersen variable-length CRH — the hash used by ALL
five reference test configs (reference src/variable_length_crh/bowe_hopwood/
{mod,constraints}.rs; Zcash spec 5.4.1.7 encoding).

Layout parity with the reference (consensus-critical):
  - input bits LSB-first per byte (pedersen::bytes_to_bits, mod.rs:113)
  - zero-pad to a multiple of CHUNK_SIZE=3 (mod.rs:114-117)
  - windows of WINDOW_SIZE=64 chunks; per-window random base; slot i holds
    16^i * base (4 doublings between slots, mod.rs:71-73)
  - chunk (c0,c1,c2) encodes (1 + c0 + 2*c1) * (1 - 2*c2) * slot_base
  - output = x-coordinate of the affine sum (mod.rs:151)

The port's copy of `pcd_tpu/crh/bowe_hopwood.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from ..gadgets.te import TEAffineVar
from ..utils.rng import ChaChaRng
from .api import CRHParams, bytes_to_bits

WINDOW_SIZE = 64
CHUNK_SIZE = 3


class BoweHopwoodCRH:
    def __init__(self, curve):
        self.curve = curve
        self._gen_cache = {}

    # -- setup ----------------------------------------------------------
    def setup(self, rng) -> CRHParams:
        if hasattr(rng, "fill_bytes"):
            seed = rng.fill_bytes(ChaChaRng.SEED_LEN)
        else:  # python Random
            seed = bytes(rng.randrange(256) for _ in range(ChaChaRng.SEED_LEN))
        return CRHParams(seed=seed)

    # -- generators (cached per seed) ------------------------------------
    def get_generators(self, pp: CRHParams, num_chunks: int):
        num_windows = (num_chunks + WINDOW_SIZE - 1) // WINDOW_SIZE
        cached = self._gen_cache.get(pp.seed)
        if cached is None or len(cached) < num_windows:
            rng = ChaChaRng(pp.seed)
            windows = []
            for _ in range(num_windows):
                base = rng.te_point(self.curve)
                slots = []
                for _ in range(WINDOW_SIZE):
                    slots.append(base)
                    for _ in range(4):
                        base = base.double()
                windows.append(slots)
            self._gen_cache[pp.seed] = windows
            cached = windows
        return cached[:num_windows]

    # -- native evaluation ----------------------------------------------
    def evaluate(self, pp: CRHParams, data: bytes):
        bits = bytes_to_bits(data)
        if len(bits) % CHUNK_SIZE:
            bits = bits + [False] * (CHUNK_SIZE - len(bits) % CHUNK_SIZE)
        num_chunks = len(bits) // CHUNK_SIZE
        gens = self.get_generators(pp, num_chunks)
        acc = self.curve.identity()
        for ci in range(num_chunks):
            c0, c1, c2 = bits[3 * ci], bits[3 * ci + 1], bits[3 * ci + 2]
            g = gens[ci // WINDOW_SIZE][ci % WINDOW_SIZE]
            scalar = 1 + (1 if c0 else 0) + (2 if c1 else 0)
            enc = g * scalar
            if c2:
                enc = -enc
            acc = acc + enc
        return acc.x  # affine x (host field element of curve.F)

    def convert_output_to_field_elements(self, out):
        return [out]

    def output_to_bytes(self, out) -> bytes:
        return out.to_bytes()

    def default_output(self):
        return self.curve.F.zero()

    # -- gadget -----------------------------------------------------------
    def check_evaluation_gadget(self, fpcls, pp: CRHParams, input_bytes):
        """input_bytes: list[UInt8]; returns FpVar (x-coordinate).
        Mirrors reference bowe_hopwood/constraints.rs:64-98."""
        from ..gadgets.fp import Boolean

        bits = []
        for byte in input_bytes:
            bits.extend(byte.to_bits_le())
        if len(bits) % CHUNK_SIZE:
            pad = CHUNK_SIZE - len(bits) % CHUNK_SIZE
            bits.extend(Boolean.constant(fpcls, False) for _ in range(pad))
        num_chunks = len(bits) // CHUNK_SIZE
        gens = self.get_generators(pp, num_chunks)
        chunks = [bits[3 * i : 3 * i + 3] for i in range(num_chunks)]
        windows = [chunks[i : i + WINDOW_SIZE]
                   for i in range(0, num_chunks, WINDOW_SIZE)]
        acc = TEAffineVar.precomputed_base_3_bit_signed_digit_scalar_mul(
            fpcls, gens, windows)
        return acc.x

    def convert_output_to_field_gadgets(self, out_var):
        return [out_var]

    def output_var_to_bytes(self, out_var):
        return out_var.to_bytes()

    def new_output_input(self, fpcls, out):
        return fpcls.new_instance(out)

    def flatten_output(self, out):
        """Witness-program external-input image of new_output_input."""
        return [out.n if hasattr(out, "n") else int(out)]

    def new_output_witness(self, fpcls, out):
        return fpcls.new_witness(out)

    def output_var_enforce_equal(self, a, b):
        a.enforce_equal(b)
