"""Bowe-Hopwood chunked-Pedersen CRH, native evaluation only: a frozen copy
of the port's `pcd_tpu_torch/crh/bowe_hopwood.py` and `crh/api.py` without
their gadgets, for the benchmark's plain reference.

Input bits LSB-first per byte, zero-padded to chunks of 3; windows of 64
chunks, each with a base drawn from ChaCha seeded by the parameters' 32
bytes, slot i holding 16^i times it; chunk (c0, c1, c2) adds
(1 + c0 + 2 c1)(1 - 2 c2) slot; the output is the sum's affine x.
"""

from __future__ import annotations

from .rng import ChaChaRng

WINDOW_SIZE = 64
CHUNK_SIZE = 3


def bytes_to_bits(data: bytes) -> list:
    return [(byte >> i) & 1 == 1 for byte in data for i in range(8)]


class BoweHopwoodCRH:
    def __init__(self, curve):
        self.curve = curve
        self._gens = {}

    @staticmethod
    def setup_seed(rng) -> bytes:
        """The parameters a setup draws: 32 bytes of its ChaCha stream."""
        return rng.fill_bytes(ChaChaRng.SEED_LEN)

    def generators(self, seed: bytes, num_chunks: int):
        num_windows = (num_chunks + WINDOW_SIZE - 1) // WINDOW_SIZE
        cached = self._gens.get(seed)
        if cached is None or len(cached) < num_windows:
            rng = ChaChaRng(seed)
            cached = []
            for _ in range(num_windows):
                base = rng.te_point(self.curve)
                slots = []
                for _ in range(WINDOW_SIZE):
                    slots.append(base)
                    for _ in range(4):
                        base = base.double()
                cached.append(slots)
            self._gens[seed] = cached
        return cached[:num_windows]

    def evaluate(self, seed: bytes, data: bytes):
        bits = bytes_to_bits(data)
        if len(bits) % CHUNK_SIZE:
            bits += [False] * (CHUNK_SIZE - len(bits) % CHUNK_SIZE)
        num_chunks = len(bits) // CHUNK_SIZE
        gens = self.generators(seed, num_chunks)
        acc = self.curve.identity()
        for ci in range(num_chunks):
            c0, c1, c2 = bits[3 * ci: 3 * ci + 3]
            enc = gens[ci // WINDOW_SIZE][ci % WINDOW_SIZE] * (
                1 + int(c0) + 2 * int(c1))
            acc = acc + (-enc if c2 else enc)
        return acc.x
