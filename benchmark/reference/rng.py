"""Deterministic RNG stack.

The reference derives ALL CRH generators from a `rand_chacha::ChaChaRng`
seeded with 32 bytes (src/variable_length_crh/pedersen/mod.rs:20-35,
bowe_hopwood/mod.rs:52-78) and uses `ark_std::test_rng()` (fixed seed) for
deterministic tests *and inside circuit synthesis* for placeholder proofs
(src/ec_cycle_pcd/data_structures.rs:138,342).

This module provides a clean-room ChaCha20 keystream RNG (RFC 7539 block
function, 20 rounds) with a documented field/point sampling spec.  Note:
`rand_chacha 0.2`'s exact stream/sampling cannot be byte-verified here (dep
sources not vendored — SURVEY.md D16), so the framework fixes its own
deterministic spec; everything downstream (generators, placeholder proofs)
is internally consistent, which is what the construction requires.

A frozen copy of the port's `pcd_tpu_torch/utils/rng.py` for the
benchmark's plain reference; it imports nothing of the program.
"""

from __future__ import annotations

import struct

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _quarter(st, a, b, c, d):
    st[a] = (st[a] + st[b]) & 0xFFFFFFFF
    st[d] = _rotl(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & 0xFFFFFFFF
    st[b] = _rotl(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b]) & 0xFFFFFFFF
    st[d] = _rotl(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & 0xFFFFFFFF
    st[b] = _rotl(st[b] ^ st[c], 7)


def chacha20_block(key32: bytes, counter: int, nonce12: bytes) -> bytes:
    state = list(_CONSTANTS)
    state += list(struct.unpack("<8I", key32))
    state.append(counter & 0xFFFFFFFF)
    state += list(struct.unpack("<3I", nonce12))
    work = list(state)
    for _ in range(10):
        _quarter(work, 0, 4, 8, 12)
        _quarter(work, 1, 5, 9, 13)
        _quarter(work, 2, 6, 10, 14)
        _quarter(work, 3, 7, 11, 15)
        _quarter(work, 0, 5, 10, 15)
        _quarter(work, 1, 6, 11, 12)
        _quarter(work, 2, 7, 8, 13)
        _quarter(work, 3, 4, 9, 14)
    out = [(w + s) & 0xFFFFFFFF for w, s in zip(work, state)]
    return struct.pack("<16I", *out)


def chacha20_blocks_np(key32: bytes, counter0: int, nblocks: int,
                       nonce12: bytes = b"\x00" * 12) -> bytes:
    """`nblocks` consecutive blocks (counters counter0..+nblocks-1) in
    one vectorized numpy pass — byte-identical to chacha20_block chained
    (asserted in tests/test_crh.py::test_chacha_bulk_matches_scalar).
    Bulk draws (the Marlin zk masks sample |H| field elements per prove)
    were ~60 us/block through the scalar path."""
    import numpy as np

    M = np.uint32(0xFFFFFFFF)

    def rotl(x, n):
        return ((x << np.uint32(n)) | (x >> np.uint32(32 - n))) & M

    st = np.empty((16, nblocks), dtype=np.uint32)
    st[0:4] = np.asarray(_CONSTANTS, dtype=np.uint32)[:, None]
    st[4:12] = np.frombuffer(key32, dtype="<u4")[:, None]
    st[12] = (np.uint64(counter0) + np.arange(nblocks, dtype=np.uint64)) \
        .astype(np.uint32)
    st[13:16] = np.frombuffer(nonce12, dtype="<u4")[:, None]
    w = st.copy()

    def q(a, b, c, d):
        w[a] += w[b]
        w[d] = rotl(w[d] ^ w[a], 16)
        w[c] += w[d]
        w[b] = rotl(w[b] ^ w[c], 12)
        w[a] += w[b]
        w[d] = rotl(w[d] ^ w[a], 8)
        w[c] += w[d]
        w[b] = rotl(w[b] ^ w[c], 7)

    for _ in range(10):
        q(0, 4, 8, 12)
        q(1, 5, 9, 13)
        q(2, 6, 10, 14)
        q(3, 7, 11, 15)
        q(0, 5, 10, 15)
        q(1, 6, 11, 12)
        q(2, 7, 8, 13)
        q(3, 4, 9, 14)
    out = (w + st).astype("<u4")
    return np.ascontiguousarray(out.T).tobytes()


class ChaChaRng:
    """Deterministic byte stream from a 32-byte seed."""

    SEED_LEN = 32

    def __init__(self, seed: bytes):
        if len(seed) < 32:
            seed = seed + b"\x00" * (32 - len(seed))
        self.key = bytes(seed[:32])
        self.counter = 0
        self.buf = b""

    @classmethod
    def from_int_seed(cls, n: int):
        return cls(n.to_bytes(32, "little"))

    def fill_bytes(self, n: int) -> bytes:
        deficit = n - len(self.buf)
        if deficit > 256:
            # bulk path: one vectorized pass over all needed blocks
            # (identical stream to the scalar path — same counters)
            k = (deficit + 63) // 64
            self.buf += chacha20_blocks_np(self.key, self.counter, k)
            self.counter += k
        while len(self.buf) < n:
            self.buf += chacha20_block(self.key, self.counter, b"\x00" * 12)
            self.counter += 1
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def randrange_many(self, bound: int, count: int) -> list:
        """`count` uniform draws in [0, bound) — the same rejection
        sampling as randrange, drawn through the vectorized block path
        (stream-identical: each draw consumes the same bytes)."""
        nbytes = (bound.bit_length() + 7) // 8
        shift = 8 * nbytes - bound.bit_length()
        out = []
        while len(out) < count:
            todo = count - len(out)
            raw = self.fill_bytes(nbytes * (todo + 2 + todo // 16))
            for i in range(0, len(raw), nbytes):
                chunk = raw[i : i + nbytes]
                if len(chunk) < nbytes:
                    self.buf = chunk + self.buf
                    break
                v = int.from_bytes(chunk, "little") >> shift
                if v < bound:
                    out.append(v)
                    if len(out) == count:
                        self.buf = raw[i + nbytes:] + self.buf
                        break
        return out

    def next_u64(self) -> int:
        return int.from_bytes(self.fill_bytes(8), "little")

    def randrange(self, a: int, b: int | None = None) -> int:
        """Uniform in [0, a) — or [a, b) when b given — by rejection
        sampling on the next power-of-two."""
        if b is not None:
            return a + self.randrange(b - a)
        bound = a
        nbytes = (bound.bit_length() + 7) // 8
        mask = (1 << (8 * nbytes)) - 1
        shift = 8 * nbytes - bound.bit_length()
        while True:
            v = int.from_bytes(self.fill_bytes(nbytes), "little") >> shift
            if v < bound:
                return v

    def field_element(self, F):
        """Uniform field element (rejection sampling on BITS bits)."""
        return F.from_int(self.randrange(F.MODULUS))

    def te_point(self, curve):
        """Deterministic point in the prime-order subgroup of a TE curve:
        sample y until (y, sign) lifts; clear cofactor; skip identity."""
        while True:
            y = self.field_element(curve.F)
            sign = self.fill_bytes(1)[0] & 1
            p = curve.lift_y(y, sign_x=sign if sign else 2)
            if p is None:
                continue
            q = p * curve.cofactor
            if not q.is_identity():
                return q


def test_rng() -> ChaChaRng:
    """Fixed-seed RNG (role of ark_std::test_rng; also used for placeholder
    proof determinism inside circuit synthesis)."""
    return ChaChaRng(b"pcd_tpu deterministic test rng!!")
