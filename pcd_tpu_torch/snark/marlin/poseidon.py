"""Poseidon permutation + sponge, native and in-circuit (role of
ark-marlin's fiat_shamir::poseidon::{PoseidonSponge, PoseidonSpongeVar},
reference tests/mnt4_marlin.rs:8-11).

Parameterization: t = 3 (rate 2, capacity 1), 8 full rounds, 31 partial
rounds, S-box x^17 (17 is coprime to p-1 for both MNT-298 scalar fields,
which is why the reference's sponge also uses a high odd alpha there).
Round constants and the MDS matrix (Cauchy construction) are derived from a
fixed ChaCha20 stream — deterministic and shared by native and gadget code;
the exact constants of the unpinned reference dependency are not
recoverable, so the framework fixes its own (SURVEY.md D13 note).

The same implementation runs over host field elements *or* FpVars (the
field protocol again), so the in-circuit sponge is literally the native
code path — challenge consistency between prover and verifier gadget is by
construction.

The port's copy of `pcd_tpu/snark/marlin/poseidon.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from functools import lru_cache

from ...utils.rng import ChaChaRng

R_FULL = 8
R_PARTIAL = 31
T = 3           # state width
RATE = 2
ALPHA = 17


@lru_cache(maxsize=None)
def poseidon_params(modulus: int):
    """(round_constants [(R_FULL+R_PARTIAL) x T], mds [T x T]) as ints."""
    assert (modulus - 1) % ALPHA != 0, "alpha must be coprime to p-1"
    rng = ChaChaRng(b"pcd-tpu poseidon parameters v1" + b"\x00\x00")
    n_rounds = R_FULL + R_PARTIAL
    ark = [[rng.randrange(modulus) for _ in range(T)] for _ in range(n_rounds)]
    # Cauchy MDS: m[i][j] = 1/(x_i + y_j) with distinct x_i, y_j
    while True:
        xs = [rng.randrange(modulus) for _ in range(T)]
        ys = [rng.randrange(modulus) for _ in range(T)]
        if len({(x + y) % modulus for x in xs for y in ys}) == T * T and \
                all((x + y) % modulus for x in xs for y in ys):
            break
    mds = [[pow((xs[i] + ys[j]) % modulus, -1, modulus) for j in range(T)]
           for i in range(T)]
    return ark, mds


class PoseidonSponge:
    """Sponge over a field-element class FE (host field or FpVar class).

    FE must provide: constant construction via from_int, +, *, ** (int
    exponent), zero().  (FpVar satisfies this; x**17 costs 5 constraints.)
    """

    def __init__(self, FE):
        self.FE = FE
        p = FE.MODULUS
        self.p = p
        ark, mds = poseidon_params(p)
        self.ark = ark
        self.mds = mds
        self.state = [FE.zero() for _ in range(T)]
        self.absorb_queue = []
        self.squeeze_pos = RATE  # force permute on first squeeze

    # -- permutation -----------------------------------------------------
    def _sbox(self, x):
        return x ** ALPHA

    def permute(self):
        st = self.state
        for r in range(R_FULL + R_PARTIAL):
            c = self.ark[r]
            st = [st[i] + self.FE.from_int(c[i]) for i in range(T)]
            half = R_FULL // 2
            if r < half or r >= half + R_PARTIAL:
                st = [self._sbox(x) for x in st]
            else:
                st = [self._sbox(st[0])] + st[1:]
            new = []
            for i in range(T):
                acc = st[0].scale(self.mds[i][0]) if hasattr(st[0], "scale") \
                    else st[0] * self.FE.from_int(self.mds[i][0])
                for j in range(1, T):
                    term = st[j].scale(self.mds[i][j]) if hasattr(st[j], "scale") \
                        else st[j] * self.FE.from_int(self.mds[i][j])
                    acc = acc + term
                new.append(acc)
            st = new
        self.state = st

    # -- sponge ----------------------------------------------------------
    def absorb(self, elems):
        """Absorb a list of FE elements (overwrite-mode, rate 2)."""
        for e in elems:
            if self.absorb_queue is None:
                self.absorb_queue = []
            self.absorb_queue.append(e)
            if len(self.absorb_queue) == RATE:
                self._absorb_block()
        self.squeeze_pos = RATE

    def _absorb_block(self):
        for i, e in enumerate(self.absorb_queue):
            self.state[i] = self.state[i] + e
        self.absorb_queue = []
        self.permute()

    def _flush(self):
        if self.absorb_queue:
            self._absorb_block()

    def squeeze(self, n: int):
        """Squeeze n field elements."""
        self._flush()
        out = []
        for _ in range(n):
            if self.squeeze_pos >= RATE:
                self.permute()
                self.squeeze_pos = 0
            out.append(self.state[self.squeeze_pos])
            self.squeeze_pos += 1
        return out

    # -- cross-field helpers (FiatShamirAlgebraicSpongeRng role) -----------
    def absorb_nonnative(self, elems, src_bits: int):
        """Absorb elements of the *other* field: bit-pack into native
        capacity chunks (same packing as gadgets/inputs.py)."""
        cap = self.FE.CAPACITY if hasattr(self.FE, "CAPACITY") else \
            self.FE.F.CAPACITY
        bits = []
        for e in elems:
            v = e.n if hasattr(e, "n") else int(e)
            bits.extend(((v >> i) & 1) for i in range(src_bits))
        packed = []
        for i in range(0, len(bits), cap):
            chunk = bits[i : i + cap]
            v = 0
            for j, b in enumerate(chunk):
                if b:
                    v |= 1 << j
            packed.append(self.FE.from_int(v))
        self.absorb(packed)

    def squeeze_challenge_int(self, nbits: int = 128) -> int:
        """A challenge integer < 2^nbits (host sponge only)."""
        e = self.squeeze(1)[0]
        v = e.n if hasattr(e, "n") else e.val
        return v & ((1 << nbits) - 1)

    def squeeze_challenge_bits(self, nbits: int = 128):
        """Gadget path: challenge as Booleans (low bits of a squeezed
        element, canonical decomposition)."""
        e = self.squeeze(1)[0]
        bits = e.to_bits_le()
        return bits[:nbits]
