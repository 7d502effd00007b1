"""Public-input repacking across the cycle's field boundary (replaces
ark-crypto-primitives' BooleanInputVar / FromFieldElementsGadget; behavior
pinned at reference src/ec_cycle_pcd/mod.rs:233-237 and
data_structures.rs:126-133, 285-294).

A SNARK over field F verified inside a circuit over CF receives its public
inputs as *bits* (Booleans over CF), grouped per F-element:

  - repack_native(F_src, F_dst, elems): flatten the little-endian bits of
    each src element (full BITS each), chunk into CAPACITY(F_dst)-bit groups,
    interpret each chunk as an F_dst element.  Used natively when the outer
    verifier feeds MainField elements to the help SNARK.
  - BooleanInputVar.new_input: allocate repacked chunks as *public* CF
    inputs and open them into bits (the help circuit's input layout must
    match repack_native exactly).
  - BooleanInputVar.from_field_elements: reinterpret in-circuit CF values
    bitwise as F elements (used by MainCircuit to feed the prior-proof
    verifier).

The port's copy of `pcd_tpu/gadgets/inputs.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from .fp import Boolean


def flatten_bits_native(F_src, elems):
    bits = []
    for e in elems:
        v = e.n if hasattr(e, "n") else int(e)
        bits.extend(((v >> i) & 1 == 1) for i in range(F_src.BITS))
    return bits


def repack_native(F_src, F_dst, elems):
    """list[F_src] -> list[F_dst] by bit-chunking (capacity packing)."""
    bits = flatten_bits_native(F_src, elems)
    cap = F_dst.CAPACITY
    out = []
    for i in range(0, len(bits), cap):
        chunk = bits[i : i + cap]
        v = 0
        for j, b in enumerate(chunk):
            if b:
                v |= 1 << j
        out.append(F_dst.from_int(v))
    return out


def repack_chunk_ints(F_src, F_dst, elems):
    """The raw chunk integers of repack_native (= the instance values that
    BooleanInputVar.new_input allocates, for witness-program replay)."""
    bits = flatten_bits_native(F_src, elems)
    cap = F_dst.CAPACITY
    out = []
    for i in range(0, len(bits), cap):
        v = 0
        for j, b in enumerate(bits[i : i + cap]):
            if b:
                v |= 1 << j
        out.append(v)
    return out


def repacked_len(F_src, F_dst, n_elems: int) -> int:
    cap = F_dst.CAPACITY
    total = F_src.BITS * n_elems
    return (total + cap - 1) // cap


class BooleanInputVar:
    """Bits (Booleans over CF) of each public-input element of the inner
    SNARK (inner field F)."""

    def __init__(self, F, per_elem_bits):
        self.F = F               # inner field (host class)
        self.bits = per_elem_bits  # list[list[Boolean]]

    def __len__(self):
        return len(self.bits)

    @classmethod
    def new_input(cls, fpcls, F_inner, values):
        """Allocate in the outer circuit (field CF) public inputs encoding
        `values` (host F_inner elems) — chunk layout == repack_native.

        Each chunk is a public CF element, opened into CAPACITY bits
        (unique since chunk < 2^CAPACITY <= (p-1)); the bits are regrouped
        into per-inner-element lists."""
        CF = fpcls.F
        cap = CF.CAPACITY
        all_bits_native = flatten_bits_native(F_inner, values)
        bit_vars = []
        for i in range(0, len(all_bits_native), cap):
            chunk = all_bits_native[i : i + cap]
            v = 0
            for j, b in enumerate(chunk):
                if b:
                    v |= 1 << j
            x = fpcls.new_instance(v)
            # open into bits: booleans + unique recomposition
            cbits = []
            src_lc = x.lc  # shared object -> replay groups the bits
            for j, b in enumerate(chunk):
                cbits.append(Boolean.new_witness(fpcls, b))
                fpcls.CS.set_last_recipe(("bit", src_lc, j))
            Boolean.le_bits_to_fp(fpcls, cbits).enforce_equal(x)
            bit_vars.extend(cbits)
        per_elem = [bit_vars[k * F_inner.BITS : (k + 1) * F_inner.BITS]
                    for k in range(len(values))]
        return cls(F_inner, per_elem)

    @classmethod
    def from_field_elements(cls, F_inner, cf_fpvars):
        """Reinterpret CF circuit values bitwise as F_inner elements
        (flatten full-bit decompositions, chunk by F_inner capacity)."""
        bits = []
        for v in cf_fpvars:
            bits.extend(v.to_bits_le())
        cap = F_inner.CAPACITY
        groups = [bits[i : i + cap] for i in range(0, len(bits), cap)]
        return cls(F_inner, groups)

    @staticmethod
    def repack_input(F_src, F_dst, elems):
        return repack_native(F_src, F_dst, elems)
