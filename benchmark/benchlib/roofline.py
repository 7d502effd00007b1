"""The yardstick of the kernels' roofline shares: a frozen copy of the
bound arithmetic of `chip_smoke.py` (HBM_BYTES_PER_S, INT32_MAD_PER_S,
PRODUCTS, MULS_MADD, MULS_ADD), and the work an MSM's scalars need,
counted from the scalars alone and never from the program.

A bound is the larger of the bytes at the H100 SXM's 3.35 TB/s and the
32-bit multiply-adds at 64 a clock an SM x 132 SMs x 1.98 GHz (sm_90, the
CUDA C++ Programming Guide's throughput table), at the 700 W limit.  A
mixed add is 17 Fp^D products, a complete add 18 (RCB15); an Fp^D
Montgomery product is 210, 530 or 960 32 x 32-bit partial products (D =
1, 2, 3), each two multiply-adds.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 64 * 132 * 1.98e9
PRODUCTS = {1: 210, 2: 300 + 10 + 220, 3: 600 + 30 + 330}
MULS_MADD, MULS_ADD = 17, 18


def bound_s(mads: float = 0.0, nbytes: float = 0.0) -> float:
    """The least seconds the card could take: the larger of the two."""
    return max(mads / INT32_MAD_PER_S, nbytes / HBM_BYTES_PER_S)


def mixed_add_mads(adds: int, d: int) -> int:
    """Multiply-adds of `adds` mixed adds over Fp^d."""
    return adds * MULS_MADD * PRODUCTS[d] * 2


def complete_add_mads(adds: int, d: int) -> int:
    """Multiply-adds of `adds` complete adds over Fp^d."""
    return adds * MULS_ADD * PRODUCTS[d] * 2


def signed_digits(limbs, c: int, nbits: int):
    """The signed c-bit digits of scalars below 2^nbits: (nwin, n) int64,
    each in [-2^(c-1), 2^(c-1)], a digit above 2^(c-1) taking 2^c off and
    carrying one into the next window; nwin = nbits // c + 1 windows hold
    the last carry.  limbs: (n, k) int32 tensor of little-endian 32-bit
    words, on any device."""
    import torch

    w = limbs.to(torch.int64) & 0xFFFFFFFF
    n, k = w.shape
    nwin = nbits // c + 1
    half, mask = 1 << (c - 1), (1 << c) - 1
    out = torch.empty((nwin, n), dtype=torch.int64, device=limbs.device)
    carry = torch.zeros(n, dtype=torch.int64, device=limbs.device)
    for j in range(nwin):
        pos = j * c
        lo, off = pos // 32, pos % 32
        v = (w[:, lo] >> off) if lo < k else torch.zeros_like(carry)
        if off + c > 32 and lo + 1 < k:
            v = v | (w[:, lo + 1] << (32 - off))
        d = (v & mask) + carry
        carry = (d > half).to(torch.int64)
        out[j] = d - (carry << c)
    return out


def msm_work(limbs, c: int, nbits: int) -> tuple:
    """(nonzero signed digits, windows holding one or more) of an MSM's
    scalars: the mixed adds any bucket method needs to place every
    nonzero digit, and the windows whose buckets it must reduce."""
    dg = signed_digits(limbs, c, nbits)
    nz = dg != 0
    return int(nz.sum()), int(nz.any(dim=1).sum())


def bucket_reduction_adds(windows: int, c: int) -> int:
    """Complete adds of reducing `windows` windows of 2^(c-1) signed
    buckets to sum_b b S_b by running sums: 2 B a window."""
    return windows * 2 * (1 << (c - 1))
