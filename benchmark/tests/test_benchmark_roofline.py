"""The frozen bound arithmetic against PERF.md section 6's K1 and K4
rows, and the signed digits the work is counted from."""

import os
import random
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchlib import roofline  # noqa: E402


@pytest.mark.parametrize("adds, d, mixed, ms", [
    (2_491_032, 1, True, 1.063),     # K1, MNT4 G1, T = 24
    (461_956, 1, True, 0.197),       # K1, MNT6 G1
    (2_003_476, 2, True, 2.158),     # K1<2>, MNT4 G2
    (392_187, 3, True, 0.765),       # K1<3>, MNT6 G2
    (213_950, 1, False, 0.0967),     # K4, MNT4 G1, 25 x 8192 lanes
    (213_950, 2, False, 0.244),      # K4<2>, MNT4 G2
    (215_253, 3, False, 0.445),      # K4<3>, MNT6 G2
])
def test_bounds_match_the_kernel_table(adds, d, mixed, ms):
    mads = (roofline.mixed_add_mads if mixed
            else roofline.complete_add_mads)(adds, d)
    assert roofline.bound_s(mads=mads) * 1e3 == pytest.approx(ms, rel=5e-3)


def test_bytes_bound_the_larger():
    assert roofline.bound_s(mads=1, nbytes=3.35e12) == pytest.approx(1.0)


def words(vals, k=10):
    return torch.tensor([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(k)]
                         for v in vals], dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("c", [5, 8, 12])
def test_signed_digits_rebuild_the_scalars(c):
    rng = random.Random(c)
    vals = [0, 1, (1 << 297) - 1, (1 << c) - 1, 1 << (c - 1)] + [
        rng.getrandbits(297) for _ in range(200)]
    dg = roofline.signed_digits(words(vals), c, 297)
    half = 1 << (c - 1)
    assert int(dg.max()) <= half and int(dg.min()) > -half
    for i, v in enumerate(vals):
        assert sum(int(dg[j, i]) << (c * j) for j in range(dg.shape[0])) == v


def test_msm_work_counts():
    c = 12
    vals = [0, 1, 1 << 24, (1 << 12) - 1]
    # 1: one digit; 2^24: one digit; 4095 = 2^12 - 1: -1 and a carry
    nz, wins = roofline.msm_work(words(vals), c, 297)
    assert nz == 1 + 1 + 2
    assert wins == 3                       # windows 0, 1 and 2
    assert roofline.bucket_reduction_adds(25, 12) == 25 * 4096
