"""The device scheduler's P1 kernels (pcd_tpu_torch/csrc/sched_digits.cu)
emulated on the CPU.  Each kernel's plain version runs at the kernels'
geometry: the digits, the tiles' histograms, their bin-major scan and the
stable scatter by warp segments.  Tiles are forced to 256 scalars (eight
warp segments of 32), so every vector spans several tiles and a ragged
last one; `DevSchedMSM.p1_tiles` on a CPU tensor is the same emulation at
the kernels' own tile.  Held exactly (order, signs and counts) to the
plain P1 (the digits, a stable torch.sort and a searchsorted) and to
pcd_tpu's DevSchedMSM._p1 on JAX-CPU, whose order is the argsort alone:
the port's order carries each index's digit sign in bit 31 (p1_scatter
stores the perm entry P2 places), so it is held to the reference with
bit 31 masked, and bit 31 to the digit's sign:

  - c = 5, 6 and 8 on the toy cycle, with the carry absorbed by the top
    window and with a carry window of its own;
  - dense scalars, all-zero scalars, every key of a window in one bin,
    low-entropy scalars that leave windows without a nonzero digit, and
    one scalar (n below one tile);
  - every c the entry takes (2-14, up to 8,194 bins) on 298-bit scalars,
    against the plain P1;
  - the overflow bin: a top-window digit above B is counted in the last
    column, where the reference has none;
  - p1_tiles at the kernels' tile of 8,192 scalars, on two full tiles and
    a ragged one;
  - order's bit 31 against the reference's signs, through the plain P1
    and the tiled path, on scalars with many negative digits;
  - the wrappers count one plain call per P1 kernel.
"""

from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.ops.msm_stream import StreamMSMCtx as RefCtx  # noqa: E402
from pcd_tpu.ops.msm_stream_dev import DevSchedMSM as RefDev  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops import ec as tec  # noqa: E402
from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx  # noqa: E402
from pcd_tpu_torch.ops.msm_stream_dev import (P1_KERNELS,  # noqa: E402
                                              P1_TILE, DevSchedMSM)
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402

from _torch_support import two_torch_threads  # noqa: E402,F401

CPU = torch.device("cpu")
TILE = 256
N = 3 * TILE + 37                # three full tiles and a ragged one
CASES = ["dense", "all_zero", "one_bin", "low_entropy", "one_scalar"]


@lru_cache(maxsize=None)
def _toy(c, carry_win):
    """pcd_tpu's and the port's DevSchedMSM over the toy Fr at c bits;
    carry_win asks for scalar_bits a multiple of c."""
    bits = RM.toy_cycle().main.Fr.BITS
    if carry_win:
        bits = bits // c * c
    rc = RefCtx(RM.toy_cycle().main.g1, bits, c=c, lanes=128)
    pc = StreamMSMCtx(TM.toy_cycle().main.g1, bits, c=c, lanes=128)
    assert (rc.carry_win, pc.carry_win) == (carry_win, carry_win)
    return RefDev(rc), DevSchedMSM(pc)


def _words(dm, scalars):
    pc = dm.sctx
    return dm.upload(pc.limb_rows(scalars, (pc.scalar_bits + 63) // 64 * 8),
                     CPU)


def _case(case, dm, seed):
    pc = dm.sctx
    top = (1 << pc.scalar_bits) - 1
    rng = np.random.default_rng(seed)
    dense = [int(x) & top for x in rng.integers(0, 1 << 62, size=N)]
    if case == "dense":
        return dense[:-3] + [0, 1, top]
    if case == "all_zero":
        return [0] * N
    if case == "one_bin":                 # each window's keys in one bin
        return [3] * N
    if case == "low_entropy":             # windows 1, 2 and above 3 empty
        return [(i % 7) | (5 << (3 * pc.c)) if i % 3 else i % 7
                for i in range(N)]
    return dense[:1]                       # one_scalar


def _emulate(dm, W, tile=TILE):
    """P1 as the kernels compute it, at `tile` scalars a tile: each step's
    plain version."""
    mags, signs = dm.digits(W)
    starts, counts = dm.scan_plain(dm.hist_plain(mags, tile))
    return dm.scatter_plain(mags, signs, starts, counts, tile), signs, counts


def _unsigned(order, signs):
    """order's indices with bit 31 masked, after checking that bit 31 is
    the digit's sign at each index."""
    idx = order.to(torch.int64) & 0x7FFFFFFF
    assert torch.equal(order < 0, signs.to(torch.int64).gather(1, idx) != 0)
    return idx


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("carry_win", [False, True], ids=["absorbed",
                                                          "carry_win"])
@pytest.mark.parametrize("c", [5, 6, 8])
def test_tiled_p1_matches_reference(c, carry_win, case):
    """The kernels' tiled emulation equals the plain P1 and pcd_tpu's
    `_p1`: order, signs and counts, the overflow bin empty."""
    ref, dm = _toy(c, carry_win)
    W = _words(dm, _case(case, dm, c))
    got = _emulate(dm, W)
    _equal(got, dm.p1_plain(W))
    order, signs, counts = got
    ro, rs, rcnt = ref._p1(W.shape[1])(jnp.asarray(W.numpy().view(
        np.uint32)), None)
    assert np.array_equal(_unsigned(order, signs).numpy(), np.asarray(ro))
    assert np.array_equal(signs.numpy(), np.asarray(rs))
    assert np.array_equal(counts.numpy()[:, :-1], np.asarray(rcnt))
    assert not counts[:, -1].any()
    assert (counts.sum(1) == W.shape[0]).all()
    busy = (counts[:, 1:] > 0).sum(1)
    if case in ("all_zero", "one_bin"):   # every key of a window in one bin
        assert ((counts > 0).sum(1) == 1).all()
    if case == "low_entropy":
        assert (busy == 0).any() and busy[0] > 0


@pytest.mark.parametrize("c", range(2, 15))
def test_tiled_p1_every_c(c):
    """Every c the kernels take, 298-bit scalars (c = 14: 8,194 bins):
    the tiled emulation equals the plain P1."""
    cfg = TM.mnt_cycle().main
    pc = StreamMSMCtx(cfg.g1, cfg.Fr.BITS, c=c, lanes=max(128, 1 << c))
    dm = DevSchedMSM(pc)
    r = cfg.Fr.MODULUS
    rng = np.random.default_rng(c)
    scalars = [int.from_bytes(rng.bytes(40), "little") % r
               for _ in range(2 * TILE + 5)]
    scalars[:3] = [0, 1, r - 1]
    W = _words(dm, scalars)
    got = _emulate(dm, W)
    _equal(got, dm.p1_plain(W))
    assert got[2].shape == (pc.nwin, pc.B + 2)


@pytest.mark.parametrize("path", ["plain", "tiled"])
@pytest.mark.parametrize("c", [5, 6, 8])
def test_signed_order(c, path):
    """order & 0x7FFFFFFF is the reference's stable argsort and bit 31 the
    reference's digit sign at that index, through the plain P1 (torch.sort,
    then the signs) and the tiled path (scatter_plain stages them with
    the keys), on dense scalars whose digits are about half negative."""
    ref, dm = _toy(c, False)
    pc = dm.sctx
    top = (1 << pc.scalar_bits) - 1
    rng = np.random.default_rng(40 + c)
    W = _words(dm, [int(x) & top for x in rng.integers(0, 1 << 62,
                                                       size=N)])
    order, signs, _ = dm.p1_plain(W) if path == "plain" else _emulate(dm, W)
    ro, rs, _ = ref._p1(W.shape[1])(jnp.asarray(W.numpy().view(np.uint32)),
                                    None)
    idx = order.to(torch.int64) & 0x7FFFFFFF
    assert np.array_equal(idx.numpy(), np.asarray(ro))
    want = np.take_along_axis(np.asarray(rs), idx.numpy(), 1) != 0
    assert np.array_equal((order < 0).numpy(), want)
    assert 0.3 < want[:-1].mean() < 0.7


def test_tiled_p1_overflow_bin():
    """A scalar wider than scalar_bits puts B + 1 in the absorbed top
    window: the tiled emulation and the plain P1 both count it in the
    last column, sort it last, and the schedule raises."""
    _, dm = _toy(6, False)
    pc = dm.sctx
    scalars = [int(x) for x in np.random.default_rng(3).integers(
        0, 1 << 20, size=N)]
    scalars[TILE + 9] = (1 << (pc.base_windows * pc.c)) - 1
    W = _words(dm, scalars)
    order, signs, counts = _emulate(dm, W)
    _equal((order, signs, counts), dm.p1_plain(W))
    assert counts[:, -1].tolist() == [0] * (pc.nwin - 1) + [1]
    assert order[-1, -1] == TILE + 9           # the top window: no sign
    with pytest.raises(ValueError, match="scalar_bits"):
        dm.schedule(W)


def test_p1_counts_one_plain_call_per_kernel():
    """On a CPU tensor P1 and p1_tiles count one plain call per P1 kernel
    each and launch nothing."""
    _, dm = _toy(8, False)
    W = _words(dm, list(range(N)))
    tec.reset_launch_counts()
    dm.p1(W)
    assert tec.plain_counts() == {(k, dm.form): 1 for k in P1_KERNELS}
    dm.p1_tiles(W)
    assert tec.plain_counts() == {(k, dm.form): 2 for k in P1_KERNELS}
    assert tec.launch_counts() == {}


@pytest.mark.parametrize("c,carry_win", [(5, False), (6, True), (8, False),
                                         (8, True)])
def test_p1_tiles_at_kernel_tile(c, carry_win):
    """p1_tiles on a CPU tensor, at the kernels' own tile: two full tiles
    and a ragged one of dense scalars equal the plain P1."""
    _, dm = _toy(c, carry_win)
    top = (1 << dm.sctx.scalar_bits) - 1
    rng = np.random.default_rng(c)
    scalars = [int(x) & top for x in rng.integers(0, 1 << 62,
                                                   size=2 * P1_TILE + 37)]
    W = _words(dm, scalars)
    got = dm.p1_tiles(W)
    _equal(got, dm.p1_plain(W))
    assert (got[2].sum(1) == W.shape[0]).all()


def test_schedule_on_no_stream_on_cpu(monkeypatch):
    """On the CPU side_stream yields no schedule stream and schedule(...,
    stream=None) is DevSchedMSM.schedule: the same device schedule."""
    _, dm = _toy(6, False)
    pc = dm.sctx
    monkeypatch.setattr(msm_dispatch, "SCHEDULER", "device")
    limbs = pc.limb_rows(list(range(1, 300)), 8)
    with msm_dispatch.side_stream(object(), CPU) as sched:
        assert sched is None
        got = msm_dispatch.schedule(pc, limbs, CPU, sched)
    want = dm.schedule(dm.upload(limbs, CPU))
    assert (got.act, got.T, got.maxrun) == (want.act, want.T, want.maxrun)
    for a, b in zip(got.on(CPU), want.on(CPU)):
        assert torch.equal(a, b)
