"""The device scheduler's P2 placement kernel (pcd_tpu_torch/csrc/
sched_place.cu, one launch) emulated on the CPU, c = 5, 6 and 8 on 128
lanes of the toy cycle.  Its plain version (`p2_place_plain`, the
kernel's formulas), which `place` runs on a CPU tensor, is held exactly
to `place_plain` (the placement law as torch ops), and `place` to the
numpy host law of the port and of pcd_tpu (its StreamMSMCtx.schedule on
pcd_tpu's own digits, the law of DevSchedMSM._p2), window for window.
Both read each entry's sign from bit 31 of P1's order:

  - dense scalars, sparse ones (windows 0 and 3 only: a gap between the
    active windows, so bidx's global lanes are renumbered), more points
    than lanes (T above the minimum of 8), every digit in one bucket
    ([3] * 500: one run of lanes) and all-zero scalars (no active window:
    no placement at all);
  - T at the fit and above it;
  - the wrapper counts one plain call of the P2 kernel a placement, and
    `place` refuses what the kernel does not take.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.ops.msm_stream import StreamMSMCtx as RefCtx  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops import ec as tec  # noqa: E402
from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx  # noqa: E402
from pcd_tpu_torch.ops.msm_stream_dev import (P2_KERNELS,  # noqa: E402
                                              DevSchedMSM)

from _torch_support import two_torch_threads  # noqa: E402,F401

CPU = torch.device("cpu")
CS = [5, 6, 8]
CASES = ["dense", "sparse", "over_lanes", "one_bucket", "all_zero"]


def _scalars(case, c, r):
    rng = np.random.default_rng(c)
    if case == "dense":
        return [int(x) % r for x in rng.integers(0, 1 << 62, size=200)]
    if case == "sparse":                  # windows 0 and 3 only
        return [(i % 7) | (5 << (3 * c)) if i % 3 else i % 7
                for i in range(200)]
    if case == "over_lanes":
        return [int(x) % r for x in rng.integers(0, 1 << 62, size=700)]
    if case == "one_bucket":
        return [3] * 500
    return [0] * 300                      # all_zero


def _p1(c, case):
    """(the port's DevSchedMSM, its limb rows, P1's order, signs and
    counts, the active windows and the fitted T) on the toy Fr."""
    cfg = TM.toy_cycle().main
    pc = StreamMSMCtx(cfg.g1, cfg.Fr.BITS, c=c, lanes=128)
    dm = DevSchedMSM(pc)
    limbs = pc.limb_rows(_scalars(case, c, cfg.g1.order),
                         (pc.scalar_bits + 63) // 64 * 8)
    order, signs, counts = dm.p1(dm.upload(limbs, CPU))
    act, T, _ = dm._pick_shapes(counts.numpy())
    return dm, limbs, (order, signs, counts), act, T


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("c", CS)
def test_p2_plain_steps_match_place_plain(c, case):
    """p2_place_plain, and place on a CPU tensor, equal place_plain at the
    fitted T and above it, every digit placed once; an all-zero vector has
    no active window and schedules no placement."""
    dm, limbs, p1, act, T = _p1(c, case)
    if case == "all_zero":
        assert act == []
        tec.reset_launch_counts()
        assert dm.schedule(dm.upload(limbs, CPU)).tensors is None
        assert not any(k in P2_KERNELS for k, _ in tec.plain_counts())
        return
    order, _, counts = p1
    for t in (T, T + 3, T + 8):
        want = dm.place_plain(order, counts, act, t)
        got = dm.p2_place_plain(order, counts, act, t)
        _equal(got, want)
        _equal(dm.place(order, counts, act, t), want)
        _, loads, _, runrem = got
        assert torch.equal(loads > 0, runrem > 0)
        nz = counts[act, 1:dm.sctx.B + 1].sum(1)     # every digit placed
        assert torch.equal(loads.sum(1), nz)


@pytest.mark.parametrize("case", CASES[:4])
@pytest.mark.parametrize("c", CS)
def test_place_matches_reference_law(c, case):
    """place (the kernels' emulation) equals pcd_tpu's numpy placement law
    at its T, on pcd_tpu's own digits: perm, loads, bidx (direct first
    lanes, windows renumbered over the active ones) and runrem; its other
    windows are empty."""
    dm, limbs, p1, act, _ = _p1(c, case)
    rc = RefCtx(RM.toy_cycle().main.g1, dm.sctx.scalar_bits, c=c, lanes=128)
    mags, signs = rc.digits_signed(limbs)
    ref = rc.schedule(mags, signs)
    perm, loads, bidx, runrem = (x.numpy() for x in dm.place(
        p1[0], p1[2], act, ref.T))
    nact, L, nwin = len(act), dm.sctx.L, dm.sctx.nwin
    assert np.array_equal(perm.view(np.uint32), ref.perm_unpacked()[act])
    assert np.array_equal(loads, ref.loads[act])
    assert np.array_equal(runrem, ref.runrem[act].astype(np.int32))
    hb = ref.bidx[act].astype(np.int64)
    shift = (np.arange(nact) - np.asarray(act))[:, None] * L
    assert np.array_equal(bidx, np.where(hb == nwin * L, nact * L,
                                         hb + shift))
    idle = [w for w in range(nwin) if w not in act]
    assert not ref.loads[idle].any()
    if case == "sparse":
        assert act == [0, 3]


@pytest.mark.parametrize("case", CASES[:4])
def test_place_matches_host_law_above_fit(case):
    """place equals the port's numpy host law at a T above the fit, and
    the fitted T already holds every lane's load."""
    dm, limbs, p1, act, T = _p1(6, case)
    mags, signs = dm.sctx.digits_signed(limbs)
    for t in (T, T + 5):
        host = dm.sctx.schedule(mags, signs, T=t)
        perm, loads, _, runrem = (x.numpy() for x in dm.place(
            p1[0], p1[2], act, t))
        assert np.array_equal(perm, host.perm.view(np.int32)[act])
        assert np.array_equal(loads, host.loads[act])
        assert np.array_equal(runrem, host.runrem[act])
        assert loads.max() <= t


def test_place_counts_one_plain_call_per_kernel():
    """On a CPU tensor place counts one plain call of the P2 kernel each
    time and launches nothing; place_plain and p2_place_plain called
    directly count nothing."""
    dm, _, (order, _, counts), act, T = _p1(8, "dense")
    tec.reset_launch_counts()
    dm.place_plain(order, counts, act, T)
    dm.p2_place_plain(order, counts, act, T)
    assert tec.plain_counts() == {}
    dm.place(order, counts, act, T)
    assert tec.plain_counts() == {(k, dm.form): 1 for k in P2_KERNELS}
    dm.place(order, counts, act, T)
    assert tec.plain_counts() == {(k, dm.form): 2 for k in P2_KERNELS}
    assert tec.launch_counts() == {}


def test_place_refuses_bad_operands():
    """No active window, unsorted or out-of-range windows, T below 1, P1
    tensors of another type or shape, and a device other than the CPU or
    a CUDA card are refused before any step runs."""
    dm, _, (order, _, counts), act, T = _p1(6, "sparse")
    nwin = dm.sctx.nwin
    tec.reset_launch_counts()
    for bad_act, bad_T in (([], T), ([3, 0], T), ([0, nwin], T),
                           ([0, 0], T), (act, 0)):
        with pytest.raises(ValueError, match="P2"):
            dm.place(order, counts, bad_act, bad_T)
    for o, cn in ((order.long(), counts), (order, counts.long()),
                  (order, counts[:, :-1].contiguous()),
                  (order[:-1], counts[:-1]),
                  (order.t().contiguous().t(), counts)):
        with pytest.raises(ValueError, match="P2"):
            dm.place(o, cn, act, T)
    assert tec.plain_counts() == {}
    with pytest.raises(ValueError, match="p2_place"):
        dm.place(order.to("meta"), counts.to("meta"), act, T)
