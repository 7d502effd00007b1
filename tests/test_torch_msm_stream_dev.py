"""The port's device scheduler (pcd_tpu_torch/ops/msm_stream_dev.py)
against the JAX package's DevSchedMSM (pcd_tpu/ops/msm_stream_dev.py) on
the toy cycle, on the CPU with the plain versions, c = 5, 6 and 8 on 128
lanes:

  - P1's order, signs and counts equal pcd_tpu's `_p1` exactly (JAX on
    the CPU), with and without a carry window, and `_pick_shapes` equal;
  - the placement equals the host placement law (the numpy schedule of
    ops/msm_stream.py) at the same T, tensor for tensor, windows
    renumbered over the active ones;
  - a top-window digit above B raises, as the host digits do;
  - MSMs equal the host oracle as affine points: infinity rows, zero
    scalars, r - 1, all zero, low-entropy scalars that leave windows empty
    (between active ones too: the sentinel and global-lane case), more
    points than lanes, a row view at an offset;
  - one schedule serves a G1 and a G2 table, and the window sums equal
    pcd_tpu's DevSchedMSM.window_sums as points;
  - a toy Groth16 prove with msm_dispatch.SCHEDULER = "device" writes
    pcd_tpu's proof bytes, scheduling once for a/b1/b2/l and once for h.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.native import _points_to_arrays  # noqa: E402
from pcd_tpu.ops.msm_stream import StreamMSMCtx as RefCtx  # noqa: E402
from pcd_tpu.ops.msm_stream_dev import DevSchedMSM as RefDev  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops import ec as tec  # noqa: E402
from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx  # noqa: E402
from pcd_tpu_torch.ops.msm_stream_dev import DevSchedMSM  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402

from _torch_support import SquareChain  # noqa: E402
from _torch_support import reference_native_loaded  # noqa: E402,F401
from _torch_support import two_torch_threads  # noqa: E402,F401

CPU = torch.device("cpu")
CS = [5, 6, 8]


@pytest.fixture(scope="module")
def toy():
    return RM.toy_cycle().main, TM.toy_cycle().main


def _affine(P):
    if P.is_infinity():
        return None

    def ints(e):
        cs = e.to_prime_coeffs() if hasattr(e, "to_prime_coeffs") else [e]
        return tuple(int(c.n) for c in cs)

    return ints(P.x), ints(P.y)


def _points(gen, n):
    pts, cur = [], gen
    for _ in range(n):
        pts.append(cur)
        cur = cur + gen
    return pts


def _scalars(r, n, seed):
    rng = np.random.default_rng(seed)
    return [int(x) % r for x in rng.integers(0, 1 << 62, size=n)]


def _sparse(n, c):
    """Low-entropy scalars: digits only in windows 0 and 3 (window 3's all
    in one bucket), so windows 1-2 and those above 3 stay empty."""
    return [(i % 7) | (5 << (3 * c)) if i % 3 else i % 7 for i in range(n)]


def _host(points, scalars, curve):
    acc = curve.infinity()
    for p, s in zip(points, scalars):
        acc = acc + p * s
    return acc


def _ctxs(toy, c, carry_win=False, lanes=128, grp="g1"):
    """pcd_tpu's and the port's contexts over the toy Fr; carry_win asks
    for scalar_bits a multiple of c (the carry gets its own window)."""
    ref, port = toy
    bits = ref.Fr.BITS
    if carry_win:
        bits = bits // c * c
    rc = RefCtx(getattr(ref, grp), bits, c=c, lanes=lanes)
    pc = StreamMSMCtx(getattr(port, grp), bits, c=c, lanes=lanes)
    assert (rc.carry_win, pc.carry_win) == (carry_win, carry_win)
    return rc, pc, DevSchedMSM(pc)


def _limbs(pc, scalars):
    return pc.limb_rows(scalars, (pc.scalar_bits + 63) // 64 * 8)


def _table(pc, points):
    xs, ys, inf = _points_to_arrays(points, pc.ec.d)
    return pc.table_from_limbs(xs, ys, inf.astype(bool), CPU)


@pytest.mark.parametrize("carry_win", [False, True], ids=["absorbed",
                                                          "carry_win"])
@pytest.mark.parametrize("c", CS)
def test_p1_matches_reference(toy, c, carry_win):
    """Order, signs and counts of P1 equal pcd_tpu's `_p1` exactly; the
    overflow bin stays empty."""
    rc, pc, dm = _ctxs(toy, c, carry_win)
    r = toy[0].g1.order
    top = (1 << pc.scalar_bits) - 1
    scalars = [s & top for s in _scalars(r, 150, c)] + [0, 1, top] \
        + _sparse(40, c)
    limbs = _limbs(pc, scalars)
    W = dm.upload(limbs, CPU)
    order, signs, counts = dm.p1(W)
    ro, rs, rcnt = RefDev(rc)._p1(W.shape[1])(
        jnp.asarray(RefDev(rc).limbs_u32(limbs)), None)
    assert np.array_equal(order.numpy(), np.asarray(ro))
    assert np.array_equal(signs.numpy(), np.asarray(rs))
    assert np.array_equal(counts.numpy()[:, :-1], np.asarray(rcnt))
    assert not counts[:, -1].any()
    mags, hs = pc.digits_signed(limbs)      # the host digits agree too
    sm = torch.sort(torch.from_numpy(mags), dim=1, stable=True).values
    assert np.array_equal(sm.numpy(), np.take_along_axis(
        mags, order.numpy(), 1))
    assert np.array_equal(hs, signs.numpy().astype(bool))


@pytest.mark.parametrize("c", CS)
def test_pick_shapes_match_reference(toy, c):
    """Active windows, T and maxrun from the fetched histogram equal the
    reference's, for dense, low-entropy and one-bucket vectors."""
    rc, pc, dm = _ctxs(toy, c)
    ref_dm = RefDev(rc)
    r = toy[0].g1.order
    for scalars in (_scalars(r, 400, c), _sparse(300, c), [3] * 500):
        _, _, counts = dm.p1(dm.upload(_limbs(pc, scalars), CPU))
        cn = counts.numpy()
        got = dm._pick_shapes(cn)
        assert got == ref_dm._pick_shapes(cn[:, :-1])
        assert got[0] == [w for w in range(pc.nwin) if cn[w, 1:-1].any()]


@pytest.mark.parametrize("case", ["dense", "sparse", "over_lanes"])
@pytest.mark.parametrize("c", CS)
def test_placement_matches_host_law(toy, c, case):
    """perm, loads, bidx and runrem equal the numpy host schedule at the
    device's T, row for row over the active windows; the host's other
    windows are empty."""
    _, pc, dm = _ctxs(toy, c)
    r = toy[0].g1.order
    scalars = {"dense": _scalars(r, 200, c), "sparse": _sparse(200, c),
               "over_lanes": _scalars(r, 700, c + 1)}[case]
    limbs = _limbs(pc, scalars)
    sched = dm.schedule(dm.upload(limbs, CPU))
    mags, signs = pc.digits_signed(limbs)
    host = pc.schedule(mags, signs, T=sched.T)
    perm, loads, bidx, runrem = (t.numpy() for t in sched.on(CPU))
    act = list(sched.act)
    nact, L = len(act), pc.L
    assert perm.shape == (nact, sched.T, L)
    assert np.array_equal(perm, host.perm.view(np.int32)[act])
    assert np.array_equal(loads, host.loads[act])
    assert np.array_equal(runrem, host.runrem[act])
    hb = host.bidx[act].astype(np.int64)
    shift = (np.arange(nact) - np.asarray(act))[:, None] * L
    want = np.where(hb == pc.nwin * L, nact * L, hb + shift)
    assert np.array_equal(bidx, want)
    assert sched.maxrun == host.maxrun
    idle = [w for w in range(pc.nwin) if w not in act]
    assert not host.loads[idle].any()
    if case == "sparse":
        assert idle and max(act) > min(idle)     # a gap between windows


def test_top_window_overflow_raises(toy):
    """A scalar wider than scalar_bits puts a digit above B in the absorbed
    top window: the overflow bin counts it and the schedule raises, as
    the host digits do."""
    _, pc, dm = _ctxs(toy, 6)
    assert not pc.carry_win
    wide = [5, (1 << (pc.base_windows * pc.c)) - 1, 7]
    limbs = _limbs(pc, wide)
    W = dm.upload(limbs, CPU)
    _, _, counts = dm.p1(W)
    assert counts[:, -1].sum() == 1
    with pytest.raises(ValueError, match="scalar_bits"):
        dm.schedule(W)
    with pytest.raises(ValueError, match="scalar_bits"):
        pc.digits_signed(limbs)


MSM_CASES = ["edges", "all_zero", "low_entropy", "over_lanes", "offset",
             "carry_win"]


@pytest.mark.parametrize("case", MSM_CASES)
def test_msm_matches_host(toy, case):
    """The device-scheduled MSM (plain versions) against the host oracle,
    as affine points."""
    ref, _ = toy
    r = ref.g1.order
    c = 4 if case == "over_lanes" else 6
    _, pc, dm = _ctxs(toy, c, carry_win=case == "carry_win")
    n = 300 if case == "over_lanes" else 61
    pts = _points(ref.g1_gen, n + 9)
    scalars = _scalars(r, n, 3)
    if case == "edges":
        pts[4] = ref.g1.infinity()
        pts[10] = pts[7]
        scalars[0], scalars[1], scalars[2], scalars[4] = 0, r - 1, 1, 9
    elif case == "all_zero":
        scalars = [0] * n
    elif case == "low_entropy":
        scalars = _sparse(n, c)
    elif case == "carry_win":
        scalars = [s & ((1 << pc.scalar_bits) - 1) for s in scalars]
    off = 9 if case == "offset" else 0
    tec.reset_launch_counts()
    if case == "edges":                    # host points in, table built
        got = dm.msm(pts[:n], scalars, device="cpu")
    else:
        got = dm.msm_limbs(_table(pc, pts)[off:off + n], _limbs(pc, scalars))
    want = _host(pts[off:off + n], scalars, ref.g1)
    assert _affine(got) == _affine(want)
    k1 = tec.plain_counts().get(("madd_accumulate", pc.ec.name), 0)
    assert k1 == (0 if case == "all_zero" else 1)


def test_schedule_shared_across_g1_g2(toy):
    """One device schedule (no infinity mask) serves a G1 table with a
    flagged infinity and a G2 (Fq2) table."""
    ref, _ = toy
    _, g1, dm = _ctxs(toy, 6)
    _, g2, _ = _ctxs(toy, 6, grp="g2")
    n = 61
    p1s = _points(ref.g1_gen, n - 1) + [ref.g1.infinity()]
    p2s = [ref.g2_gen * (i + 2) for i in range(n)]
    scalars = _sparse(n, 6)
    sched = dm.schedule(dm.upload(_limbs(g1, scalars), CPU))
    for ctx, pts, curve in ((g1, p1s, ref.g1), (g2, p2s, ref.g2)):
        ws = ctx.collect(*ctx.window_sums_async(_table(ctx, pts), sched))
        assert ws.shape[0] == len(sched.act) < ctx.nwin
        got = ctx.horner_host(ws, sched.act)
        assert _affine(got) == _affine(_host(pts, scalars, curve))


@pytest.mark.slow
def test_window_sums_match_reference(toy):
    """Window sums of the active windows against pcd_tpu's own
    DevSchedMSM.window_sums, window by window as points, on scalars that
    leave windows empty (its P2 alone compiles for about a minute on the
    CPU: `slow`)."""
    ref, _ = toy
    rc, pc, dm = _ctxs(toy, 5)
    n = 90
    pts = _points(ref.g1_gen, n)
    pts[5] = ref.g1.infinity()
    scalars = _sparse(n, 5)
    scalars[7] = ref.g1.order - 1
    limbs = _limbs(pc, scalars)
    act, ws = dm.window_sums(_table(pc, pts), dm.upload(limbs, CPU))
    xs, ys, inf = _points_to_arrays(pts, 1)
    XY, _ = rc.table_from_limbs(xs, ys, inf.astype(bool))
    ref_dm = RefDev(rc)
    ract, rws = ref_dm.window_sums(XY, jnp.asarray(ref_dm.limbs_u32(limbs)))
    assert list(act) == list(ract) and 0 < len(act) < pc.nwin
    rws = [np.asarray(c) for c in rws]
    for i, w in enumerate(act):
        want = rc.ec.decode_point(tuple(c[i:i + 1] for c in rws))
        assert _affine(pc.ec.decode_point(ws[i])) == _affine(want), w


def test_groth16_prove_device_scheduler(monkeypatch):
    """A toy Groth16 prove with every commitment MSM device-scheduled:
    pcd_tpu's proof bytes; sched_digits runs twice (the z vector shared by
    a/b1/b2/l, then h), K1 and K4 once per MSM."""
    from pcd_tpu.snark.groth16.native import Groth16 as RG16
    from pcd_tpu.utils import serialize as RS
    from pcd_tpu.utils.rng import ChaChaRng as RRng
    from pcd_tpu_torch.snark.groth16.native import Groth16
    from pcd_tpu_torch.utils import serialize as TS
    from pcd_tpu_torch.utils.rng import ChaChaRng as TRng

    monkeypatch.setattr(Groth16, "STREAM_MIN", 0)
    monkeypatch.setattr(msm_dispatch, "WINDOW_BITS", 6)
    monkeypatch.setattr(msm_dispatch, "LANES", 128)
    monkeypatch.setattr(msm_dispatch, "SCHEDULER", "device")
    rcfg, tcfg = RM.toy_mnt4(), TM.toy_mnt4()
    rg, tg = RG16(rcfg), Groth16(tcfg, device="cpu")
    rpk, _ = rg.circuit_specific_setup(SquareChain(), RRng(b"devsched s"))
    tpk, tvk = tg.circuit_specific_setup(SquareChain(), TRng(b"devsched s"))
    tec.reset_launch_counts()
    proof = tg.prove(tpk, SquareChain(), TRng(b"devsched p"))
    plain = tec.plain_counts()
    ref = rg.prove(rpk, SquareChain(), RRng(b"devsched p"))
    assert TS.groth16_proof_to_bytes(proof) == RS.groth16_proof_to_bytes(ref)
    x = tcfg.Fr.from_int(pow(3, 1 << 40, tcfg.Fr.MODULUS))
    assert tg.verify(tvk, [x], proof)
    assert not tg.verify(tvk, [x + tcfg.Fr.from_int(1)], proof)
    assert [v for (k, _), v in plain.items() if k == "sched_digits"] == [2]
    for k in ("madd_accumulate", "bucket_finish"):
        assert plain[(k, tcfg.g1.name)] == 4         # a, b1, l, h
        assert plain[(k, tcfg.g2.name)] == 1         # b2
    assert tec.launch_counts() == {}


def test_unknown_scheduler_raises(toy, monkeypatch):
    _, pc, _ = _ctxs(toy, 6)
    monkeypatch.setattr(msm_dispatch, "SCHEDULER", "gpu")
    with pytest.raises(ValueError, match="SCHEDULER"):
        msm_dispatch.schedule(pc, _limbs(pc, [1, 2]), CPU)
