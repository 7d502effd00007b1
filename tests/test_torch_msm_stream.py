"""The port's stream MSM (pcd_tpu_torch/ops/msm_stream.py) against the JAX
package's StreamMSMCtx (pcd_tpu/ops/msm_stream.py) on the toy cycle, the
cases of tests/test_msm_stream.py (c = 6, lanes = 128) on the CPU: signed
digits, the numpy and C++ schedules, infinities, zero scalars, more points
than lanes, the absorbed carry window, one schedule shared across G1 and G2
tables, and the per-window sums on one C++ schedule; the host convenience
`msm` (host points and int scalars in) against the C++ Pippenger.  Points
cross between the packages as the C++ tier's u64 limb arrays; results are
compared as affine points.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.native import _points_to_arrays  # noqa: E402
from pcd_tpu.ops.msm_stream import StreamMSMCtx as RefCtx  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx  # noqa: E402

CPU = torch.device("cpu")


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


def _host(points, scalars, curve):
    acc = curve.infinity()
    for p, s in zip(points, scalars):
        acc = acc + p * s
    return acc


def _port_msm(ctx, ref_points, scalars):
    """The port's MSM on the C++ tier's limb arrays of pcd_tpu points."""
    d = ctx.ec.d
    xs, ys, inf = _points_to_arrays(ref_points, d)
    table = ctx.table_from_limbs(xs, ys, inf.astype(bool), CPU)
    limbs = ctx.limb_rows(scalars, (ctx.scalar_bits + 63) // 64 * 8)
    return ctx.msm_limbs(table, limbs, inf=inf.astype(bool))


def test_digits_match_reference(toy):
    ref, port = toy
    r = ref.g1.order
    scalars = _scalars(r, 23, 0) + [0, 1, r - 1, r // 2]
    rc = RefCtx(ref.g1, ref.Fr.BITS, c=6, lanes=128)
    pc = StreamMSMCtx(port.g1, port.Fr.BITS, c=6, lanes=128)
    limbs = pc.limb_rows(scalars, nbytes=8)
    mags, signs = pc.digits_signed(limbs)
    rmags, rsigns = rc.digits_signed(limbs)
    assert np.array_equal(mags, rmags) and np.array_equal(signs, rsigns)
    for j, s in enumerate(scalars):
        v = sum((-int(mags[w, j]) if signs[w, j] else int(mags[w, j]))
                << (w * pc.c) for w in range(pc.nwin))
        assert v == s


def test_schedules_match_reference(toy):
    """The numpy oracle and the C++ schedule both equal pcd_tpu's, down to
    the finish's direct bucket lanes and run lengths."""
    ref, port = toy
    rc = RefCtx(ref.g1, ref.Fr.BITS, c=6, lanes=128)
    pc = StreamMSMCtx(port.g1, port.Fr.BITS, c=6, lanes=128)
    n = 130
    limbs = np.ascontiguousarray(
        pc.limb_rows(_scalars(ref.g1.order, n, 2), nbytes=8).astype("<u8"))
    inf = np.zeros(n, bool)
    inf[3] = True
    mags, signs = pc.digits_signed(limbs)
    a = pc.schedule(mags, signs, inf)
    b = rc.schedule(mags, signs, inf)
    assert np.array_equal(a.perm, b.perm_unpacked())
    for f in ("loads", "bidx", "runrem", "maxrun", "T"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    c = pc.schedule_native(limbs)
    d = rc.schedule_any(limbs)
    assert np.array_equal(c.perm, d.perm_unpacked())
    for f in ("loads", "bidx", "runrem", "maxrun", "T"):
        assert np.array_equal(getattr(c, f), getattr(d, f)), f
    for w in range(pc.nwin):
        assert int(c.loads[w].sum()) == int((mags[w] != 0).sum())


def test_msm_oracle_full(toy):
    ref, port = toy
    r = ref.g1.order
    n = 61
    pts = _points(ref.g1_gen, n)
    pts[4] = ref.g1.infinity()
    pts[10] = pts[7]
    scalars = _scalars(r, n, 3)
    scalars[0], scalars[1], scalars[2] = 0, r - 1, 1
    pc = StreamMSMCtx(port.g1, port.Fr.BITS, c=6, lanes=128)
    got = _port_msm(pc, pts, scalars)
    assert _affine(got) == _affine(_host(pts, scalars, ref.g1))


def test_carry_window_absorbed(toy):
    ref, port = toy
    bits = port.Fr.BITS
    c = 6
    base = -(-bits // c)
    sc = StreamMSMCtx(port.g1, bits, c=c, lanes=128)
    if bits % c:
        assert not sc.carry_win and sc.nwin == base
    sc2 = StreamMSMCtx(port.g1, base * c, c=c, lanes=128)
    assert sc2.carry_win and sc2.nwin == base + 1
    r = ref.g1.order
    scalars = _scalars(r, 40, 9) + [0, 1, r - 1]
    for ctx in (sc, sc2):
        rctx = RefCtx(ref.g1, ctx.scalar_bits, c=c, lanes=128)
        assert (ctx.carry_win, ctx.nwin) == (rctx.carry_win, rctx.nwin)
        limbs = ctx.limb_rows(scalars, nbytes=8)
        mags, signs = ctx.digits_signed(limbs)
        for j, s in enumerate(scalars):
            v = sum((-int(mags[w, j]) if signs[w, j] else int(mags[w, j]))
                    << (w * ctx.c) for w in range(ctx.nwin))
            assert v == s
    pts = _points(ref.g1_gen, len(scalars))
    assert _affine(_port_msm(sc2, pts, scalars)) == _affine(
        _host(pts, scalars, ref.g1))


def test_msm_all_zero_scalars(toy):
    ref, port = toy
    pc = StreamMSMCtx(port.g1, port.Fr.BITS, c=6, lanes=128)
    assert _port_msm(pc, _points(ref.g1_gen, 9), [0] * 9).is_infinity()


def test_msm_more_points_than_lanes(toy):
    """n > lanes forces multi-round lanes (T > 1) and bucket collisions."""
    ref, port = toy
    pc = StreamMSMCtx(port.g1, port.Fr.BITS, c=4, lanes=128)
    n = 300
    pts = _points(ref.g1_gen, n)
    scalars = _scalars(ref.g1.order, n, 4)
    assert _affine(_port_msm(pc, pts, scalars)) == _affine(
        _host(pts, scalars, ref.g1))


def test_schedule_reuse_across_tables_with_inf_flags(toy):
    """One schedule built without infinity masking serves a G1 table with
    a flagged infinity and a G2 (Fq2) table, as the prover's a/b1/b2 MSMs
    share one; its upload is memoized on the schedule."""
    ref, port = toy
    g1 = StreamMSMCtx(port.g1, port.Fr.BITS, c=6, lanes=128)
    g2 = StreamMSMCtx(port.g2, port.Fr.BITS, c=6, lanes=128)
    n = 61
    p1s = [ref.g1_gen * (i + 1) for i in range(n - 1)] + [ref.g1.infinity()]
    p2s = [ref.g2_gen * (i + 2) for i in range(n)]
    scalars = _scalars(ref.g1.order, n, 9)
    limbs = g1.limb_rows(scalars, 8)
    sched = g1.schedule_native(limbs)
    outs = []
    for ctx, pts in ((g1, p1s), (g2, p2s)):
        xs, ys, inf = _points_to_arrays(pts, ctx.ec.d)
        table = ctx.table_from_limbs(xs, ys, inf.astype(bool), CPU)
        outs.append(ctx.horner_host(ctx.collect(*ctx.window_sums_async(
            table, sched))))
    assert len(sched._dev) == 1
    assert _affine(outs[0]) == _affine(_host(p1s, scalars, ref.g1))
    assert _affine(outs[1]) == _affine(_host(p2s, scalars, ref.g2))


def test_window_sums_match_reference(toy):
    """Per-window sums on one C++ schedule: the port's K1 + finish against
    pcd_tpu's window_sums_async (CPU branches), window by window."""
    ref, port = toy
    n = 90
    pts = _points(ref.g1_gen, n)
    pts[5] = ref.g1.infinity()
    scalars = _scalars(ref.g1.order, n, 7)
    rc = RefCtx(ref.g1, ref.Fr.BITS, c=6, lanes=128)
    pc = StreamMSMCtx(port.g1, port.Fr.BITS, c=6, lanes=128)
    limbs = pc.limb_rows(scalars, 8)
    xs, ys, inf = _points_to_arrays(pts, 1)
    inf = inf.astype(bool)
    sched = pc.schedule_native(limbs)
    table = pc.table_from_limbs(xs, ys, inf, CPU)
    ws = pc.collect(*pc.window_sums_async(table, sched))
    XY, _ = rc.table_from_limbs(xs, ys, inf)
    rws = [np.asarray(c) for c in rc.window_sums_async(
        XY, rc.schedule_any(limbs))]
    for w in range(pc.nwin):
        want = rc.ec.decode_point(tuple(c[w:w + 1] for c in rws))
        assert _affine(pc.ec.decode_point(ws[w])) == _affine(want), w
    assert _affine(pc.horner_host(ws)) == _affine(_host(pts, scalars,
                                                        ref.g1))


@pytest.mark.parametrize("grp", ["g1", "g2"])
def test_host_msm_entry_matches_cpp(toy, grp):
    """StreamMSMCtx.msm (host points and int scalars in, the table built
    on the CPU, the C++ schedule) equals the C++ Pippenger and the device
    scheduler's DevSchedMSM.msm on the port's own points, with an infinity,
    a repeated point, zero scalars and r - 1."""
    from pcd_tpu_torch import native
    from pcd_tpu_torch.ops.msm_stream_dev import DevSchedMSM

    _, port = toy
    curve, gen = getattr(port, grp), getattr(port, grp + "_gen")
    r = port.g1.order
    pts = _points(gen, 45)
    pts[3] = curve.infinity()
    pts[9] = pts[2]
    scalars = _scalars(r, 45, 11)
    scalars[0], scalars[1], scalars[2] = 0, r - 1, 1
    pc = StreamMSMCtx(curve, port.Fr.BITS, c=6, lanes=128)
    got = pc.msm(pts, scalars, device="cpu")
    assert got == native.msm(pts, scalars)
    assert got == DevSchedMSM(pc).msm(pts, scalars, device="cpu")
    assert pc.msm(pts, [0] * 45, device="cpu").is_infinity()


def test_host_msm_entry_refuses(toy):
    """Unequal lengths, no point and a device that is neither the CPU nor
    a card are refused."""
    _, port = toy
    pc = StreamMSMCtx(port.g1, port.Fr.BITS, c=6, lanes=128)
    pts = _points(port.g1_gen, 3)
    for args in ((pts, [1, 2]), ([], [])):
        with pytest.raises(ValueError, match="MSM"):
            pc.msm(*args, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        pc.msm(pts, [1, 2, 3], device="meta")
