"""The host's Jacobian arithmetic (`curves/jacobian.py`) gives the affine
`SWPoint`'s points: scalar products at the edge scalars and at random
ones, the doubling and inverse cases of an add, the Horner combine, and
the card's homogeneous window sums taken in; on the toy cycle and on
MNT4-298 and MNT6-298, G1 and G2 (Fq, Fq2, Fq3).  A window sum off the
curve makes the stream MSM's Horner raise."""

import random

import numpy as np
import pytest

from pcd_tpu_torch.curves import models as M
from pcd_tpu_torch.curves.jacobian import jacobian, mul

CURVES = ["toy_mnt4", "toy_mnt6", "mnt4_298", "mnt6_298"]


@pytest.fixture(scope="module", params=CURVES)
def cfg(request):
    return getattr(M, request.param)()


@pytest.mark.parametrize("grp", ["g1", "g2"])
def test_products_are_the_affine_products(cfg, grp):
    g = cfg.g1_gen if grp == "g1" else cfg.g2_gen
    r = cfg.Fr.MODULUS
    rng = random.Random(7)
    base = g * rng.randrange(1, r)
    for k in (0, 1, 2, 3, r - 1, r, r + 1, -1, -5, rng.randrange(r),
              cfg.Fr(rng.randrange(r))):
        assert mul(base, k) == base * k, k
    assert mul(base.curve.infinity(), 5).is_infinity()


@pytest.mark.parametrize("grp", ["g1", "g2"])
def test_adds_and_horner(cfg, grp):
    g = cfg.g1_gen if grp == "g1" else cfg.g2_gen
    jac = jacobian(g.curve)
    rng = random.Random(11)
    pts = [g * rng.randrange(1, cfg.Fr.MODULUS) for _ in range(4)]
    P, Q = (jac.of_affine(x) for x in pts[:2])
    assert jac.to_affine(jac.add(P, Q)) == pts[0] + pts[1]
    assert jac.to_affine(jac.add(P, P)) == pts[0].double()
    assert jac.add(P, jac.of_affine(-pts[0])) is None
    assert jac.to_affine(jac.madd(jac.dbl(P), *P[:2])) == pts[0] * 3
    assert jac.madd(P, *jac.of_affine(-pts[0])[:2]) is None
    assert jac.add(None, Q) == Q and jac.add(P, None) == P
    # Horner over four windows of c = 3, the second empty and the third
    # of two points, as a gathered sharded MSM gives them
    want = g.curve.infinity()
    windows = [[pts[0]], [], [pts[1], pts[2]], [pts[3]]]
    for w in windows:
        for _ in range(3):
            want = want.double()
        for x in w:
            want = want + x
    got = jac.horner(3, ([jac.of_affine(x) for x in w] for w in windows))
    assert got == want
    assert jac.horner(3, [[], []]).is_infinity()


def _window_sums(curve, gen, r):
    """A toy stream MSM's window sums on the CPU (c = 6, 128 lanes):
    (ctx, the (nwin, 3, d, 10) sums, the MSM's host point)."""
    torch = pytest.importorskip("torch")
    from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx

    ctx = StreamMSMCtx(curve, r.bit_length(), 6, 128)
    pts = [gen * (i + 1) for i in range(40)]
    pts[3] = curve.infinity()
    zs = [(7 ** i) % r for i in range(40)]
    table, limbs = ctx.operands(pts, zs, torch.device("cpu"))
    ws = ctx.collect(*ctx.window_sums_async(table, ctx.schedule_native(
        limbs)))
    want = sum((p * z for p, z in zip(pts, zs)), curve.infinity())
    return ctx, ws, want


@pytest.mark.parametrize("grp", ["g1", "g2"])
def test_window_sums_come_in_homogeneous(grp):
    """The card's (X : Y : Z) window sums, decoded by
    `ECCtx.decode_jacobian`, are the points `decode_point` gives, the
    identity (0 : 1 : 0) None; the Horner over them is the MSM."""
    cfg = M.toy_mnt6()
    curve, gen = (cfg.g1, cfg.g1_gen) if grp == "g1" else (cfg.g2,
                                                            cfg.g2_gen)
    ctx, ws, want = _window_sums(curve, gen, cfg.Fr.MODULUS)
    jac = jacobian(curve)
    rows = np.concatenate([ws, ctx.ec.identity((1,), "cpu").numpy()])
    got = ctx.ec.decode_jacobian(rows)
    assert got[-1] is None
    assert [jac.to_affine(J) for J in got[:-1]] == [
        ctx.ec.decode_point(w) for w in ws]
    assert ctx.horner_host(ws) == want


def test_faulty_window_sum_raises():
    """A window sum moved off the curve reaches the Horner's result, which
    is held to the curve equation."""
    cfg = M.toy_mnt4()
    ctx, ws, want = _window_sums(cfg.g1, cfg.g1_gen, cfg.Fr.MODULUS)
    assert ctx.horner_host(ws) == want
    bad = ws.copy()
    bad[-1, 0, 0, 0] ^= 1
    with pytest.raises(ValueError):
        ctx.horner_host(bad)
