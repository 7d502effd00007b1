"""The port's K3 (`ECCtx.madd`, the masked mixed add in place) and K2 in
the row layout, against the JAX package's EC32Ctx on the CPU:

  - K3's plain version against EC32Ctx.madd (pcd_tpu/ops/ec32.py:527-556;
    its non-TPU branch runs the `_rcb_maddT` body the Pallas kernel at
    ec32.py:620 wraps), with mixed sign and active flags, flagged table
    rows, acc = identity and acc = +-Q;
  - K2's plain version against EC32Ctx.add on rows (the row layout of
    EC32Ctx._add_pallas, ec32.py:411-444, whose counterpart is K2<1>);
  - K3's plain version against K1's at T = 1, and the wrapper's CPU
    dispatch.

For MNT4-298 G1, MNT6-298 G1 and both toy G1 curves.  Inputs are made
with numpy from a seed and cross as u64 limb arrays; results are
compared as affine points, exactly (modular integer arithmetic).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.msm.host import fixed_base_many  # noqa: E402
from pcd_tpu.native import _points_to_arrays  # noqa: E402
from pcd_tpu.ops.ec32 import EC32Ctx  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops import ec as tec  # noqa: E402

from _torch_support import reference_native_loaded  # noqa: E402,F401

FORMS = [("toy_cycle", "main"), ("toy_cycle", "help"), ("mnt_cycle", "main"),
         ("mnt_cycle", "help")]
IDS = ["-".join(f) for f in FORMS]
N = 48


def _affine(P):
    """A point as comparable canonical ints (None for infinity)."""
    if P.is_infinity():
        return None
    return int(P.x.n), int(P.y.n)


def _setup(form, seed):
    """The reference and port G1 contexts, N + N random points (the
    second N as accumulators), flags, and a row layout where the first
    eighth of the accumulators is the identity, the next eighth +-Q."""
    cyc, side = form
    rcfg = getattr(getattr(RM, cyc)(), side)
    tcurve = getattr(getattr(TM, cyc)(), side).g1
    rng = np.random.default_rng(seed)
    pts = fixed_base_many(rcfg.g1_gen,
                          [int(s) for s in rng.integers(1, 1 << 40, 2 * N)],
                          rcfg.Fr.BITS)
    q_pts, acc_pts = pts[:N], pts[N:]
    k = N // 8
    acc_pts[:k] = [rcfg.g1.infinity()] * k                  # acc = O
    acc_pts[k:2 * k] = q_pts[k:2 * k]                       # acc = Q
    sign = rng.integers(0, 2, N).astype(np.int32)
    sign[k:k + k // 2] = 0                                  # doubling
    sign[k + k // 2:2 * k] = 1                              # Q - Q
    active = (rng.random(N) >= 0.25).astype(np.int32)
    active[:2 * k] = 1
    flagged = np.zeros(N, dtype=bool)
    flagged[[5, 2 * k + 1, N - 1]] = True                   # flagged rows
    return rcfg, tcurve, q_pts, acc_pts, sign, active, flagged


def _port_rows(tcurve, q_pts, acc_pts, flagged):
    """(acc (N, 3, 1, 10), q (N, 2, 1, 10)) port tensors."""
    ec = tec.ec_ctx(tcurve)
    xs, ys, inf = _points_to_arrays(q_pts, 1)
    q = torch.from_numpy(ec.table_from_u64(xs, ys, inf.astype(bool)
                                           | flagged))
    ax, ay, ainf = _points_to_arrays(acc_pts, 1)
    tab = torch.from_numpy(ec.table_from_u64(ax, ay, ainf.astype(bool)))
    # acc rows as (x : y : 1), and (0 : 1 : 0) for the identity
    acc = ec.identity((N,), "cpu")
    one = acc[0, 1].clone()                  # Montgomery 1, the Y of O
    fin = torch.from_numpy(~ainf.astype(bool))
    acc[fin, :2] = tab[fin]
    acc[fin, 2] = one
    return ec, acc, q


def _expected(q_pts, acc_pts, sign, active, flagged):
    out = []
    for i in range(N):
        s = acc_pts[i]
        if active[i] and not flagged[i]:
            s = s + (-q_pts[i] if sign[i] else q_pts[i])
        out.append(_affine(s))
    return out


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_madd_matches_ec32(form):
    rcfg, tcurve, q_pts, acc_pts, sign, active, flagged = _setup(form, 7)
    ec, acc, q = _port_rows(tcurve, q_pts, acc_pts, flagged)
    got = ec.madd_plain(acc, q, torch.from_numpy(sign),
                        torch.from_numpy(active))
    got_aff = [_affine(ec.decode_point(r.numpy())) for r in got]
    assert got_aff == _expected(q_pts, acc_pts, sign, active, flagged)
    # pcd_tpu's EC32Ctx.madd on the same rows: acc projective (Z = 1 or
    # the identity), Q affine with the pad-limb infinity flag
    rec = EC32Ctx(rcfg.g1)
    X, Y, Z = rec.encode_points(acc_pts)
    qX, qY, _ = rec.encode_points(
        [rcfg.g1_gen if f else p for p, f in zip(q_pts, flagged)])
    qX[flagged, rec.fp.kp - 1] = 1.0
    R = rec.madd(tuple(jnp.asarray(c) for c in (X, Y, Z)),
                 (jnp.asarray(qX), jnp.asarray(qY)),
                 jnp.asarray(sign.astype(np.float32)),
                 jnp.asarray(active.astype(np.float32)))
    R = [np.asarray(c) for c in R]
    want = [_affine(rec.decode_point(tuple(c[i] for c in R)))
            for i in range(N)]
    assert got_aff == want


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_complete_add_matches_ec32_rows(form):
    """Site 7's row layout: (n, KP) coordinate rows through EC32Ctx.add,
    the same RCB15 body as EC32Ctx._add_pallas, against K2's plain
    version; P = Q, P = -Q and identities included."""
    rcfg, tcurve, q_pts, acc_pts, _, _, _ = _setup(form, 8)
    k = N // 8
    P_pts = list(acc_pts)
    Q_pts = list(q_pts)
    Q_pts[2 * k:3 * k] = P_pts[2 * k:3 * k]                  # P = Q
    Q_pts[3 * k:4 * k] = [-p for p in P_pts[3 * k:4 * k]]    # P = -Q
    Q_pts[4 * k:5 * k] = [rcfg.g1.infinity()] * k            # Q = O
    ec = tec.ec_ctx(tcurve)
    flag = np.zeros(N, dtype=bool)
    _, P, _ = _port_rows(tcurve, P_pts, P_pts, flag)
    _, Q, _ = _port_rows(tcurve, Q_pts, Q_pts, flag)
    got = [_affine(ec.decode_point(r.numpy()))
           for r in ec.complete_add_plain(P, Q)]
    assert got == [_affine(a + b) for a, b in zip(P_pts, Q_pts)]
    rec = EC32Ctx(rcfg.g1)
    R = rec.add(tuple(jnp.asarray(c) for c in rec.encode_points(P_pts)),
                tuple(jnp.asarray(c) for c in rec.encode_points(Q_pts)))
    R = [np.asarray(c) for c in R]
    assert got == [_affine(rec.decode_point(tuple(c[i] for c in R)))
                   for i in range(N)]


@pytest.mark.parametrize("form", FORMS[1:3], ids=IDS[1:3])
def test_madd_from_identity_equals_k1_at_t1(form):
    """K3 from the identity and K1 with T = 1 (loads = active) fold the
    same signed rows: the same limbs, flagged and inactive rows left at
    the identity."""
    _, tcurve, q_pts, _, sign, active, flagged = _setup(form, 9)
    ec, _, q = _port_rows(tcurve, q_pts, q_pts, flagged)
    ident = ec.identity((N,), "cpu")
    got = ec.madd_plain(ident, q, torch.from_numpy(sign),
                        torch.from_numpy(active))
    perm = (np.arange(N, dtype=np.uint32)
            | (sign.astype(np.uint32) << 31)).view(np.int32)
    k1 = ec.madd_accumulate_plain(q, torch.from_numpy(perm.reshape(1, 1, N)),
                                  torch.from_numpy(active.reshape(1, N)))
    assert torch.equal(k1.reshape(got.shape), got)
    assert torch.equal(ident, ec.identity((N,), "cpu"))       # untouched


def test_madd_wrapper_updates_in_place_on_cpu():
    """On a CPU tensor the wrapper runs the plain version into acc and
    counts a plain call, no launch; bad shapes raise."""
    _, tcurve, q_pts, acc_pts, sign, active, flagged = _setup(FORMS[2], 10)
    ec, acc, q = _port_rows(tcurve, q_pts, acc_pts, flagged)
    s, a = torch.from_numpy(sign), torch.from_numpy(active)
    want = ec.madd_plain(acc, q, s, a)
    tec.reset_launch_counts()
    out = ec.madd(acc, q, s, a)
    assert out is acc and torch.equal(acc, want)
    assert tec.plain_counts() == {("madd", tcurve.name): 1}
    assert tec.launch_counts() == {}
    with pytest.raises(ValueError, match="q must be"):
        ec.madd(acc, q[:-1], s, a)
    with pytest.raises(ValueError, match="sign"):
        ec.madd(acc, q, s[:-1], a)
