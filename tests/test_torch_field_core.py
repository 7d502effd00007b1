"""The kernels' field core and point formulas (pcd_tpu_torch/csrc/field.cuh,
ec.cuh) against the port's plain torch versions, on the CPU: the host build
csrc/host_check.cpp runs the carry-chain instruction sequence of the card
in emulation (csrc/ptx.cuh), so the Fp^D product and both RCB15 formulas
are checked limb for limb without a card, in every field form, on random
field elements and the edge values 0, 1, p - 1 and the identity; so are
K8's Fp^D inversion, its affine store and its whole tile body.  The
plain versions are themselves held to pcd_tpu by test_torch_field_ec.py.
Port-only: nothing here imports JAX.
"""

import os
import random
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops.ec import ec_ctx  # noqa: E402
from pcd_tpu_torch.ops.field import NLIMB, ints_to_limbs  # noqa: E402
from pcd_tpu_torch.ops.field import limbs_to_ints  # noqa: E402
from pcd_tpu_torch.ops.kernels import CSRC  # noqa: E402

FORMS = [("toy_cycle", "main", "g1"), ("toy_cycle", "main", "g2"),
         ("toy_cycle", "help", "g2"), ("mnt_cycle", "main", "g1"),
         ("mnt_cycle", "main", "g2"), ("mnt_cycle", "help", "g1"),
         ("mnt_cycle", "help", "g2")]
IDS = ["-".join(f) for f in FORMS]
N = 48


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    exe = str(tmp_path_factory.mktemp("field_core") / "host_check")
    subprocess.run([gxx, "-O1", "-std=c++17", "-o", exe,
                    os.path.join(CSRC, "host_check.cpp")], check=True,
                   capture_output=True, timeout=300)
    return exe


def _run(exe, ec, op, *arrays):
    n = arrays[0].shape[0]
    req = (np.array([op, ec.d, n], dtype=np.int32).tobytes()
           + ec.kconsts.tobytes()
           + np.concatenate([a.reshape(n, -1).view(np.uint32)
                             for a in arrays], axis=1).tobytes())
    out = subprocess.run([exe], input=req, capture_output=True, check=True,
                         timeout=120).stdout
    return np.frombuffer(out, dtype=np.uint32).view(np.int32)


def _elems(ec, rng, shape):
    """Random Montgomery limbs of Fp^d, (*shape, d, 10) int32, with the
    edge values 0, 1 and p - 1 in the first rows."""
    p, d = ec.f.p, ec.d
    vals = [int.from_bytes(rng.bytes(40), "little") % p
            for _ in range(int(np.prod(shape)) * d)]
    vals[:3 * d] = [0] * d + [1] * d + [p - 1] * d
    mont = [v * ec.f.r % p for v in vals]
    return ints_to_limbs(mont).view(np.int32).reshape(
        tuple(shape) + (d, NLIMB))


def _ec(form):
    cyc, side, grp = form
    return ec_ctx(getattr(getattr(getattr(TM, cyc)(), side), grp))


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_fe_mul_matches_plain(form, host_check):
    ec = _ec(form)
    rng = np.random.default_rng(1)
    a, b = _elems(ec, rng, (N,)), _elems(ec, rng, (N,))
    f = ec.f

    def plain(x):
        return f.to_plain(torch.from_numpy(x)).movedim(-1, 1)

    want = f.from_plain(f.mul(plain(a), plain(b)).movedim(1, -1)).numpy()
    got = _run(host_check, ec, 0, a, b).reshape(want.shape)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_rcb_add_matches_plain(form, host_check):
    """K2's and K4's formula: P + Q on arbitrary coordinates, P = Q, and
    either side the identity."""
    ec = _ec(form)
    rng = np.random.default_rng(2)
    P, Q = _elems(ec, rng, (N, 3)), _elems(ec, rng, (N, 3))
    Q[3:6] = P[3:6]
    ident = ec.identity((3,), "cpu").numpy()
    P[6:9], Q[9:12] = ident, ident
    want = ec.complete_add_plain(torch.from_numpy(P),
                                 torch.from_numpy(Q)).numpy()
    got = _run(host_check, ec, 1, P, Q).reshape(want.shape)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_rcb_madd_matches_plain(form, host_check):
    """K1's and K3's formula: P + (x, y), P the identity in some rows."""
    ec = _ec(form)
    rng = np.random.default_rng(3)
    P, q = _elems(ec, rng, (N, 3)), _elems(ec, rng, (N, 2))
    q[:, 0, 0, NLIMB - 1] &= 0x7FFFFFFF      # no infinity flag
    P[4:8] = ec.identity((4,), "cpu").numpy()
    want = ec.madd_plain(torch.from_numpy(P), torch.from_numpy(q),
                         torch.zeros(N, dtype=torch.int32),
                         torch.ones(N, dtype=torch.int32)).numpy()
    got = _run(host_check, ec, 2, P, q[:, 0], q[:, 1]).reshape(want.shape)
    assert np.array_equal(got, want)


# -- K2 and K3 over a group of lanes (csrc/ec_group.cuh) -------------------

@pytest.fixture(scope="module")
def shapes(host_check):
    """The kernels' launch shapes as csrc/ec_group.cuh declares them (host
    op 6): K2's lanes an add by D (0: one thread through rcb_add, held to
    the plain version above; its group add is then checked at 3 lanes),
    K3's lanes an add, threads a block and rows listed at once; K8's
    splits a scalar and lanes an add by D."""
    out = subprocess.run([host_check], input=np.array(
        [6, 1, 0], dtype=np.int32).tobytes(), capture_output=True,
        check=True, timeout=60).stdout
    v = np.frombuffer(out, dtype=np.int32).tolist()
    return {"k2_g": {1: v[0], 2: v[1], 3: v[2]}, "k3_g": v[6],
            "k3_threads": v[7], "k3_tile": v[9], "k8_s": v[10],
            "k8_g": {1: v[11], 2: v[12], 3: v[13]}}


def _run_grp(exe, ec, op, G, *arrays):
    """Ops 3-5 of host_check: (small-a form ran, results)."""
    n = arrays[0].shape[0]
    req = (np.array([op, ec.d, n], dtype=np.int32).tobytes()
           + ec.kconsts.tobytes() + np.int32(G).tobytes()
           + ec.ksmall.tobytes()
           + np.concatenate([a.reshape(n, -1).view(np.uint32)
                             for a in arrays], axis=1).tobytes())
    out = subprocess.run([exe], input=req, capture_output=True, check=True,
                         timeout=120).stdout
    res = np.frombuffer(out, dtype=np.uint32).view(np.int32)
    return bool(res[0]), res[1:]


def _add_operands(ec, rng):
    """P, Q with random coordinates (0, 1 and p - 1 among them), then
    P = Q, P = -Q, Q the identity, P the identity, both the identity."""
    P, Q = _elems(ec, rng, (N, 3)), _elems(ec, rng, (N, 3))
    f = ec.f
    Q[3:6] = P[3:6]
    Q[6:9] = P[6:9]
    Q[6:9, 1] = f.from_plain(f.neg(f.to_plain(torch.from_numpy(
        np.ascontiguousarray(P[6:9, 1]))))).numpy()
    ident = ec.identity((3,), "cpu").numpy()
    Q[9:12], P[12:15] = ident, ident
    P[15], Q[15] = ident[0], ident[0]
    return P, Q


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_grp_add_matches_plain(form, host_check, shapes):
    """K2's add over a group of as many lanes as its shape gives D equals
    the plain complete add limb for limb; the real curves run the small-a
    form, the toy ones the full products."""
    ec = _ec(form)
    assert ec.small_a == (form[0] == "mnt_cycle")
    P, Q = _add_operands(ec, np.random.default_rng(11))
    want = ec.complete_add_plain(torch.from_numpy(P),
                                 torch.from_numpy(Q)).numpy()
    G = shapes["k2_g"][ec.d] or 3
    ran, got = _run_grp(host_check, ec, 3, G, P, Q)
    assert ran == ec.small_a
    assert np.array_equal(got.reshape(want.shape), want)


def _madd_operands(ec, rng):
    """acc, q, sign: random coordinates, acc the identity in some rows,
    acc = (x : y : 1) with q's sign clear (a doubling) and set (P - P)."""
    P, q = _elems(ec, rng, (N, 3)), _elems(ec, rng, (N, 2))
    q[:, 0, 0, NLIMB - 1] &= 0x7FFFFFFF      # no infinity flag
    P[4:8] = ec.identity((4,), "cpu").numpy()
    one = ec.identity((1,), "cpu").numpy()[0, 1]
    P[8:12, :2] = q[8:12]
    P[8:12, 2] = one
    sign = rng.integers(0, 2, N).astype(np.int32)
    sign[8:10], sign[10:12] = 0, 1
    return P, q, sign


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_grp_madd_matches_plain(form, host_check, shapes):
    """K3's mixed add over a group of its shape's lanes, Y negated by the
    sign, equals the plain masked mixed add limb for limb."""
    ec = _ec(form)
    P, q, sign = _madd_operands(ec, np.random.default_rng(12))
    want = ec.madd_plain(torch.from_numpy(P), torch.from_numpy(q),
                         torch.from_numpy(sign),
                         torch.ones(N, dtype=torch.int32)).numpy()
    ran, got = _run_grp(host_check, ec, 4, shapes["k3_g"], P, q[:, 0],
                        q[:, 1],
                        sign.reshape(N, 1))
    assert ran == ec.small_a
    assert np.array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_mul_a_matches_product(form, host_check):
    """fe_mul_a against the full Montgomery products by a and by a^2: the
    scalings by 2 and 4 (MNT4 G1), 11 and 121 (MNT6 G1), (34, 0) and
    (1156, 0) (MNT4 G2), 11 u^2 and 605 u (MNT6 G2); the products
    themselves on the toy curves."""
    ec = _ec(form)
    f = ec.f
    t = _elems(ec, np.random.default_rng(13), (N,))
    ran, got = _run_grp(host_check, ec, 5, 1, t)
    assert ran == ec.small_a
    got = got.reshape(N, 2, ec.d, NLIMB)
    tp = f.to_plain(torch.from_numpy(t)).movedim(-1, 1)
    A, _, A2 = ec._consts_plain("cpu")
    for which, c in enumerate((A, A2)):
        want = f.from_plain(f.mul(c.expand_as(tp), tp).movedim(1, -1))
        assert np.array_equal(got[:, which], want.numpy()), which


@pytest.mark.parametrize("G", [1, 2, 3, 6])
@pytest.mark.parametrize("form", [FORMS[3], FORMS[6]], ids=[IDS[3], IDS[6]])
def test_grp_sizes_match_plain(form, G, host_check):
    """Any group size deals the same jobs: both adds at G = 1, 2, 3 and
    6 (the sweep's sizes)."""
    ec = _ec(form)
    rng = np.random.default_rng(14)
    P, Q = _add_operands(ec, rng)
    want = ec.complete_add_plain(torch.from_numpy(P),
                                 torch.from_numpy(Q)).numpy()
    _, got = _run_grp(host_check, ec, 3, G, P, Q)
    assert np.array_equal(got.reshape(want.shape), want)
    A, q, sign = _madd_operands(ec, rng)
    want = ec.madd_plain(torch.from_numpy(A), torch.from_numpy(q),
                         torch.from_numpy(sign),
                         torch.ones(N, dtype=torch.int32)).numpy()
    _, got = _run_grp(host_check, ec, 4, G, A, q[:, 0], q[:, 1],
                      sign.reshape(N, 1))
    assert np.array_equal(got.reshape(want.shape), want)


def _deal_k3(live, grid, shapes):
    """K3's row dealing (csrc/madd.cu madd_kernel), by the kernel's index
    formulas: block b takes rows [b r, min(n, (b + 1) r)), r = ceil(n /
    grid); each tile of K3_TILE rows is listed in sweeps of one row a
    thread, row base + s + t on thread t, its entry at the running length
    plus the counts of the warps before it plus the live lanes below it
    in its warp's ballot; the block's group gi takes entries gi, gi +
    ngrp, ...  Returns [(block, group, row)] and the longest list."""
    tile, threads = shapes["k3_tile"], shapes["k3_threads"]
    n = len(live)
    ngrp = threads // 32 * (32 // shapes["k3_g"])
    rpb = -(-n // grid)
    dealt, longest = [], 0
    for b in range(grid):
        r0, r1 = b * rpb, min(n, (b + 1) * rpb)
        for base in range(r0, r1, tile):
            lst = [None] * tile
            length = 0
            for s in range(0, tile, threads):
                if base + s >= r1:
                    break
                rows = base + s + np.arange(threads)
                lv = np.array([i < r1 and bool(live[i]) for i in rows])
                ballots = [int(sum(1 << lane for lane in range(32)
                                   if lv[w * 32 + lane]))
                           for w in range(threads // 32)]
                counts = [bin(x).count("1") for x in ballots]
                for t in np.flatnonzero(lv):
                    w, lane = divmod(int(t), 32)
                    at = (length + sum(counts[:w])
                          + bin(ballots[w] & ((1 << lane) - 1)).count("1"))
                    assert lst[at] is None
                    lst[at] = s + int(t)
                length += sum(counts)
            longest = max(longest, length)
            for e in range(length):
                dealt.append((b, e % ngrp, base + lst[e]))
    return dealt, longest


@pytest.mark.parametrize("case", ["all_active", "none_active", "all_flagged",
                                  "random", "ragged"])
def test_madd_deal_rows(case, shapes):
    """K3 deals every active, unflagged row to exactly one group and no
    other row, each group's rows in index order, at several grids."""
    tile = shapes["k3_tile"]
    rng = np.random.default_rng(15)
    n = 3 * tile + 77 if case == "ragged" else 2 * tile
    active = np.ones(n, bool)
    flagged = np.zeros(n, bool)
    if case == "none_active":
        active[:] = False
    elif case == "all_flagged":
        flagged[:] = True
    elif case in ("random", "ragged"):
        active = rng.random(n) >= 0.25
        flagged = rng.random(n) < 0.1
    live = active & ~flagged
    for grid in (1, 3, 7, -(-n // 40)):
        dealt, longest = _deal_k3(live, grid, shapes)
        rows = [r for _, _, r in dealt]
        assert sorted(rows) == np.flatnonzero(live).tolist(), grid
        assert longest <= tile
        per = {}
        for b, g, r in dealt:
            per.setdefault((b, g), []).append(r)
        assert all(v == sorted(v) for v in per.values())


# -- K8's inversion, affine store and tile body (csrc/field.cuh fe_inv,
# csrc/ec.cuh pt_store_affine, csrc/fixed_base.cuh) ------------------------

@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_fe_inv_matches_plain(form, host_check):
    """fe_inv (host op 7) against FieldCtx.inv_plain, limb for limb, with
    0 -> 0 and 1 and p - 1 among the inputs; and a a^-1 = 1."""
    ec = _ec(form)
    f = ec.f
    a = _elems(ec, np.random.default_rng(21), (16,))
    got = _run(host_check, ec, 7, a).reshape(a.shape)
    want = f.from_plain(f.inv_plain(f.to_plain(torch.from_numpy(a))
                                    .movedim(-1, 1)).movedim(1, -1)).numpy()
    assert np.array_equal(got, want)
    prod = _run(host_check, ec, 0, a[1:], got[1:]).reshape(a[1:].shape)
    one = ints_to_limbs([f.r] + [0] * (ec.d - 1)).view(np.int32)
    assert np.array_equal(prod, np.broadcast_to(one, prod.shape))
    assert not got[0].any()


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_pt_store_affine_matches_host_curve(form, host_check):
    """pt_store_affine (host op 8): projective points (multiples of the
    generator with a random Z, and the identity) to canonical affine
    coordinates, the identity zero with bit 31 of x's top limb set."""
    ec = _ec(form)
    curve, f = ec.curve, ec.f
    cyc, side, grp = form
    gen = getattr(getattr(getattr(TM, cyc)(), side), grp + "_gen")
    rng = np.random.default_rng(22)
    pts = [gen * k for k in (1, 2, 5, 1234567)] + [curve.infinity()]
    zs = _elems(ec, rng, (len(pts),))
    zs[0] = ints_to_limbs([f.r] + [0] * (ec.d - 1)).view(np.int32)
    P = np.zeros((len(pts), 3, ec.d, NLIMB), dtype=np.int32)
    for i, pt in enumerate(pts):
        if pt.is_infinity():
            P[i, 1] = zs[0]                     # (0 : 1 : 0)
            continue
        for k, c in enumerate((pt.x, pt.y)):
            P[i, k] = ints_to_limbs([v * f.r % f.p for v in _coeffs(c)]
                                    ).view(np.int32)
        P[i, 2] = zs[i]
        P[i, :2] = _run(host_check, ec, 0, P[i, :2],
                        np.broadcast_to(zs[i], P[i, :2].shape)
                        ).reshape(P[i, :2].shape)
    got = _run(host_check, ec, 8, P).reshape(len(pts), 2, ec.d, NLIMB)
    for i, pt in enumerate(pts):
        if pt.is_infinity():
            rest = got[i].reshape(-1).copy()
            assert rest[NLIMB - 1] == np.int32(-(1 << 31))
            rest[NLIMB - 1] = 0
            assert not rest.any()
            continue
        vals = limbs_to_ints(got[i])
        assert vals == _coeffs(pt.x) + _coeffs(pt.y), i


def _coeffs(e):
    return [int(c.n) for c in (e.to_prime_coeffs()
                               if hasattr(e, "to_prime_coeffs") else [e])]


K8_FORMS = [FORMS[0], FORMS[1], FORMS[2], FORMS[3], FORMS[4], FORMS[6]]


@pytest.mark.parametrize("split", ["one", "most"])
@pytest.mark.parametrize("form", K8_FORMS,
                         ids=[IDS[FORMS.index(f)] for f in K8_FORMS])
def test_fb_point_matches_plain(form, split, host_check, shapes):
    """K8's body (host op 9: the split windows on the group add, their
    join, the tile's product tree and one inversion, the stores) at its
    lanes an add for D, at one split a scalar and at the most the launch
    may pick (K8_SHAPE's, at least 2), against
    FixedBaseDevice.mul_digits_plain on the same window table and digits,
    in tiles of four scalars: a tile with 0, 1, r - 1 and every low byte
    0xFF, a tile of zeros only, a tile with both top-window wraps (the
    last add cancels the sum to the identity, or doubles it) and random
    scalars, and a ragged tile of two.  The toy curves run the full
    products by a, the real ones the small-a form."""
    from pcd_tpu_torch.ops.fixed_base import fixed_base_device

    ec = _ec(form)
    cyc, side, grp = form
    cfg = getattr(getattr(TM, cyc)(), side)
    fb = fixed_base_device(ec.curve, getattr(cfg, grp + "_gen"),
                           cfg.Fr.BITS)
    r, top = cfg.Fr.MODULUS, 8 * (fb.nwin - 1)
    rng = random.Random(9)
    cancel, double = (next(low + (d << top) for d in range(1, 256)
                           for low in (f(d << top) % r,) if low < 1 << top)
                      for f in (lambda x: -x, lambda x: x))
    sc = ([0, 1, r - 1, (1 << top) - 1] + [0] * 4
          + [cancel, rng.randrange(r), double, rng.randrange(r)]
          + [rng.randrange(r) for _ in range(2)])
    S = 1 if split == "one" else max(2, shapes["k8_s"])
    G = shapes["k8_g"][ec.d]
    dg = fb.digits_from_ints(sc)
    want = fb.mul_digits_plain(torch.from_numpy(dg)).numpy()
    req = (np.array([9, ec.d, len(sc)], dtype=np.int32).tobytes()
           + ec.kconsts.tobytes() + np.int32(G).tobytes()
           + ec.ksmall.tobytes()
           + np.array([S, 4, fb.nwin], dtype=np.int32).tobytes()
           + fb.table_host.tobytes() + np.ascontiguousarray(dg.T).tobytes())
    out = subprocess.run([host_check], input=req, capture_output=True,
                         check=True, timeout=120).stdout
    res = np.frombuffer(out, dtype=np.int32)
    assert bool(res[0]) == ec.small_a
    got = res[1:].reshape(want.shape)
    assert np.array_equal(got, want)
    inf = got[:, 0, 0, NLIMB - 1] == np.int32(-(1 << 31))
    assert inf[[0, 4, 5, 6, 7, 8]].all() and inf.sum() == 6   # s = 0 mod r
