"""The port's CUDA kernels against their plain torch versions, on an
NVIDIA card (marker `cuda`; every case skips without one).  This file
imports nothing of JAX or of the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The tolerance is exact equality of the limbs: modular integer arithmetic.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu_torch.curves import models as M  # noqa: E402
from pcd_tpu_torch.msm.host import fixed_base_many  # noqa: E402
from pcd_tpu_torch.msm.host import msm as host_msm  # noqa: E402
from pcd_tpu_torch.native import _points_to_arrays  # noqa: E402
from pcd_tpu_torch.ops.ec import ec_ctx, launch_counts  # noqa: E402
from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx  # noqa: E402

FORMS = [("toy_cycle", "main", "g1"), ("toy_cycle", "help", "g2"),
         ("mnt_cycle", "main", "g1"), ("mnt_cycle", "main", "g2"),
         ("mnt_cycle", "help", "g1"), ("mnt_cycle", "help", "g2")]
IDS = ["-".join(f) for f in FORMS]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _table(form, n, seed):
    cyc, side, grp = form
    cfg = getattr(getattr(M, cyc)(), side)
    curve, gen = getattr(cfg, grp), getattr(cfg, grp + "_gen")
    rng = np.random.default_rng(seed)
    pts = fixed_base_many(gen, [int(s) for s in rng.integers(1, 1 << 40, n)],
                          cfg.Fr.BITS)
    pts[1] = curve.infinity()
    xs, ys, inf = _points_to_arrays(pts, curve.F.extension_degree_over_prime())
    return cfg, curve, pts, xs, ys, inf.astype(bool)


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_kernels_match_plain(form, cuda_device):
    nwin, T, L, m = 3, 5, 256, 64
    _, curve, _, xs, ys, inf = _table(form, m, 1)
    ec = ec_ctx(curve)
    table = torch.from_numpy(ec.table_from_u64(xs, ys, inf)).to(cuda_device)
    rng = np.random.default_rng(2)
    perm = (rng.integers(0, m, (nwin, T, L)) | (rng.integers(
        0, 2, (nwin, T, L)) << 31)).astype(np.uint32).view(np.int32)
    perm = torch.from_numpy(perm).to(cuda_device)
    loads = torch.from_numpy(rng.integers(0, T + 1, (nwin, L)).astype(
        np.int32)).to(cuda_device)
    before = launch_counts().get(("madd_accumulate", curve.name), 0)
    acc = ec.madd_accumulate(table, perm, loads)
    assert launch_counts()[("madd_accumulate", curve.name)] == before + 1
    assert torch.equal(acc, ec.madd_accumulate_plain(table, perm, loads))
    P = acc.reshape(-1, 3, ec.d, 10)
    Q = P.flip(0).contiguous()
    Q[:7] = P[:7]
    Q[7:9] = ec.identity((2,), cuda_device)
    assert torch.equal(ec.add(P, Q), ec.complete_add_plain(P, Q))


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_stream_msm_on_card(form, cuda_device):
    """A whole stream MSM on the card equals the C++ Pippenger."""
    cfg, curve, pts, xs, ys, inf = _table(form, 300, 3)
    sctx = StreamMSMCtx(curve, cfg.Fr.BITS, c=6, lanes=128)
    rng = np.random.default_rng(4)
    r = cfg.Fr.MODULUS
    scalars = [int.from_bytes(rng.bytes(40), "little") % r
               for _ in range(len(pts))]
    table = sctx.table_from_limbs(xs, ys, inf, cuda_device)
    limbs = sctx.limb_rows(scalars, (cfg.Fr.BITS + 63) // 64 * 8)
    assert sctx.msm_limbs(table, limbs) == host_msm(pts, scalars)


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_bucket_finish_matches_plain(form, cuda_device):
    """K4 on K1's lanes for a C++ schedule with a long run (a third of the
    scalars equal), an empty window and P, -P rows, one launch."""
    cfg, curve, pts, xs, ys, inf = _table(form, 600, 7)
    sctx = StreamMSMCtx(curve, cfg.Fr.BITS, c=8, lanes=256)
    ec = sctx.ec
    table = sctx.table_from_limbs(xs, ys, inf, cuda_device)
    table[3] = table[2]
    table[3, 1] = ec.f.from_plain(ec.f.neg(ec.f.to_plain(table[2, 1])))
    rng = np.random.default_rng(8)
    r = cfg.Fr.MODULUS
    scalars = [int.from_bytes(rng.bytes(40), "little") % r
               for _ in range(len(pts))]
    scalars[3] = scalars[2]
    scalars[100:300] = [scalars[100]] * 200
    limbs = sctx.limb_rows(scalars, (cfg.Fr.BITS + 63) // 64 * 8)
    sched = sctx.schedule_native(limbs)
    perm, loads, bidx, runrem = sched.on(cuda_device)
    accs = ec.madd_accumulate(table, perm, loads)
    before = launch_counts().get(("bucket_finish", curve.name), 0)
    got = ec.bucket_finish(accs, bidx, runrem)
    assert launch_counts()[("bucket_finish", curve.name)] == before + 1
    assert torch.equal(got, ec.bucket_finish_plain(accs, bidx, runrem))
    old = sctx.finish_steps(accs, bidx, runrem, sched.maxrun).cpu().numpy()
    g = got.cpu().numpy()
    for w in range(sctx.nwin):
        assert ec.decode_point(g[w]) == ec.decode_point(old[w]), w


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_bucket_finish_multi_block(form, cuda_device):
    """K4 at the chains' c = 12: 2048 buckets a window in 16 blocks, so
    the window's last block combines the others.  Runs of several lanes
    on both sides of a block edge (buckets 128 and 129)."""
    cfg, curve, pts, xs, ys, inf = _table(form, 600, 9)
    sctx = StreamMSMCtx(curve, cfg.Fr.BITS, c=12, lanes=1024)
    ec = sctx.ec
    table = sctx.table_from_limbs(xs, ys, inf, cuda_device)
    rng = np.random.default_rng(10)
    r = cfg.Fr.MODULUS
    scalars = [int.from_bytes(rng.bytes(40), "little") % r
               for _ in range(len(pts))]
    for i in range(100, 300):
        scalars[i] = (scalars[i] >> 12 << 12) + (128 if i < 200 else 129)
    limbs = sctx.limb_rows(scalars, (cfg.Fr.BITS + 63) // 64 * 8)
    sched = sctx.schedule_native(limbs)
    assert int(sched.runrem[0, sched.bidx[0, 127]]) > 1
    assert int(sched.runrem[0, sched.bidx[0, 128]]) > 1
    perm, loads, bidx, runrem = sched.on(cuda_device)
    accs = ec.madd_accumulate(table, perm, loads)
    got = ec.bucket_finish(accs, bidx, runrem)
    assert torch.equal(got, ec.bucket_finish_plain(accs, bidx, runrem))
    old = sctx.finish_steps(accs, bidx, runrem, sched.maxrun).cpu().numpy()
    g = got.cpu().numpy()
    for w in range(sctx.nwin):
        assert ec.decode_point(g[w]) == ec.decode_point(old[w]), w


G1_FORMS = [f for f in FORMS if f[2] == "g1"] + [("toy_cycle", "help", "g1")]
G1_IDS = ["-".join(f) for f in G1_FORMS]


def _madd_inputs(form, device, n=300, m=64):
    """K3 operands: acc from K1's outputs with a tenth set to the identity
    and a tenth to Q (Z = 1); q gathered from a table with a flagged row;
    mixed signs, about a quarter of the rows inactive."""
    _, curve, _, xs, ys, inf = _table(form, m, 5)
    ec = ec_ctx(curve)
    table = torch.from_numpy(ec.table_from_u64(xs, ys, inf)).to(device)
    rng = np.random.default_rng(6)
    idx = rng.integers(0, m, n).astype(np.uint32)
    sign = rng.integers(0, 2, n).astype(np.int32)
    active = (rng.random(n) >= 0.25).astype(np.int32)
    perm = torch.from_numpy(rng.integers(0, m, (1, 2, n)).astype(np.int32))
    acc = ec.madd_accumulate(table, perm.to(device), torch.full(
        (1, n), 2, dtype=torch.int32, device=device))[0].contiguous()
    q = table[torch.from_numpy(idx.astype(np.int64)).to(device)].contiguous()
    k = n // 10
    acc[:2 * k] = ec.identity((2 * k,), device)
    acc[k:2 * k, :2] = q[k:2 * k]
    acc[k:2 * k, 0, 0, 9] &= 0x7FFFFFFF
    acc[k:2 * k, 2] = acc[:k, 1]
    return (ec, table, acc, q, idx, torch.from_numpy(sign).to(device),
            torch.from_numpy(active).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("form", G1_FORMS, ids=G1_IDS)
def test_madd_matches_plain(form, cuda_device):
    ec, _, acc, q, _, sign, active = _madd_inputs(form, cuda_device)
    want = ec.madd_plain(acc, q, sign, active)
    before = launch_counts().get(("madd", ec.name), 0)
    got = ec.madd(acc, q, sign, active)
    assert got is acc
    assert launch_counts()[("madd", ec.name)] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(acc, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", G1_FORMS, ids=G1_IDS)
def test_madd_equals_k1_at_t1(form, cuda_device):
    """From the identity, K3 and K1 with T = 1 (loads = active) give the
    same limbs."""
    ec, table, _, q, idx, sign, active = _madd_inputs(form, cuda_device)
    n = q.shape[0]
    got = ec.madd(ec.identity((n,), cuda_device), q, sign, active)
    perm = (idx | (sign.cpu().numpy().astype(np.uint32) << 31)).view(
        np.int32)
    k1 = ec.madd_accumulate(table, torch.from_numpy(perm.reshape(1, 1, n))
                            .to(cuda_device), active.reshape(1, n))
    assert torch.equal(k1.reshape(got.shape), got)


SIZES = [1, 31, 127, 129, 204_805]
MNT_FORMS = [f for f in FORMS if f[0] == "mnt_cycle"]
MNT_IDS = ["-".join(f) for f in MNT_FORMS]


def _rand_elems(ec, shape, rng):
    """Random Montgomery limbs below p, (*shape, d, 10) int32: the limbs
    under p's top nonzero limb uniform, that one below it."""
    top = int(np.flatnonzero(ec.f.p_limbs)[-1])
    out = rng.integers(0, 1 << 32, tuple(shape) + (ec.d, 10),
                       dtype=np.uint64)
    out[..., top] = rng.integers(0, int(ec.f.p_limbs[top]),
                                 tuple(shape) + (ec.d,), dtype=np.uint64)
    out[..., top + 1:] = 0
    return out.astype(np.uint32).view(np.int32)


def _ec_of(form):
    cyc, side, grp = form
    return ec_ctx(getattr(getattr(getattr(M, cyc)(), side), grp))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("form", MNT_FORMS, ids=MNT_IDS)
def test_complete_add_sizes_match_plain(form, n, cuda_device):
    """K2 (a group of lanes an add, the small-a form) at sizes around a
    group, a warp, a block and phase 2's 204,800, with P = Q, P = -Q and
    identities among random coordinates: one launch, exact."""
    ec = _ec_of(form)
    assert ec.small_a
    rng = np.random.default_rng(n)
    P = _rand_elems(ec, (n, 3), rng)
    Q = _rand_elems(ec, (n, 3), rng)
    k = max(n // 8, 1)
    Q[:k] = P[:k]
    P, Q = (torch.from_numpy(x).to(cuda_device) for x in (P, Q))
    if n > 4 * k:
        Q[k:2 * k] = P[k:2 * k]
        Q[k:2 * k, 1] = ec.f.from_plain(ec.f.neg(ec.f.to_plain(
            P[k:2 * k, 1])))
        Q[2 * k:3 * k] = ec.identity((k,), cuda_device)
        P[3 * k:4 * k] = ec.identity((k,), cuda_device)
    before = launch_counts().get(("complete_add", ec.name), 0)
    got = ec.add(P, Q)
    assert launch_counts()[("complete_add", ec.name)] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ec.complete_add_plain(P, Q))


MADD_CASES = ["random", "none_active", "all_flagged"]


def _madd_rand(ec, n, case, device, rng):
    """K3 operands of random coordinates: acc, q (flag bits clear but in
    all_flagged), sign, active (a quarter clear; none in none_active), and
    a tenth of the accumulators the identity."""
    acc = _rand_elems(ec, (n, 3), rng)
    q = _rand_elems(ec, (n, 2), rng)
    flagged = rng.random(n) < (1.0 if case == "all_flagged" else 0.05)
    q[flagged, 0, 0, 9] |= np.int32(-(1 << 31))
    sign = rng.integers(0, 2, n).astype(np.int32)
    active = (rng.random(n) >= 0.25).astype(np.int32)
    if case == "none_active":
        active[:] = 0
    acc = torch.from_numpy(acc).to(device)
    acc[:n // 10] = ec.identity((n // 10,), device)
    return (acc, torch.from_numpy(q).to(device),
            torch.from_numpy(sign).to(device),
            torch.from_numpy(active).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MADD_CASES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("form", [f for f in MNT_FORMS if f[2] == "g1"],
                         ids=[i for f, i in zip(MNT_FORMS, MNT_IDS)
                              if f[2] == "g1"])
def test_madd_sizes_match_plain(form, n, case, cuda_device):
    """K3 over groups of lanes, the active unflagged rows dealt per block:
    exact against its plain version in place, rows it keeps untouched."""
    ec = _ec_of(form)
    rng = np.random.default_rng(n + 1)
    acc, q, sign, active = _madd_rand(ec, n, case, cuda_device, rng)
    old = acc.clone()
    want = ec.madd_plain(acc, q, sign, active)
    got = ec.madd(acc, q, sign, active)
    torch.cuda.synchronize()
    assert got is acc
    assert torch.equal(acc, want)
    if case != "random":
        assert torch.equal(acc, old)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("form", [f for f in MNT_FORMS if f[2] == "g1"],
                         ids=[i for f, i in zip(MNT_FORMS, MNT_IDS)
                              if f[2] == "g1"])
def test_madd_sizes_equal_k1_at_t1(form, n, cuda_device):
    """From the identity, K3 and K1 with T = 1 (loads = active) give the
    same limbs on real table rows, a flagged row among them."""
    ec, table, _, _, _, _, _ = _madd_inputs(form, cuda_device, n=2, m=64)
    rng = np.random.default_rng(n + 2)
    idx = rng.integers(0, 64, n).astype(np.uint32)
    sign = rng.integers(0, 2, n).astype(np.int32)
    active = torch.from_numpy((rng.random(n) >= 0.25).astype(np.int32)).to(
        cuda_device)
    q = table[torch.from_numpy(idx.astype(np.int64)).to(cuda_device)]
    got = ec.madd(ec.identity((n,), cuda_device), q.contiguous(),
                  torch.from_numpy(sign).to(cuda_device), active)
    perm = (idx | (sign.astype(np.uint32) << 31)).view(np.int32)
    k1 = ec.madd_accumulate(table, torch.from_numpy(perm.reshape(1, 1, n))
                            .to(cuda_device), active.reshape(1, n))
    assert torch.equal(k1.reshape(got.shape), got)


@pytest.mark.cuda
@pytest.mark.parametrize("cyc", ["toy_cycle", "mnt_cycle"])
def test_kzg_stream_at_offset_on_card(cyc, cuda_device):
    """KZG10's stream MSM over rows [offset, offset + n) of an SRS table
    on the card, at the card's windows and lanes: the commit and its
    degree-bound shadow equal the C++ Pippenger on the same rows, one K1
    and one K4 launch each."""
    from pcd_tpu_torch.snark import msm_dispatch
    from pcd_tpu_torch.snark.marlin.kzg import KZG10
    from pcd_tpu_torch.utils.rng import ChaChaRng

    cfg = getattr(M, cyc)().main
    kzg = KZG10(cfg, device="cuda")
    srs = kzg.setup(3000, ChaChaRng(b"kzg on card"))
    rng = np.random.default_rng(8)
    coeffs = [int.from_bytes(rng.bytes(40), "little") % cfg.Fr.MODULUS
              for _ in range(2000)]
    keys = [(k, cfg.g1.name) for k in ("madd_accumulate", "bucket_finish")]
    before = [launch_counts().get(k, 0) for k in keys]
    old = KZG10.STREAM_MIN
    KZG10.STREAM_MIN = 1000
    try:
        comm = kzg.commit(srs, coeffs, degree_bound=2500)
    finally:
        KZG10.STREAM_MIN = old
    assert [launch_counts().get(k, 0) for k in keys] == [b + 2
                                                         for b in before]
    powers = msm_dispatch.host_query(srs, "powers_g1")
    off = 3000 - 2500
    assert comm.c == host_msm(powers.slice(0, 2000), coeffs)
    assert comm.shifted == host_msm(powers.slice(off, off + 2000), coeffs)


def _p1_ctx(carry_win=False):
    """The device scheduler of the chains' 298-bit G1 MSMs at c = 12 (298
    bits: the top window absorbs the carry; 300: it gets a window of its
    own)."""
    from pcd_tpu_torch.ops.msm_stream_dev import DevSchedMSM

    cfg = M.mnt_cycle().main
    sctx = StreamMSMCtx(cfg.g1, 300 if carry_win else cfg.Fr.BITS, c=12,
                        lanes=8192)
    assert sctx.carry_win == carry_win
    return cfg, DevSchedMSM(sctx)


def _p1_scalars(case, cfg, n=1 << 16):
    r = cfg.Fr.MODULUS
    rng = np.random.default_rng(12)
    if case == "all_zero":
        return [0] * n
    if case == "one_bin":
        return [5] * n
    if case == "low_entropy":             # digits in windows 0 and 5 only
        return [(i % 1009) | ((i % 3 + 1) << 60) for i in range(n)]
    if case == "one_scalar":
        n = 1
    elif case == "ragged":                # not a multiple of the tile
        n = 3 * 8192 + 101
    scalars = [int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]
    scalars[:4] = [0, 1, r - 1, (1 << 297) - 1][:n]
    return scalars


@pytest.mark.cuda
@pytest.mark.parametrize("carry_win", [False, True], ids=["absorbed",
                                                          "carry_win"])
def test_sched_digits_match_plain(carry_win, cuda_device):
    """p1_digits on 2^16 298-bit scalars at c = 12 against its plain
    version and the host digits, limb for limb, one launch."""
    from pcd_tpu_torch import native

    cfg, dm = _p1_ctx(carry_win)
    limbs = native.ints_to_limbs(_p1_scalars("dense", cfg))
    W = dm.upload(limbs, cuda_device)
    key = ("p1_digits", dm.form)
    before = launch_counts().get(key, 0)
    mags, signs = dm.digits(W)
    assert launch_counts()[key] == before + 1
    pm, ps = dm.digits_plain(W)
    assert torch.equal(mags.int(), pm) and torch.equal(signs, ps)
    hm, hs = dm.sctx.digits_signed(limbs)
    assert np.array_equal(mags.cpu().numpy(), hm)
    assert np.array_equal(signs.cpu().numpy().astype(bool), hs)


P1_CASES = [("dense", False), ("dense", True), ("all_zero", False),
            ("one_bin", False), ("low_entropy", False),
            ("one_scalar", False), ("ragged", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,carry_win", P1_CASES,
                         ids=[f"{a}-{'cw' if b else 'abs'}"
                              for a, b in P1_CASES])
def test_p1_kernels_match_plain(case, carry_win, cuda_device):
    """The four P1 kernels at c = 12 (2,050 bins), each against its plain
    version on the same inputs and P1 as a whole against the plain P1
    (the digits, a stable torch.sort and a searchsorted), element for
    element; each kernel launched once."""
    from pcd_tpu_torch import native
    from pcd_tpu_torch.ops.msm_stream_dev import P1_KERNELS

    cfg, dm = _p1_ctx(carry_win)
    W = dm.upload(native.ints_to_limbs(_p1_scalars(case, cfg)), cuda_device)
    before = {k: launch_counts().get((k, dm.form), 0) for k in P1_KERNELS}
    order, signs, counts = dm.p1(W)
    assert {k: launch_counts().get((k, dm.form), 0) - before[k]
            for k in P1_KERNELS} == {k: 1 for k in P1_KERNELS}
    want = dm.p1_plain(W)
    for got, w in zip((order, signs, counts), want):
        assert got.dtype == w.dtype and torch.equal(got, w)
    assert not counts[:, -1].any()
    mags, _ = dm.digits(W)
    hist = dm.tile_hist(mags)
    assert torch.equal(hist, dm.hist_plain(mags))
    starts_p, counts_p = dm.scan_plain(hist)
    starts, counts_k = dm.tile_scan(hist)
    assert torch.equal(starts, starts_p) and torch.equal(counts_k, counts_p)
    assert torch.equal(dm.scatter(mags, starts, counts_k),
                       dm.scatter_plain(mags, starts, counts_k))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_p1_overflow_raises_on_card(cuda_device):
    """A scalar wider than 298 bits fills the overflow bin on the card and
    the device schedule raises."""
    from pcd_tpu_torch import native

    cfg, dm = _p1_ctx()
    scalars = _p1_scalars("dense", cfg, 5000)
    scalars[4321] = (1 << 300) - 1
    W = dm.upload(native.ints_to_limbs(scalars), cuda_device)
    _, _, counts = dm.p1(W)
    assert counts[:, -1].tolist() == [0] * (dm.sctx.nwin - 1) + [1]
    assert torch.equal(counts, dm.p1_plain(W)[2])
    with pytest.raises(ValueError, match="scalar_bits"):
        dm.schedule(W)


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_devsched_msm_on_sched_stream(form, cuda_device, monkeypatch):
    """A device-scheduled MSM through msm_dispatch as the provers run it:
    the schedule (upload, P1, histogram fetch, placement) on the owner's
    schedule stream, K1 and K4 on its side stream after the placement's
    event; equals the C++ Pippenger, for host limbs and for device limbs
    computed on the caller's stream."""
    from pcd_tpu_torch.ops.field import upload_limbs
    from pcd_tpu_torch.snark import msm_dispatch

    monkeypatch.setattr(msm_dispatch, "SCHEDULER", "device")
    cfg, curve, pts, xs, ys, inf = _table(form, 3000, 15)
    sctx = StreamMSMCtx(curve, cfg.Fr.BITS, c=8, lanes=256)
    table = sctx.table_from_limbs(xs, ys, inf, cuda_device)
    rng = np.random.default_rng(16)
    r = cfg.Fr.MODULUS
    scalars = [int.from_bytes(rng.bytes(40), "little") % r
               for _ in range(len(pts))]
    limbs = sctx.limb_rows(scalars, 40)           # (n, 5) u64, as z and h
    want = host_msm(pts, scalars)

    class Owner:
        pass

    owner = Owner()
    dev_limbs = upload_limbs(limbs, cuda_device)
    for scal, reads in ((limbs, ()), (dev_limbs, (dev_limbs,))):
        with msm_dispatch.side_stream(owner, cuda_device, reads) as sched:
            assert sched is owner._sched_stream
            s = msm_dispatch.schedule(sctx, scal, cuda_device, sched)
            ws, ev = sctx.window_sums_async(table, s)
        assert sctx.horner_host(sctx.collect(ws, ev), s.act) == want


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_devsched_msm_on_card(form, cuda_device):
    """A device-scheduled MSM on the card equals the C++ Pippenger; its
    schedule equals the host placement law at its T, and low-entropy
    scalars leave windows out."""
    from pcd_tpu_torch.ops.msm_stream_dev import DevSchedMSM

    cfg, curve, pts, xs, ys, inf = _table(form, 600, 13)
    sctx = StreamMSMCtx(curve, cfg.Fr.BITS, c=8, lanes=256)
    dm = DevSchedMSM(sctx)
    table = sctx.table_from_limbs(xs, ys, inf, cuda_device)
    rng = np.random.default_rng(14)
    r = cfg.Fr.MODULUS
    dense = [int.from_bytes(rng.bytes(40), "little") % r
             for _ in range(len(pts))]
    sparse = [(i % 5) | (3 << 16) for i in range(len(pts))]
    for scalars in (dense, sparse):
        limbs = sctx.limb_rows(scalars, (cfg.Fr.BITS + 63) // 64 * 8)
        assert dm.msm_limbs(table, limbs) == host_msm(pts, scalars)
        sched = dm.schedule(dm.upload(limbs, cuda_device))
        mags, signs = sctx.digits_signed(limbs)
        host = sctx.schedule(mags, signs, T=sched.T)
        perm, loads, _, runrem = (t.cpu().numpy()
                                  for t in sched.on(cuda_device))
        act = list(sched.act)
        assert np.array_equal(perm, host.perm.view(np.int32)[act])
        assert np.array_equal(loads, host.loads[act])
        assert np.array_equal(runrem, host.runrem[act])
    assert len(sched.act) == 2


QFIELDS = [("toy_cycle", "main"), ("mnt_cycle", "main"), ("mnt_cycle", "help")]
QIDS = ["-".join(f) for f in QFIELDS]


def _field_rows(F, n, seed):
    """n random Montgomery elements of F, (n, 10) int32 on the CPU, with
    0, 1 and p - 1 first."""
    from pcd_tpu_torch.ops.field import FieldCtx, ints_to_limbs

    f = FieldCtx(F.MODULUS)
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % F.MODULUS
            for _ in range(n)]
    vals[:3] = [0, 1, F.MODULUS - 1]
    return torch.from_numpy(ints_to_limbs([v * f.r % f.p for v in vals])
                            .view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fld", QFIELDS, ids=QIDS)
def test_ntt_levels_match_plain(fld, cuda_device):
    """K5, every pass of a transform with radixes 2, 3, 5 or 7 (a batch
    of two, the first pass through the digit reversal), against its plain
    version (the pass's levels in turn) limb for limb; the transforms end
    to end too."""
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx
    from pcd_tpu_torch.poly.domain import EvaluationDomain

    F = getattr(getattr(M, fld[0])(), fld[1]).Fr
    dom = EvaluationDomain.new(F, 3000)
    assert set(dom.factors) - {2}
    ctx = fft_ctx(F, dom.n, cuda_device)
    a = torch.stack([_field_rows(F, dom.n, 1), _field_rows(F, dom.n, 2)]
                    ).to(cuda_device)
    key = ("ntt_pass", F.NAME)
    src, perm = a, ctx.perm
    for ps in ctx.passes:
        before = launch_counts().get(key, 0)
        got = ctx.ntt_pass(src, ctx.tbl_fwd, perm, ps)
        assert launch_counts()[key] == before + 1
        assert torch.equal(got, ctx.ntt_pass_plain(src, ctx.tbl_fwd, perm,
                                                   ps)), ps
        src, perm = got, None
    back = ctx.coset_ifft(ctx.coset_fft(ctx.ifft(ctx.fft(a))))
    assert torch.equal(back, a)


# the real domains (field, points, the provers' batch) and small ones with
# their radix mixes and a tile small enough for two passes of two blocks
NTT_DOMAINS = [("mnt_cycle", "main", 225_792, 3, None),
               ("mnt_cycle", "help", 31_360, 3, None),
               ("mnt_cycle", "main", 688_128, 2, None),
               ("mnt_cycle", "help", 107_520, 2, None),
               ("mnt_cycle", "main", 2 ** 3 * 3 * 7 * 7, 2, 64),
               ("mnt_cycle", "help", 2 ** 2 * 5 * 7 * 7, 2, 128),
               ("mnt_cycle", "main", 2 ** 4 * 3 * 7, 2, 32),
               ("mnt_cycle", "help", 2 ** 3 * 3 * 5 * 7, 2, 64),
               ("mnt_cycle", "main", 2 ** 3 * 3 * 7 * 7, 1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dom", NTT_DOMAINS,
                         ids=[f"{d[1]}-{d[2]}-x{d[3]}-tile{d[4]}"
                              for d in NTT_DOMAINS])
def test_ntt_pass_domains_match_plain(dom, cuda_device):
    """K5 pass by pass, forward and inverse table, on the four real
    domains at the provers' batch and on small mixed-radix domains with
    a forced small tile (several passes, several blocks a pass, a last
    block part full), against its plain version limb for limb."""
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx, passes

    cyc, side, n, batch, tile = dom
    F = getattr(getattr(M, cyc)(), side).Fr
    ctx = fft_ctx(F, n, cuda_device)
    ps_all = ctx.passes if tile is None else passes(n, ctx.levels, tile)
    assert len(ps_all) <= 3 if tile is None else len(ps_all) >= 2
    a = torch.stack([_field_rows(F, n, s) for s in range(batch)]).to(
        cuda_device)
    for tbl in (ctx.tbl_fwd, ctx.tbl_inv):
        src, perm = a, ctx.perm
        for ps in ps_all:
            got = ctx.ntt_pass(src, tbl, perm, ps)
            assert torch.equal(got, ctx.ntt_pass_plain(src, tbl, perm, ps)), ps
            src, perm = got, None
        if tile is not None:
            assert torch.equal(src, ctx._transform(a, tbl))


# K5's prologue x epilogue instantiations as ntt_pass takes them: name ->
# (source rows, pre, abc, post), the tables by FFTTensorCtx attribute;
# the prologues run on the first pass, the epilogues on the first and
# the last
NTT_MODES = {"plain": (None, None, False, None),
             "pre table": (None, "coset_tbl", False, None),
             "pre scalar": (None, "n_inv", False, None),
             "abc 3 rows": (3, None, True, None),
             "abc 2 rows": (2, None, True, None),
             "post table": (None, None, False, "ninv_coset_inv_tbl"),
             "post scalar": (None, None, False, "n_inv"),
             "pre + post": (None, "coset_tbl", False, "ninv_coset_tbl"),
             "abc + post plain": (3, None, True, "ninv_coset_inv_plain"),
             "abc 2 rows + post scalar": (2, None, True, "n_inv")}


@pytest.mark.cuda
@pytest.mark.parametrize("dom", NTT_DOMAINS[:4], ids=[
    f"{d[1]}-{d[2]}-x{d[3]}" for d in NTT_DOMAINS[:4]])
def test_ntt_pass_modes_match_plain(dom, cuda_device):
    """Every instantiation of K5 (prologue none, MUL by a table or a
    scalar, ABC on three or two rows; epilogue none or MUL by a table of
    Montgomery values or of plain residues, or a scalar) on the four real
    domains at the provers' batch: on the first pass, and the epilogues
    on the last pass too, against the plain version limb for limb, one
    launch each."""
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx

    cyc, side, n, batch, _ = dom
    F = getattr(getattr(M, cyc)(), side).Fr
    ctx = fft_ctx(F, n, cuda_device)
    first, last = ctx.passes[0], ctx.passes[-1]
    x = torch.stack([_field_rows(F, n, s) for s in range(3)]).to(
        cuda_device)
    key = ("ntt_pass", F.NAME)
    for name, (rows, pre, abc, post) in NTT_MODES.items():
        kw = {"pre": pre and getattr(ctx, pre),
              "abc": ctx.f.mont(11, cuda_device) if abc else None,
              "post": post and getattr(ctx, post)}
        src = x[:rows or batch].contiguous()
        cases = [(first, ctx.perm, kw)]
        if pre is None and not abc:
            cases.append((last, None, kw))
        for ps, perm, k in cases:
            before = launch_counts().get(key, 0)
            got = ctx.ntt_pass(src, ctx.tbl_inv, perm, ps, **k)
            assert launch_counts()[key] == before + 1
            want = ctx.ntt_pass_plain(src, ctx.tbl_inv, perm, ps, **k)
            assert torch.equal(got, want), (name, ps.M)


@pytest.mark.cuda
def test_ntt_pass_entry_refuses_bad_modes(cuda_device):
    """K5's C entry returns cudaErrorInvalidValue (1) for an unknown
    prologue or epilogue, a table of neither 1 nor n rows, a prologue at
    M > 1, and ABC on a batch other than one or on other than two or
    three source rows; a good call returns 0."""
    import ctypes

    from pcd_tpu_torch.ops.fft_tensor import fft_ctx
    from pcd_tpu_torch.ops.kernels import lib

    F = M.mnt_cycle().help.Fr
    ctx = fft_ctx(F, 31_360, cuda_device)
    n = ctx.n
    x = torch.stack([_field_rows(F, n, s) for s in range(3)]).to(
        cuda_device)
    out = torch.empty_like(x)
    kc = ctx.f.kconsts.ctypes.data_as(ctypes.c_void_p)
    stream = torch.cuda.current_stream().cuda_stream
    tbl, s = ctx.coset_tbl.data_ptr(), ctx.n_inv.data_ptr()

    def call(ps, perm, batch, pro, pv, np_, epi, ev, ne):
        geom = ps.geom()
        return lib("ntt").pcd_ntt_pass(
            x.data_ptr(), out.data_ptr(), ctx.tbl_fwd.data_ptr(),
            perm, n, batch, geom.ctypes.data_as(ctypes.c_void_p), kc,
            stream, pro, pv, np_, epi, ev, ne)

    first, last = ctx.passes[0], ctx.passes[-1]
    perm = ctx.perm.data_ptr()
    assert call(first, perm, 3, 1, tbl, n, 1, tbl, n) == 0
    torch.cuda.synchronize()
    for bad in [(first, perm, 3, 3, tbl, n, 0, None, 0),
                (first, perm, 3, 0, None, 0, 2, tbl, n),
                (first, perm, 3, 1, tbl, n - 1, 0, None, 0),
                (first, perm, 3, 0, None, 0, 1, tbl, 2),
                (first, perm, 3, 1, None, n, 0, None, 0),
                (last, None, 3, 1, tbl, n, 0, None, 0),
                (last, None, 1, 2, s, 3, 0, None, 0),
                (first, perm, 3, 2, s, 3, 0, None, 0),
                (first, perm, 1, 2, s, 4, 0, None, 0)]:
        assert call(*bad) == 1, bad


@pytest.mark.cuda
@pytest.mark.parametrize("dom", NTT_DOMAINS[:4],
                         ids=[f"{d[1]}-{d[2]}" for d in NTT_DOMAINS[:4]])
def test_hpoly_fused_matches_unfused(dom, cuda_device):
    """The device hpoly (three transforms, the pointwise steps in K5's
    prologue and epilogue) against the unfused composition on the card
    (ifft, coset_fft, (a b - c) Z_H^-1, coset_ifft, from_mont, each
    scaling a K7 launch) on random evaluations of the four real domains,
    the GM17 domains in the squaring form (b is a), limb for limb; K7
    never launched by the fused quotient."""
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx, hpoly
    from pcd_tpu_torch.poly.domain import EvaluationDomain

    cyc, side, n, batch, _ = dom
    F = getattr(getattr(M, cyc)(), side).Fr
    ctx = fft_ctx(F, n, cuda_device)
    f = ctx.f
    d = EvaluationDomain(F, n)
    zh_inv = pow(d.vanishing_poly_at(d.coset_shift), -1, F.MODULUS)
    a, b, c = (_field_rows(F, n, s).to(cuda_device) for s in (21, 22, 23))
    sq = batch == 2
    if sq:
        b = a
    kf = ("fp_vec", F.NAME)
    before = launch_counts().get(kf, 0)
    got = hpoly(ctx, a, b, c, zh_inv)
    assert launch_counts().get(kf, 0) == before
    x = torch.stack((a, c) if sq else (a, b, c))
    ev = f.vmul(ctx._transform(x, ctx.tbl_inv), ctx.n_inv)
    ev = ctx._transform(f.vmul(ev, ctx.coset_tbl), ctx.tbl_fwd)
    h = f.abc(ev[0], ev[0] if sq else ev[1], ev[-1],
              f.mont(zh_inv, cuda_device))
    h = f.vmul(f.vmul(ctx._transform(h, ctx.tbl_inv), ctx.n_inv),
               ctx._pow_table(d.coset_shift_inv))
    assert torch.equal(got, f.from_mont(h))


@pytest.mark.cuda
@pytest.mark.parametrize("fld", QFIELDS, ids=QIDS)
def test_spmv_rows_match_plain(fld, cuda_device):
    """K6 on uneven rows (empty, single entries, one row over every
    column) against its plain version and the C++ CSR matvec."""
    import random

    from pcd_tpu_torch import native
    from pcd_tpu_torch.ops.field import limbs_host, upload_limbs
    from pcd_tpu_torch.ops.matvec_tensor import matrices_to_device

    F = getattr(getattr(M, fld[0])(), fld[1]).Fr
    p = F.MODULUS
    rng = random.Random(6)
    n_rows, n_cols = 3000, 700
    rows = [tuple({rng.randrange(n_cols): rng.randrange(p)
                   for _ in range(rng.randrange(4))} for _ in range(3))
            for _ in range(n_rows)]
    rows[9] = ({c: rng.randrange(p) for c in range(n_cols)}, {}, {1: 1})
    z = [rng.randrange(p) for _ in range(n_cols)]
    mats = matrices_to_device(F, rows, n_rows, n_cols, cuda_device)
    f = mats[0].f
    zm = f.to_mont(upload_limbs(native.ints_to_limbs(z), cuda_device))
    want = native.SpMatrices(p, rows, n_rows).apply_all_limbs(z)
    for k, m in enumerate(mats):
        got = m.apply(zm)
        assert torch.equal(got, m.apply_plain(zm)), k
        assert np.array_equal(limbs_host(f.from_mont(got)), want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("fld", QFIELDS, ids=QIDS)
def test_fp_vec_matches_plain(fld, cuda_device):
    """K7, every op code, against its plain version limb for limb: a
    product by a table and by one element (batched), (a b - c) s,
    canonical <-> Montgomery, and the SAP evaluations."""
    from pcd_tpu_torch.ops.field import FieldCtx

    F = getattr(getattr(M, fld[0])(), fld[1]).Fr
    f = FieldCtx(F.MODULUS)
    n = 5000
    a, b, c = (_field_rows(F, n, s) for s in (3, 4, 5))
    cases = {
        "vmul table": lambda x, y, z: f.vmul(torch.stack([x, z]), y),
        "vmul scalar": lambda x, y, z: f.vmul(x, y[7:8]),
        "abc": lambda x, y, z: f.abc(x, y, z, y[9:10]),
        "to_mont": lambda x, y, z: f.to_mont(x),
        "from_mont": lambda x, y, z: f.from_mont(x),
        "sap": lambda x, y, z: f.sap(x[:2000], y[:2000], z[:2000],
                                     x[2000:2007], n),
    }
    for name, fn in cases.items():
        got = fn(*(t.to(cuda_device) for t in (a, b, c)))
        want = fn(a, b, c)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g.cpu(), w), name


@pytest.mark.cuda
def test_spmv_long_rows_match_plain(cuda_device):
    """K6 on rows of 0, 1, 2, 31, 32, 33, 299 and 1,000 entries, two in
    five values one (warp rows, thread rows, unit entries skipped),
    against its plain version and the C++ CSR matvec."""
    import random

    from pcd_tpu_torch import native
    from pcd_tpu_torch.ops.field import limbs_host, upload_limbs
    from pcd_tpu_torch.ops.matvec_tensor import matrices_to_device

    F = M.mnt_cycle().main.Fr
    p = F.MODULUS
    rng = random.Random(7)
    n_cols = 1200
    rows = [tuple({c: 1 if rng.random() < 0.4 else rng.randrange(2, p)
                   for c in rng.sample(range(n_cols), L)} for _ in range(3))
            for L in (0, 1, 2, 31, 32, 33, 299, 1000, 3, 7) * 40]
    z = [rng.randrange(p) for _ in range(n_cols)]
    mats = matrices_to_device(F, rows, len(rows), n_cols, cuda_device)
    assert all(m.n_warp == 120 and m.n_units for m in mats)
    f = mats[0].f
    zm = f.to_mont(upload_limbs(native.ints_to_limbs(z), cuda_device))
    want = native.SpMatrices(p, rows, len(rows)).apply_all_limbs(z)
    for k, m in enumerate(mats):
        got = m.apply(zm)
        assert torch.equal(got, m.apply_plain(zm)), k
        assert np.array_equal(limbs_host(f.from_mont(got)), want[k]), k


# -- K8 fixed_base (csrc/fixed_base.cu) and the device keygen ----------------

K8_FORMS = FORMS + [("toy_cycle", "main", "g2"), ("toy_cycle", "help", "g1")]


@pytest.mark.cuda
@pytest.mark.parametrize("form", K8_FORMS,
                         ids=["-".join(f) for f in K8_FORMS])
def test_fixed_base_matches_plain(form, cuda_device):
    """K8 limb for limb against its plain version on the card, and as
    points against the C++ fixed-base: 0, 1, r - 1, every low byte 0xFF,
    the top window's wraps (the last add doubling or cancelling, against
    [s mod r] G) and random scalars, n not a multiple of the block."""
    import random

    from pcd_tpu_torch.ops.fixed_base import fixed_base_device

    cyc, side, grp = form
    cfg = getattr(getattr(M, cyc)(), side)
    curve, gen = getattr(cfg, grp), getattr(cfg, grp + "_gen")
    r, bits = cfg.Fr.MODULUS, cfg.Fr.BITS
    fb = fixed_base_device(curve, gen, bits)
    top = 8 * (fb.nwin - 1)
    wraps = [low + (d << top) for d in range(1, 256)
             for low in ((d << top) % r, (-(d << top)) % r)
             if low < 1 << top]
    rng = random.Random(11)
    sc = [0, 1, r - 1, (1 << top) - 1] + wraps[:4] + wraps[-4:] + [
        rng.randrange(r) for _ in range(301)]
    digits = torch.from_numpy(fb.digits_from_ints(sc)).to(cuda_device)
    before = launch_counts().get(("fixed_base_mul", curve.name), 0)
    out = fb.mul_digits(digits)
    torch.cuda.synchronize()
    assert launch_counts()[("fixed_base_mul", curve.name)] == before + 1
    assert torch.equal(out, fb.mul_digits_plain(digits))
    got = fb.to_host(out)
    want = fixed_base_many(gen, [s % r for s in sc], bits)
    assert got == want
    assert got[0].is_infinity()


@pytest.mark.cuda
@pytest.mark.slow
def test_device_keygen_groth16_setup(cuda_device, monkeypatch):
    """A toy Groth16 setup under KEYGEN "device" on the card gives the
    host tier's pk bytes, with K8 launched once per query vector."""
    from pcd_tpu_torch.snark import msm_dispatch
    from pcd_tpu_torch.snark.groth16.native import Groth16
    from pcd_tpu_torch.utils import serialize as S
    from pcd_tpu_torch.utils.rng import ChaChaRng

    from _torch_support import SquareChain

    cfg = M.toy_mnt4()
    blobs = {}
    for tier in ("host", "device"):
        monkeypatch.setattr(msm_dispatch, "KEYGEN", tier)
        before = dict(launch_counts())
        pk, _ = Groth16(cfg, device=cuda_device).circuit_specific_setup(
            SquareChain(3, 80), ChaChaRng(b"card keygen"))
        blobs[tier] = S.groth16_pk_to_bytes(pk)
        ran = {f: v - before.get((k, f), 0)
               for (k, f), v in launch_counts().items()
               if k == "fixed_base_mul" and v != before.get((k, f), 0)}
        assert ran == ({} if tier == "host" else {cfg.g1.name: 4,
                                                  cfg.g2.name: 1}), tier
    assert blobs["host"] == blobs["device"]


# -- the multiprocess proof farm (parallel/farm.py): its workers rebuild the
# pk from pcd_tpu_torch.configs by name, on the card (the configs' default)

def _sum_predicate_builder(F):
    from pcd_tpu_torch.pcd.api import FpPredicate

    class SumPredicate(FpPredicate):
        PRIOR_MSG_LEN = 2

        def generate_constraints(self, cs, msg, wit, priors, base):
            (priors[0] + priors[1] + wit).enforce_equal(msg)

    return SumPredicate(F)


@pytest.mark.cuda
@pytest.mark.slow
def test_farm_multiprocess(cuda_device):
    """tests/test_dag_farm.py:59 on the port: two spawned workers, each
    holding a pk replica rebuilt from the config factory and the seed."""
    from pcd_tpu_torch import configs
    from pcd_tpu_torch.parallel.farm import DagFarm, ProofDag
    from pcd_tpu_torch.utils.rng import ChaChaRng

    pcd = configs.toy_groth16()
    F = pcd.ic.main_field
    pred = _sum_predicate_builder(F)
    seed = b"farm seed"
    pk, vk = pcd.circuit_specific_setup(pred, ChaChaRng(seed))
    dag = ProofDag()
    for i in range(2):
        dag.add_node(f"leaf{i}", F.from_int(i + 1), F.from_int(i + 1))
    dag.add_node("root", F.from_int(1 + 2 + 7), F.from_int(7),
                 priors=["leaf0", "leaf1"])
    farm = DagFarm(pcd, pred, pk, workers=2, config_name="toy_groth16",
                   seed=seed, predicate_builder=_sum_predicate_builder)
    proofs = farm.run(dag)
    assert pcd.verify(vk, pred, F.from_int(10), proofs["root"])


def _kill_once_builder(F):
    """tests/test_dag_farm.py's KillOncePredicate: kills its worker the
    first time the magic message is proved (PCD_TPU_TEST_KILL_SENTINEL
    names the one-shot sentinel file)."""
    import os

    from pcd_tpu_torch.pcd.api import FpPredicate

    class KillOncePredicate(FpPredicate):
        PRIOR_MSG_LEN = 2
        MAGIC = 1 + 2 + 10

        def flatten_message(self, msg):
            raise NotImplementedError     # no replay: every prove runs here

        def generate_constraints(self, cs, msg, wit, priors, base):
            sentinel = os.environ.get("PCD_TPU_TEST_KILL_SENTINEL")
            if sentinel and msg.val == self.MAGIC \
                    and not os.path.exists(sentinel):
                with open(sentinel, "w") as fh:
                    fh.write("died")
                os._exit(1)
            (priors[0] + priors[1] + wit).enforce_equal(msg)

    return KillOncePredicate(F)


@pytest.mark.cuda
@pytest.mark.slow
def test_farm_survives_worker_death(cuda_device, tmp_path, monkeypatch):
    """tests/test_dag_farm.py:110 on the port: a worker dying mid-wave
    poisons the pool; the farm rebuilds it and still proves the DAG."""
    import os

    from pcd_tpu_torch import configs
    from pcd_tpu_torch.parallel.farm import DagFarm, ProofDag
    from pcd_tpu_torch.utils.rng import ChaChaRng

    sentinel = str(tmp_path / "kill_once")
    monkeypatch.setenv("PCD_TPU_TEST_KILL_SENTINEL", sentinel)
    pcd = configs.toy_groth16()
    F = pcd.ic.main_field
    pred = _kill_once_builder(F)
    seed = b"farm death seed"
    pk, vk = pcd.circuit_specific_setup(pred, ChaChaRng(seed))
    dag = ProofDag()
    for i in range(2):
        dag.add_node(f"leaf{i}", F.from_int(i + 1), F.from_int(i + 1))
    dag.add_node("mid", F.from_int(13), F.from_int(10),
                 priors=["leaf0", "leaf1"])
    farm = DagFarm(pcd, pred, pk, workers=2, config_name="toy_groth16",
                   seed=seed, predicate_builder=_kill_once_builder)
    proofs = farm.run(dag)
    assert os.path.exists(sentinel), "kill never triggered"
    assert pcd.verify(vk, pred, F.from_int(13), proofs["mid"])
