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
