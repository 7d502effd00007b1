"""The port's sharded stream MSM (pcd_tpu_torch/parallel/stream_dist.py)
and its Mesh collectives (parallel/mesh.py) on the CPU, the cases of
tests/test_dist_stream.py: ranks are threads over gloo in one process
(thread_meshes), the kernels' plain versions run on each rank's shard,
and every rank's point must equal pcd_tpu's host MSM (pcd_tpu.msm.host)
on the same points, which cross between the packages as the C++ tier's
u64 limb arrays.  At 1-4 ranks, under msm_dispatch.SCHEDULER "host" and
"device", with n = 203 (no multiple of the size), an infinity, a zero
scalar and r - 1; the toy MNT4 G2 (Fq2) at 2 ranks; one sharded table
reused across scalar vectors, and DistContext.stream_msm's table cached
on its owner.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.msm.host import msm as host_msm  # noqa: E402
from pcd_tpu.native import _points_to_arrays  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops import ec  # noqa: E402
from pcd_tpu_torch.parallel.mesh import run_ranks, thread_meshes  # noqa: E402
from pcd_tpu_torch.parallel.stream_dist import ShardedStreamMSM  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402

from _torch_support import reference_native_loaded  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the plain versions: the ranks are threads
    of their own, and their small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _oracle(pts, scalars):
    live = [(p, s) for p, s in zip(pts, scalars)
            if s and not p.is_infinity()]
    if not live:
        return pts[0].curve.infinity()
    return host_msm([p for p, _ in live], [s for _, s in live])


def _scalars(r, n, seed):
    rng = np.random.default_rng(seed)
    return [int(x) % r for x in rng.integers(0, 1 << 62, size=n)]


def _sharded(curve, bits, ref_pts, scalars, size):
    """Every rank's MSM of (ref_pts, scalars) at c = 6 on 128 lanes."""
    d = ec.ec_ctx(curve).d
    xs, ys, inf = _points_to_arrays(ref_pts, d)

    def rank(mesh):
        smsm = ShardedStreamMSM(curve, bits, mesh, c=6, lanes=128)
        table, inf_l = smsm.table_from_limbs(xs, ys, inf)
        assert table.shape[0] == -(-len(ref_pts) // size)
        limbs = smsm.sctx.limb_rows(scalars, (bits + 63) // 64 * 8)
        return _affine(smsm.msm_limbs(table, limbs))

    return run_ranks(thread_meshes(size), rank, timeout_s=120)


@pytest.mark.parametrize("scheduler", ["host", "device"])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_sharded_stream_g1_matches_host(toy, size, scheduler, monkeypatch):
    monkeypatch.setattr(msm_dispatch, "SCHEDULER", scheduler)
    ref, port = toy
    g = ref.g1_gen
    n = 203  # deliberately NOT a multiple of the size
    pts = [g * (i + 1) for i in range(n - 2)] + [ref.g1.infinity(), g * 7]
    r = ref.g1.order
    scalars = _scalars(r, n, 3)
    scalars[5] = 0
    scalars[6] = r - 1
    ec.reset_launch_counts()
    got = _sharded(port.g1, port.Fr.BITS, pts, scalars, size)
    want = _affine(_oracle(pts, scalars))
    assert got == [want] * size
    # K1 and K4 once a rank (their plain versions on the CPU)
    plain = ec.plain_counts()
    assert plain[("madd_accumulate", port.g1.name)] == size
    assert plain[("bucket_finish", port.g1.name)] == size


def test_sharded_stream_uncovered_windows(toy, monkeypatch):
    """The device schedule covers only a rank's active windows, which
    differ between ranks: rank 0's scalars have digits in the low windows
    only, rank 1's are all zero (no window, no launch).  Each rank pads
    its sums to every window with identities before the gather."""
    monkeypatch.setattr(msm_dispatch, "SCHEDULER", "device")
    ref, port = toy
    g = ref.g1_gen
    n = 64
    pts = [g * (i + 1) for i in range(n)]
    scalars = [(7 * i + 1) % 4096 for i in range(n // 2)] + [0] * (n // 2)
    ec.reset_launch_counts()
    got = _sharded(port.g1, port.Fr.BITS, pts, scalars, 2)
    assert got == [_affine(_oracle(pts, scalars))] * 2
    assert ec.plain_counts()[("madd_accumulate", port.g1.name)] == 1


def test_sharded_stream_g2_ext_matches_host(toy):
    """Fp2 coordinates (the toy MNT4 G2) shard through the same
    pipeline."""
    ref, port = toy
    g = ref.g2_gen
    n = 96
    pts = [g * (i + 1) for i in range(n)]
    scalars = _scalars(ref.g2.order, n, 4)
    got = _sharded(port.g2, port.Fr.BITS, pts, scalars, 2)
    assert got == [_affine(_oracle(pts, scalars))] * 2


def test_sharded_stream_table_reuse(toy):
    """One sharded table, two scalar vectors (the pk-query reuse)."""
    ref, port = toy
    g = ref.g1_gen
    n = 64
    pts = [g * (i + 1) for i in range(n)]
    xs, ys, inf = _points_to_arrays(pts, 1)
    vecs = [_scalars(ref.g1.order, n, seed) for seed in (1, 2)]

    def rank(mesh):
        smsm = ShardedStreamMSM(port.g1, port.Fr.BITS, mesh, c=6, lanes=128)
        table, _ = smsm.table_from_limbs(xs, ys, inf)
        return [_affine(smsm.msm_limbs(table, smsm.sctx.limb_rows(s, 8)))
                for s in vecs]

    want = [_affine(_oracle(pts, s)) for s in vecs]
    assert run_ranks(thread_meshes(2), rank, timeout_s=120) == [want] * 2


def test_dist_context_stream_msm(toy, monkeypatch):
    """DistContext.stream_msm: two calls on one owner's query, the second
    on the table the first cached there (keyed by name, device, rank and
    size, not by the points' identity)."""
    from pcd_tpu_torch.parallel.dist import DistContext

    monkeypatch.setattr(msm_dispatch, "WINDOW_BITS", 6)
    monkeypatch.setattr(msm_dispatch, "LANES", 128)
    ref, port = toy
    n = 40
    rg, tg = ref.g1_gen, port.g1_gen
    rpts = [rg * (i + 1) for i in range(n)]
    owner = types.SimpleNamespace(q=[tg * (i + 1) for i in range(n)])
    vecs = [_scalars(ref.g1.order, n, seed) for seed in (5, 6)]

    def rank(mesh):
        dctx = DistContext(mesh)
        out = [_affine(dctx.stream_msm(owner, "q", port.g1, port.Fr.BITS,
                                       vecs[0]))]
        key = ("q", "cpu", mesh.rank, 2, None)
        table = owner._stream_tables[key]
        out.append(_affine(dctx.stream_msm(owner, "q", port.g1,
                                           port.Fr.BITS, vecs[1])))
        assert owner._stream_tables[key] is table
        return out

    want = [_affine(_oracle(rpts, s)) for s in vecs]
    assert run_ranks(thread_meshes(2), rank, timeout_s=120) == [want] * 2


@pytest.mark.parametrize("size", [2, 3])
def test_mesh_collectives(size):
    """all_gather stacks the ranks' tensors; all_to_all is the tiled
    jax.lax.all_to_all: chunk j of the split dim goes to rank j, and the
    chunks received are joined in rank order along the concat dim; any
    is every rank's or."""
    def rank(mesh):
        r = mesh.rank
        x = torch.arange(size * 2 * 3, dtype=torch.int32).reshape(
            size * 2, 3) + 100 * r
        g = mesh.all_gather(x)
        a = mesh.all_to_all(x, 0, 1)
        return g, a, mesh.any(r == size - 1), mesh.any(False)

    outs = run_ranks(thread_meshes(size), rank, timeout_s=60)
    xs = [torch.arange(size * 6, dtype=torch.int32).reshape(size * 2, 3)
          + 100 * r for r in range(size)]
    for r, (g, a, some, none) in enumerate(outs):
        assert torch.equal(g, torch.stack(xs))
        want = torch.cat([xs[j][2 * r:2 * r + 2] for j in range(size)], 1)
        assert torch.equal(a, want)
        assert some and not none
