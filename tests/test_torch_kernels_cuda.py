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
