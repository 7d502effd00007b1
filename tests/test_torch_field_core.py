"""The kernels' field core and point formulas (pcd_tpu_torch/csrc/field.cuh,
ec.cuh) against the port's plain torch versions, on the CPU: the host build
csrc/host_check.cpp runs the carry-chain instruction sequence of the card
in emulation (csrc/ptx.cuh), so the Fp^D product and both RCB15 formulas
are checked limb for limb without a card, in every field form, on random
field elements and the edge values 0, 1, p - 1 and the identity.  The
plain versions are themselves held to pcd_tpu by test_torch_field_ec.py.
Port-only: nothing here imports JAX.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops.ec import ec_ctx  # noqa: E402
from pcd_tpu_torch.ops.field import NLIMB, ints_to_limbs  # noqa: E402
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
