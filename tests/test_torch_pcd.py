"""The port's slice end to end on the toy cycle: pcd_tpu runs setup, the
base-case prove and a step-2 prove; the port takes the proving key through
convert.pcd_pk_from_reference, proves from a ChaChaRng in the same state
with every commitment MSM of every prove on its stream MSM (the plain
versions, on the CPU), and must write the same proof bytes.  Its chain
verifies and rejects the old message against the newest proof.  Also:
the port imports neither JAX nor the JAX package.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu import configs as RC  # noqa: E402
from pcd_tpu.pcd.api import FpPredicate as RPredicate  # noqa: E402
from pcd_tpu.utils import serialize as RS  # noqa: E402
from pcd_tpu.utils.rng import ChaChaRng as RRng  # noqa: E402
from pcd_tpu_torch import configs as TC  # noqa: E402
from pcd_tpu_torch import convert  # noqa: E402
from pcd_tpu_torch.ops import ec as tec  # noqa: E402
from pcd_tpu_torch.pcd.api import FpPredicate as TPredicate  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402
from pcd_tpu_torch.snark.groth16.native import Groth16  # noqa: E402
from pcd_tpu_torch.utils import serialize as TS  # noqa: E402
from pcd_tpu_torch.utils.rng import ChaChaRng as TRng  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _predicate(base, field):
    class Counter(base):
        """msg == prior_msg + witness (reference tests/mnt4_groth16.rs)."""

        PRIOR_MSG_LEN = 1

        def generate_constraints(self, cs, msg, wit, priors, base_case):
            (priors[0] + wit).enforce_equal(msg)

    return Counter(field)


@pytest.mark.pcd_toy
def test_toy_chain_matches_reference(monkeypatch):
    rpcd = RC.toy_groth16()
    F = rpcd.ic.main_field
    rpred = _predicate(RPredicate, F)
    pk, vk = rpcd.circuit_specific_setup(rpred, RRng(b"torch port setup"))
    rng = RRng(b"torch port prove")
    one = F.from_int(1)
    ref1 = rpcd.prove(pk, rpred, one, one, [], [], rng)
    ref2 = rpcd.prove(pk, rpred, F.from_int(2), one, [one], [ref1], rng)

    tpcd = TC.toy_groth16(device="cpu")
    TF = tpcd.ic.main_field
    tpred = _predicate(TPredicate, TF)
    blob = np.frombuffer(RS.pcd_pk_to_bytes(rpcd, pk), dtype=np.uint8)
    tpk = convert.pcd_pk_from_reference(tpcd, blob)
    seed = vk.crh_pp.seed
    vk_blob = np.frombuffer(struct.pack("<I", len(seed)) + seed
                            + RS.groth16_vk_to_bytes(vk.help_vk),
                            dtype=np.uint8)
    tvk = convert.pcd_vk_from_reference(tpcd, vk_blob)
    assert TS.pcd_vk_to_bytes(tpcd, tvk) == vk_blob.tobytes()

    # every commitment MSM of both SNARKs' proves on the stream tier; the
    # toy's 23k-point MSMs take windows of 8 bits on 2048 lanes (the card's
    # 12 and 8192 cost the plain versions several times more here)
    monkeypatch.setattr(Groth16, "STREAM_MIN", 0)
    monkeypatch.setattr(msm_dispatch, "WINDOW_BITS", 8)
    monkeypatch.setattr(msm_dispatch, "LANES", 2048)
    tec.reset_launch_counts()
    rng = TRng(b"torch port prove")
    one_t = TF.from_int(1)
    p1 = tpcd.prove(tpk, tpred, one_t, one_t, [], [], rng)
    p2 = tpcd.prove(tpk, tpred, TF.from_int(2), one_t, [one_t], [p1], rng)
    plain = tec.plain_counts()

    assert TS.pcd_proof_to_bytes(tpcd, p1) == RS.pcd_proof_to_bytes(rpcd,
                                                                    ref1)
    assert TS.pcd_proof_to_bytes(tpcd, p2) == RS.pcd_proof_to_bytes(rpcd,
                                                                    ref2)
    assert tpcd.verify(tvk, tpred, one_t, p1)
    assert tpcd.verify(tvk, tpred, TF.from_int(2), p2)
    assert not tpcd.verify(tvk, tpred, one_t, p2)
    cyc = tpcd.ic.cycle
    for curve in (cyc.main.g1, cyc.main.g2, cyc.help.g1, cyc.help.g2):
        assert plain.get(("complete_add", curve.name), 0) > 0, curve.name
    # K1 once per commitment MSM: a, b1, l and h in G1, b2 in G2, two
    # proves of each SNARK
    for cfg in (cyc.main, cyc.help):
        assert plain[("madd_accumulate", cfg.g1.name)] == 8
        assert plain[("madd_accumulate", cfg.g2.name)] == 2
    assert tec.launch_counts() == {}


def test_port_imports_no_jax():
    """Import every module of pcd_tpu_torch (and chip_smoke.py) in a fresh
    interpreter: no jax module and no module of the JAX package may load
    (pcd_tpu itself or pcd_tpu.*, which pcd_tpu_torch is not)."""
    code = """
import importlib, importlib.util, pkgutil, sys
import pcd_tpu_torch
for m in pkgutil.walk_packages(pcd_tpu_torch.__path__, "pcd_tpu_torch."):
    if importlib.util.find_spec(m.name).origin.endswith(".py"):
        importlib.import_module(m.name)   # (not the C++ tier's built .so)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n.startswith("jaxlib")
             or n == "pcd_tpu" or n.startswith("pcd_tpu."))
n = sum(1 for k in sys.modules if k.startswith("pcd_tpu_torch"))
print(n, bad)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) > 40 and bad == "[]", out.stdout
