"""The port's slice end to end on the toy cycle: pcd_tpu runs setup, the
base-case prove and a step-2 prove; the port takes the proving key through
convert.pcd_pk_from_reference, proves from a ChaChaRng in the same state
with every commitment MSM of every prove on its stream MSM (the plain
versions, on the CPU), and must write the same proof bytes.  Its chain
verifies and rejects the old message against the newest proof.  Also:
the port imports neither JAX nor the JAX package.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from pcd_tpu.utils import serialize as RS  # noqa: E402

from _torch_support import reference_native_loaded  # noqa: E402,F401
from _torch_support import toy_chain_matches_reference  # noqa: E402
from _torch_support import two_torch_threads  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.pcd_toy
def test_toy_chain_matches_reference(monkeypatch):
    toy_chain_matches_reference("toy_groth16", RS.pcd_pk_to_bytes,
                                b"torch port", monkeypatch)


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
