"""The plain reference at toy sizes against the port (this test may import
both; the reference itself imports nothing of the port)."""

import ast
import os
import random
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from reference import checks, models  # noqa: E402


def test_reference_imports_nothing_of_the_program():
    for f in os.listdir(os.path.join(BENCH, "reference")):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(BENCH, "reference", f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) and not node.level else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "pcd_tpu_torch", "pcd_tpu", "jax", "benchlib"), (f, n)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_expected_against_the_ports_host_msm(group):
    from pcd_tpu_torch.curves import models as pm
    from pcd_tpu_torch.msm.host import msm

    rng = random.Random(7)
    ref, port = models.toy_mnt4(), pm.toy_mnt4()
    r = ref.Fr.MODULUS
    t = [rng.randrange(1 << 64) for _ in range(40)]
    s = [rng.randrange(r) for _ in range(40)]
    gen = port.g1_gen if group == "g1" else port.g2_gen
    got = msm([gen * ti for ti in t], s)
    assert checks.encode(got) == checks.msm_expected(ref, group, t, s)
    s[3] = (s[3] + 1) % r
    assert checks.encode(got) != checks.msm_expected(ref, group, t, s)


@pytest.mark.parametrize("kind", ["groth16", "gm17"])
def test_vk_bytes_and_verify_against_the_port(kind):
    """A toy SNARK of the port: the reference's vk byte image equals the
    gadget's, its verifier accepts the port's proof for the right input
    and rejects it for another."""
    from pcd_tpu_torch.curves.models import toy_mnt6
    from pcd_tpu_torch.r1cs.system import ConstraintSystem  # noqa: F401
    from pcd_tpu_torch.snark.gm17.gadget import GM17VerifierGadget
    from pcd_tpu_torch.snark.gm17.native import GM17
    from pcd_tpu_torch.snark.groth16.gadget import Groth16VerifierGadget
    from pcd_tpu_torch.snark.groth16.native import Groth16
    from pcd_tpu_torch.pcd.ec_cycle import DefaultCircuit
    from pcd_tpu_torch.utils.rng import ChaChaRng

    snark_cls, gadget_cls = {"groth16": (Groth16, Groth16VerifierGadget),
                             "gm17": (GM17, GM17VerifierGadget)}[kind]
    cfg = toy_mnt6()
    snark = snark_cls(cfg, device="cpu")
    circ = DefaultCircuit(2)
    rng = ChaChaRng(b"benchmark reference test")
    pk, vk = snark.circuit_specific_setup(circ, rng)
    proof = snark.prove(pk, circ, rng)
    names = checks.VK_ORDER[kind]
    plain = {n: ([checks.encode(p) for p in getattr(vk, n)]
                 if isinstance(getattr(vk, n), list)
                 else checks.encode(getattr(vk, n))) for n in names}
    rcfg = models.toy_mnt6()
    rvk = checks._decode_vk(rcfg, plain)
    assert checks.vk_bytes(kind, rvk) == gadget_cls(cfg).vk_bytes_native(vk)
    pf = {k: checks.point(rcfg.g1 if k != "b" else rcfg.g2,
                          checks.encode(getattr(proof, k)))
          for k in ("a", "b", "c")}
    one = rcfg.Fr.from_int(1)
    assert checks.verify(kind, rcfg, rvk, [one, one], pf)
    assert not checks.verify(kind, rcfg, rvk, [one, one + one], pf)
