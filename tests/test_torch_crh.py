"""The port's Pedersen CRH (pcd_tpu_torch/crh/pedersen.py) against
pcd_tpu's: the native hash and the x-only compressor give the same
points for the same parameters seed and input, the port's gadgets agree
with its native hash on a satisfied constraint system (the reference's
own strategy, tests/test_crh.py:41-70), and the committed self-vectors
(tests/fixtures/self_vectors/vectors.json, written by pcd_tpu) come out
byte for byte.  Pure Python: no torch, no kernel.
"""

import json
import os
import random

import pytest

from pcd_tpu.crh.pedersen import PedersenCRH as RPedersen
from pcd_tpu.crh.pedersen import PedersenCRHCompressor as RCompressor
from pcd_tpu.curves import models as RM
from pcd_tpu.utils.rng import ChaChaRng as RRng
from pcd_tpu_torch.crh.pedersen import PedersenCRH, PedersenCRHCompressor
from pcd_tpu_torch.curves import models as TM
from pcd_tpu_torch.gadgets.fp import UInt8, fpvar_class
from pcd_tpu_torch.r1cs.system import ConstraintSystem
from pcd_tpu_torch.utils.rng import ChaChaRng

VECTORS = os.path.join(os.path.dirname(__file__), "fixtures",
                       "self_vectors", "vectors.json")
CURVES = {"toy": "toy_te", "jubjub": "jubjub"}


def _data(n, seed):
    r = random.Random(seed)
    return bytes(r.randrange(256) for _ in range(n))


@pytest.mark.parametrize("curve_name", sorted(CURVES))
def test_pedersen_matches_reference(curve_name):
    fn = CURVES[curve_name]
    ours, theirs = PedersenCRH(getattr(TM, fn)()), RPedersen(getattr(RM, fn)())
    seed = b"pedersen parity " + curve_name.encode()
    pp, rpp = ours.setup(ChaChaRng(seed)), theirs.setup(RRng(seed))
    for n in (0, 1, 37):
        data = _data(n, n)
        a, b = ours.evaluate(pp, data), theirs.evaluate(rpp, data)
        assert (int(a.x.n), int(a.y.n)) == (int(b.x.n), int(b.y.n)), n
        assert ours.output_to_bytes(a) == theirs.output_to_bytes(b)


@pytest.mark.parametrize("curve_name", sorted(CURVES))
def test_pedersen_native_vs_gadget(curve_name):
    curve = getattr(TM, CURVES[curve_name])()
    crh = PedersenCRH(curve)
    pp = crh.setup(ChaChaRng(b"gadget " + curve_name.encode()))
    data = _data(128, 2718)                  # the reference's length
    native = crh.evaluate(pp, data)
    cs = ConstraintSystem(curve.F)
    V = fpvar_class(cs)
    out = crh.check_evaluation_gadget(V, pp, UInt8.new_witness_vec(V, data))
    assert out.x.val == native.x.n and out.y.val == native.y.n
    assert cs.is_satisfied()


def test_pedersen_compressor_matches_reference_and_gadget():
    ours, theirs = (PedersenCRHCompressor(TM.toy_te()),
                    RCompressor(RM.toy_te()))
    pp, rpp = ours.setup(ChaChaRng(b"cmp")), theirs.setup(RRng(b"cmp"))
    data = b"hello pcd"
    native = ours.evaluate(pp, data)
    assert native == PedersenCRH(TM.toy_te()).evaluate(pp, data).x
    assert int(native.n) == int(theirs.evaluate(rpp, data).n)
    cs = ConstraintSystem(TM.toy_te().F)
    V = fpvar_class(cs)
    out = ours.check_evaluation_gadget(V, pp, UInt8.new_witness_vec(V, data))
    assert out.val == native.n
    assert cs.is_satisfied()
    # a changed byte changes the hash
    assert ours.evaluate(pp, b"hello pcD") != native


@pytest.mark.parametrize("cname", ["pedersen", "pedersen_compressor"])
def test_pedersen_self_vectors(cname):
    """pcd_tpu's committed self-vectors (scripts/gen_self_vectors.py: the
    TE curve over MNT4-298's Fr, 64 bytes, a fixed seed)."""
    with open(VECTORS) as fh:
        want = json.load(fh)[f"crh/{cname}"]
    cls = {"pedersen": PedersenCRH,
           "pedersen_compressor": PedersenCRHCompressor}[cname]
    crh = cls(TM.ed_on_mnt4_298())
    pp = crh.setup(ChaChaRng(b"self-vector crh seed"))
    got = crh.output_to_bytes(crh.evaluate(pp, bytes(range(64))))
    assert got.hex() == want["hex"]
