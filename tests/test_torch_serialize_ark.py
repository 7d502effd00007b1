"""The port's ark-serialize compat point layout
(pcd_tpu_torch/utils/serialize.py: ark_point_size, ark_point_to_bytes,
ark_point_from_bytes) against pcd_tpu's: byte for byte on the four real
groups (MNT4-298 and MNT6-298, G1 and G2), compressed and not, with the
identity and both y signs; the sign flag alone tells P from -P; the
rejects of tests/test_serialize.py:145-151 and more; and the committed
self-vectors (tests/fixtures/self_vectors/vectors.json, written by
pcd_tpu) through the record checker of tests/test_ark_vectors.py:85.
Pure Python: no torch, no kernel.
"""

import json
import os

import pytest

from pcd_tpu.curves import models as RM
from pcd_tpu.utils import serialize as RS
from pcd_tpu_torch.curves import models as TM
from pcd_tpu_torch.utils import serialize as TS

VECTORS = os.path.join(os.path.dirname(__file__), "fixtures",
                       "self_vectors", "vectors.json")
GROUPS = [("mnt4_298", "g1"), ("mnt4_298", "g2"), ("mnt6_298", "g1"),
          ("mnt6_298", "g2")]


def _coeffs(e):
    cs = e.to_prime_coeffs() if hasattr(e, "to_prime_coeffs") else [e]
    return [int(c.n) for c in cs]


def _pair(cfg_name, grp):
    t, r = getattr(TM, cfg_name)(), getattr(RM, cfg_name)()
    return (getattr(t, grp), getattr(t, grp + "_gen"),
            getattr(r, grp), getattr(r, grp + "_gen"))


@pytest.mark.parametrize("compressed", [True, False])
@pytest.mark.parametrize("cfg_name,grp", GROUPS)
def test_ark_bytes_equal_reference(cfg_name, grp, compressed):
    curve, gen, rcurve, rgen = _pair(cfg_name, grp)
    assert TS.ark_point_size(curve, compressed) == RS.ark_point_size(
        rcurve, compressed)
    for k in (1, 2, 5, 0x1234567, -1, -7, 0):
        pt = curve.infinity() if k == 0 else gen * k
        rpt = rcurve.infinity() if k == 0 else rgen * k
        b = TS.ark_point_to_bytes(pt, compressed)
        assert b == RS.ark_point_to_bytes(rpt, compressed), k
        assert len(b) == TS.ark_point_size(curve, compressed)
        got, off = TS.ark_point_from_bytes(curve, b + b"tail", compressed)
        assert off == len(b) and got == pt, k


@pytest.mark.parametrize("cfg_name,grp", GROUPS)
def test_ark_sign_flag_selects_root(cfg_name, grp):
    curve, gen, _, _ = _pair(cfg_name, grp)
    g = gen * 7
    pos, neg = TS.ark_point_to_bytes(g, True), TS.ark_point_to_bytes(-g, True)
    assert pos[:-1] == neg[:-1] and pos[-1] != neg[-1]
    assert (pos[-1] ^ neg[-1]) == 1 << 7            # bit 7: positive y
    assert TS.ark_point_from_bytes(curve, pos, True)[0] == g
    assert TS.ark_point_from_bytes(curve, neg, True)[0] == -g


def test_ark_rejects_bad_bytes():
    for cfg in (TM.toy_mnt4(), TM.mnt4_298()):
        size = TS.ark_point_size(cfg.g1, True)
        # a coefficient >= the modulus
        bad = bytes([0xFF] * (size - 1)) + bytes([0x3F])
        with pytest.raises(ValueError):
            TS.ark_point_from_bytes(cfg.g1, bad, True)
    cfg = TM.mnt4_298()
    g = cfg.g1_gen * 3
    # an uncompressed y whose sign flag contradicts y
    b = bytearray(TS.ark_point_to_bytes(g, False))
    b[-1] ^= 1 << 7
    with pytest.raises(ValueError):
        TS.ark_point_from_bytes(cfg.g1, bytes(b), False)
    # a compressed x off the curve: the first x with no square root
    F, prime = cfg.g1.F, cfg.g1.F.prime_subfield()
    x = 1
    while (F.from_int(x) ** 3 + cfg.g1.a * F.from_int(x)
           + cfg.g1.b).sqrt() is not None:
        x += 1
    raw = bytearray(x.to_bytes(TS.ark_point_size(cfg.g1, True), "little"))
    assert int.from_bytes(raw, "little") < prime.MODULUS
    with pytest.raises(ValueError):
        TS.ark_point_from_bytes(cfg.g1, bytes(raw), True)


@pytest.mark.parametrize("name", ["mnt4", "mnt6"])
@pytest.mark.parametrize("grp", ["g1", "g2"])
def test_ark_committed_self_vectors(name, grp):
    """pcd_tpu's committed bytes for 0x1234567 G (and the identity,
    compressed) decode in the port and re-encode to the same bytes."""
    with open(VECTORS) as fh:
        vec = json.load(fh)
    cfg = getattr(TM, name + "_298")()
    curve, gen = getattr(cfg, grp), getattr(cfg, grp + "_gen")
    pt = gen * 0x1234567
    comp = bytes.fromhex(vec[f"point/{name}.{grp}.ark_comp"]["hex"])
    uncomp = bytes.fromhex(vec[f"point/{name}.{grp}.ark_uncomp"]["hex"])
    got, off = TS.ark_point_from_bytes(curve, comp, True)
    inf, end = TS.ark_point_from_bytes(curve, comp, True, off)
    assert got == pt and inf.is_infinity() and end == len(comp)
    assert TS.ark_point_from_bytes(curve, uncomp, False) == (pt, len(uncomp))
    assert (TS.ark_point_to_bytes(pt, True)
            + TS.ark_point_to_bytes(curve.infinity(), True)) == comp
    assert TS.ark_point_to_bytes(pt, False) == uncomp


@pytest.mark.parametrize("name", ["mnt4_298_g1", "mnt4_298_g2"])
@pytest.mark.parametrize("compressed", [True, False])
def test_ark_self_vectors(name, compressed):
    """tests/test_ark_vectors.py:85's synthetic records, written by
    pcd_tpu's serializer and checked by the port's reader and writer."""
    cfg_name, grp = name.rsplit("_", 1)
    curve, gen, rcurve, rgen = _pair(cfg_name, grp)
    for k in (1, 7, 0):
        rpt = rcurve.infinity() if k == 0 else rgen * k
        data = RS.ark_point_to_bytes(rpt, compressed=compressed)
        pt, off = TS.ark_point_from_bytes(curve, data, compressed=compressed)
        assert off == len(data)
        if k == 0:
            assert pt.is_infinity()
        else:
            assert (_coeffs(pt.x), _coeffs(pt.y)) == (_coeffs(rpt.x),
                                                      _coeffs(rpt.y))
        assert TS.ark_point_to_bytes(pt, compressed=compressed) == data
