"""The port's fixed-base keygen (pcd_tpu_torch/ops/fixed_base.py, K8's
plain version on the CPU) against pcd_tpu, and its dispatch:

  - `FixedBaseDevice.mul_many` on the CPU equals pcd_tpu's C++
    `fixed_base_many` on the four toy groups and on MNT4-298 G1, for 0, 1,
    r - 1, all-0xFF low windows and random scalars, and pcd_tpu's own
    `FixedBaseDevice.mul_many` (the XLA gathers and complete adds, on
    JAX-CPU: a few seconds a group) on the toy groups;
  - the top window's wrap: integers below 2^(8 nwin) whose low windows sum
    to +-T[top][d] modulo the group order, so that the last mixed add
    doubles or cancels, equal [s mod r] G;
  - the digits are pcd_tpu's bytes, and a scalar too wide raises;
  - the plain inversion `FieldCtx.inv_plain` at d = 1, 2, 3 against
    Python's pow and the tower's inverse, 0 to 0;
  - a toy Groth16 and GM17 setup under msm_dispatch.KEYGEN = "device",
    forced onto the plain K8 on the CPU, gives the host tier's pk bytes,
    with one K8 call per query vector; by default the CPU keeps the host
    path, and fewer than KEYGEN_MIN scalars never reach K8.
"""

import copy
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.msm.host import fixed_base_many as ref_fixed_base_many  # noqa
from pcd_tpu.ops.fixed_base import FixedBaseDevice as RFixedBase  # noqa
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops import ec as tec  # noqa: E402
from pcd_tpu_torch.ops.ec import ec_ctx  # noqa: E402
from pcd_tpu_torch.ops.field import FieldCtx, ints_to_limbs  # noqa
from pcd_tpu_torch.ops.field import limbs_to_ints  # noqa: E402
from pcd_tpu_torch.ops.fixed_base import fixed_base_device  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402
from pcd_tpu_torch.snark.gm17.native import GM17  # noqa: E402
from pcd_tpu_torch.snark.groth16.native import Groth16  # noqa: E402
from pcd_tpu_torch.utils import serialize as TS  # noqa: E402
from pcd_tpu_torch.utils.rng import ChaChaRng  # noqa: E402

from _torch_support import SquareChain  # noqa: E402
from _torch_support import reference_native_loaded  # noqa: E402,F401
from _torch_support import two_torch_threads  # noqa: E402,F401

TOY = [("main", "g1"), ("main", "g2"), ("help", "g1"), ("help", "g2")]


def _coords(pt):
    if pt.is_infinity():
        return None

    def cs(e):
        return tuple(int(c.n) for c in (e.to_prime_coeffs()
                                        if hasattr(e, "to_prime_coeffs")
                                        else [e]))
    return cs(pt.x), cs(pt.y)


def _group(cycle, side, grp):
    cfg = getattr(getattr(TM, cycle)(), side)
    rcfg = getattr(getattr(RM, cycle)(), side)
    return (cfg, getattr(cfg, grp), getattr(cfg, grp + "_gen"),
            getattr(rcfg, grp), getattr(rcfg, grp + "_gen"))


def _scalars(r, nwin, n, seed):
    """0, 1, r - 1, every low byte 0xFF (with and without a top digit),
    then n random scalars below r."""
    rng = random.Random(seed)
    low = (1 << (8 * (nwin - 1))) - 1
    edge = [0, 1, r - 1, low] + [s for s in (low + (1 << (8 * (nwin - 1))),)
                                 if s < r]
    return edge + [rng.randrange(r) for _ in range(n)]


@pytest.mark.parametrize("side,grp", TOY + [("main_real", "g1")],
                         ids=["-".join(g) for g in TOY] + ["mnt4_298-g1"])
def test_plain_fixed_base_matches_cpp(side, grp):
    cycle = "mnt_cycle" if side == "main_real" else "toy_cycle"
    cfg, curve, base, _, rbase = _group(cycle, side.split("_")[0], grp)
    r, bits = cfg.Fr.MODULUS, cfg.Fr.BITS
    fb = fixed_base_device(curve, base, bits)
    assert fb.nwin == (bits + 7) // 8
    sc = _scalars(r, fb.nwin, 3 if cycle == "mnt_cycle" else 40, side)
    tec.reset_launch_counts()
    got = fb.mul_many(sc, "cpu")
    assert tec.plain_counts() == {("fixed_base_mul", curve.name): 1}
    want = ref_fixed_base_many(rbase, sc, bits)
    assert [_coords(p) for p in got] == [_coords(p) for p in want]
    assert got[0].is_infinity() and got[1] == base and got[2] == -base


@pytest.mark.parametrize("side,grp", TOY, ids=["-".join(g) for g in TOY])
def test_plain_fixed_base_matches_reference_device(side, grp):
    """pcd_tpu's FixedBaseDevice (window table, XLA gathers and batched
    complete adds) on JAX-CPU, on the same scalars."""
    cfg, curve, base, rcurve, rbase = _group("toy_cycle", side, grp)
    r, bits = cfg.Fr.MODULUS, cfg.Fr.BITS
    fb = fixed_base_device(curve, base, bits)
    sc = _scalars(r, fb.nwin, 5, grp)
    rfb = RFixedBase(rcurve, rbase, bits)
    assert np.array_equal(fb.digits_from_ints(sc),
                          rfb.digits_from_ints(sc).astype(np.uint8))
    assert [_coords(p) for p in fb.mul_many(sc, "cpu")] == [
        _coords(p) for p in rfb.mul_many(sc)]


def _wraps(r, nwin):
    """Integers s < 2^(8 nwin) whose top digit d and low part L have L =
    +-d 2^(8 (nwin - 1)) mod r: K8's last add doubles (+) or cancels (-)."""
    top = 8 * (nwin - 1)
    out = []
    for d in range(1, 256):
        t = d << top
        for low in (t % r, (-t) % r):
            if low < 1 << top:
                out.append(low + t)
    return out


@pytest.mark.parametrize("cycle,side,grp", [("toy_cycle", "main", "g1"),
                                            ("toy_cycle", "help", "g2"),
                                            ("mnt_cycle", "main", "g1")])
def test_top_window_wrap(cycle, side, grp):
    cfg, curve, base, _, rbase = _group(cycle, side, grp)
    r = cfg.Fr.MODULUS
    fb = fixed_base_device(curve, base, cfg.Fr.BITS)
    sc = _wraps(r, fb.nwin)
    # both a cancel (s = 0 mod r) and a doubling
    assert {s % r == 0 for s in sc} == {True, False}
    sc = sc[:3] + sc[-3:]
    got = fb.mul_many(sc, "cpu")
    want = ref_fixed_base_many(rbase, [s % r for s in sc], cfg.Fr.BITS)
    assert [_coords(p) for p in got] == [_coords(p) for p in want]
    assert any(p.is_infinity() for p in got)


def test_digits_and_width():
    cfg = TM.mnt4_298()
    fb = fixed_base_device(cfg.g1, cfg.g1_gen, cfg.Fr.BITS)
    assert fb.nwin == 38
    s = (3 << 296) | 0xABCD
    dg = fb.digits_from_ints([s, 0])
    assert dg.shape == (38, 2) and dg.dtype == np.uint8
    assert list(dg[:, 0]) == [0xCD, 0xAB] + [0] * 35 + [3]
    with pytest.raises(OverflowError):
        fb.digits_from_ints([1 << 304])
    with pytest.raises(ValueError):
        fb.mul_digits(torch.zeros((37, 4), dtype=torch.uint8))
    # the cache is keyed by the curve's name and the base, not its id
    again = copy.copy(cfg.g1)
    assert again is not cfg.g1
    assert fixed_base_device(again, cfg.g1_gen, cfg.Fr.BITS) is fb
    assert fixed_base_device(cfg.g1, cfg.g1_gen * 2, cfg.Fr.BITS) is not fb


@pytest.mark.parametrize("cycle,side,grp", [
    ("toy_cycle", "main", "g1"), ("toy_cycle", "main", "g2"),
    ("toy_cycle", "help", "g2"), ("mnt_cycle", "main", "g1"),
    ("mnt_cycle", "main", "g2"), ("mnt_cycle", "help", "g2")])
def test_inv_plain_matches_pow(cycle, side, grp):
    curve = getattr(getattr(getattr(TM, cycle)(), side), grp)
    F = curve.F
    f = ec_ctx(curve).f
    p, d = f.p, f.d
    rng = random.Random(d)
    vals = [[0] * d, [1] + [0] * (d - 1), [p - 1] * d] + [
        [rng.randrange(p) for _ in range(d)] for _ in range(5)]
    limbs = torch.from_numpy(ints_to_limbs(
        [v * f.r % p for e in vals for v in e]).view(np.int32)).reshape(
        len(vals), d, 10)
    inv = f.inv_plain(f.to_plain(limbs).movedim(-1, 1))   # (nd, d, n)
    got = limbs_to_ints(f.canonical_plain(inv).permute(1, 0, 2).numpy())
    for i, e in enumerate(vals):
        if d == 1:
            want = [pow(e[0], p - 2, p)]
        elif not any(e):
            want = [0] * d
        else:
            prime = F.prime_subfield()
            w = F.from_prime_coeffs([prime(v) for v in e]).inv()
            want = [int(c.n) for c in w.to_prime_coeffs()]
        assert got[i * d:(i + 1) * d] == want, i


def test_fieldctx_pow_plain():
    f = FieldCtx(TM.toy_mnt4().Fq.MODULUS)
    p = f.p
    a = torch.from_numpy(ints_to_limbs([5 * f.r % p, 7 * f.r % p]).view(
        np.int32))
    for e in (1, 2, 3, 255, p - 2):
        got = limbs_to_ints(f.canonical_plain(f.pow_plain(f.to_plain(a), e))
                            .numpy())
        assert got == [pow(5, e, p), pow(7, e, p)], e


@pytest.fixture
def device_keygen_on_cpu(monkeypatch):
    """KEYGEN "device" with the CPU let through to K8's plain version."""
    monkeypatch.setattr(msm_dispatch, "KEYGEN", "device")
    monkeypatch.setattr(msm_dispatch, "on_card",
                        lambda dev: dev is not None)


@pytest.mark.parametrize("snark,per_side", [("groth16", (4, 1)),
                                             ("gm17", (3, 1))])
def test_device_keygen_setup_equals_host(snark, per_side, monkeypatch):
    """A toy-MNT4 setup of a squaring chain of 80 constraints: the same
    seed gives the same pk bytes under either tier; under "device" every
    query vector of KEYGEN_MIN scalars or more (Groth16: a, b_g1, l, h in
    G1, b_g2 in G2; GM17: a, c, h and b) is one K8 call."""
    cls = {"groth16": Groth16, "gm17": GM17}[snark]
    to_bytes = getattr(TS, f"{snark}_pk_to_bytes")
    cfg = TM.toy_mnt4()
    blobs = {}
    for tier in ("host", "device"):
        monkeypatch.setattr(msm_dispatch, "KEYGEN", tier)
        monkeypatch.setattr(msm_dispatch, "on_card",
                            lambda dev: dev is not None)
        tec.reset_launch_counts()
        pk, _ = cls(cfg, device="cpu").circuit_specific_setup(
            SquareChain(3, 80), ChaChaRng(b"keygen " + snark.encode()))
        blobs[tier] = to_bytes(pk)
        calls = {f: v for (k, f), v in tec.plain_counts().items()
                 if k == "fixed_base_mul"}
        assert calls == ({} if tier == "host" else {
            cfg.g1.name: per_side[0], cfg.g2.name: per_side[1]}), tier
        assert tec.launch_counts() == {}
    assert blobs["host"] == blobs["device"]


def test_fb_mul_dispatch(device_keygen_on_cpu, monkeypatch):
    cfg = TM.toy_mnt4()
    r = cfg.Fr.MODULUS
    sc = [random.Random(1).randrange(r) for _ in range(64)]
    want = ref_fixed_base_many(RM.toy_mnt4().g1_gen, sc, cfg.Fr.BITS)
    cpu = torch.device("cpu")
    tec.reset_launch_counts()
    got = msm_dispatch.fb_mul(cfg, "g1", sc, cfg.Fr.BITS, cpu)
    assert tec.plain_counts() == {("fixed_base_mul", cfg.g1.name): 1}
    assert [_coords(p) for p in got] == [_coords(p) for p in want]
    tec.reset_launch_counts()
    # fewer than KEYGEN_MIN scalars, or no device: the host path
    msm_dispatch.fb_mul(cfg, "g1", sc[:63], cfg.Fr.BITS, cpu)
    msm_dispatch.fb_mul(cfg, "g1", sc, cfg.Fr.BITS, None)
    monkeypatch.undo()
    assert msm_dispatch.KEYGEN in ("host", "device")
    # the CPU itself keeps the host path by default, whatever KEYGEN says
    monkeypatch.setattr(msm_dispatch, "KEYGEN", "device")
    msm_dispatch.fb_mul(cfg, "g1", sc, cfg.Fr.BITS, cpu)
    assert tec.plain_counts() == {}
    monkeypatch.setattr(msm_dispatch, "KEYGEN", "card")
    with pytest.raises(ValueError):
        msm_dispatch.fb_mul(cfg, "g1", sc, cfg.Fr.BITS, cpu)
