"""The port's Marlin + KZG10 (pcd_tpu_torch/snark/marlin) against
pcd_tpu's, on the CPU with the plain versions of the kernels:

  - Poseidon: the port's native sponge against pcd_tpu's, its gadget
    against its own native sponge;
  - KZG10 on toy MNT4 and MNT6 (host MSMs): commitments, degree-bound
    shadows, opens and open_batch equal pcd_tpu's, and the checks reject a
    wrong value;
  - a KZG MSM through the stream tier's plain versions (STREAM_MIN at 0)
    over the rows [offset, offset + n) equals the host MSM over the same
    rows, on toy G1 and MNT4-298 G1, and an open of 4,096 coefficients or
    more sends its quotient through the stream tier;
  - Marlin proofs from a ChaChaRng in the same state are byte-equal to
    pcd_tpu's on toy MNT4/MNT6 and MNT4-298/MNT6-298, with every commit
    MSM on the plain K1/K4 (one of each per MSM), the index key carried
    over through convert in the port's pk layout;
  - with fft_any's device dispatch forced onto the CPU (its threshold
    lowered, the CPU let through), the index's 9 and the prove's 8
    transforms run on K5's plain version and the index key and proof
    are byte-equal to pcd_tpu's, on toy MNT4/MNT6 and MNT4-298;
  - the vk and proof layouts against pcd_tpu's writers, and the
    universal-setup retry (NeedLargerBound);
  - a stream MSM that raises propagates out of prove: no latch, no host
    retry;
  - (slow, as pcd_tpu's own) the toy Marlin PCD chain through convert,
    its KZG MSMs on the host tier.
"""

import random
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.gadgets.fp import fpvar_class as rfpvar  # noqa: E402
from pcd_tpu.snark.api import NeedLargerBound as RNeedLargerBound  # noqa
from pcd_tpu.snark.marlin.kzg import KZG10 as RKZG  # noqa: E402
from pcd_tpu.snark.marlin.native import MarlinBound as RBound  # noqa: E402
from pcd_tpu.snark.marlin.native import MarlinSNARK as RMarlin  # noqa: E402
from pcd_tpu.snark.marlin.poseidon import PoseidonSponge as RSponge  # noqa
from pcd_tpu.utils import serialize as RS  # noqa: E402
from pcd_tpu.utils.rng import ChaChaRng as RRng  # noqa: E402
from pcd_tpu_torch import convert  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.gadgets.fp import fpvar_class as tfpvar  # noqa: E402
from pcd_tpu_torch.ops import ec as tec  # noqa: E402
from pcd_tpu_torch.r1cs.system import ConstraintSystem  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402
from pcd_tpu_torch.snark.marlin import ahp as tahp  # noqa: E402
from pcd_tpu_torch.snark.api import NeedLargerBound  # noqa: E402
from pcd_tpu_torch.snark.marlin import kzg as tkzg  # noqa: E402
from pcd_tpu_torch.snark.marlin.kzg import KZG10  # noqa: E402
from pcd_tpu_torch.snark.marlin.native import MarlinBound  # noqa: E402
from pcd_tpu_torch.snark.marlin.native import MarlinSNARK  # noqa: E402
from pcd_tpu_torch.snark.marlin.poseidon import PoseidonSponge  # noqa
from pcd_tpu_torch.utils import serialize as TS  # noqa: E402
from pcd_tpu_torch.utils.rng import ChaChaRng as TRng  # noqa: E402

from _torch_support import reference_native_loaded  # noqa: E402,F401
from _torch_support import two_torch_threads  # noqa: E402,F401

TOY = ["toy_mnt4", "toy_mnt6"]
# the universal SRS of the streamed Marlin tests: a table under the C++
# tier's encoding threshold (32 points) stays a host list, which the
# stream tier refuses
SRS_DEGREE = 64


def mul_circuit(fpvar_class):
    """pcd_tpu's tests/test_marlin.py MulCircuit over either package's
    FpVar: x = a b public, a^2 witnessed."""

    class MulCircuit:
        def __init__(self, a=4, b=6):
            self.a, self.b = a, b

        def generate_constraints(self, cs):
            V = fpvar_class(cs)
            x = V.new_instance((self.a * self.b) % cs.p)
            a = V.new_witness(self.a)
            b = V.new_witness(self.b)
            (a * b).enforce_equal(x)
            (a * a).enforce_equal(V.new_witness(self.a * self.a))

    return MulCircuit


RMul, TMul = mul_circuit(rfpvar), mul_circuit(tfpvar)


def pt_bytes(pt):
    """A point of either package in the shared serialize layout."""
    out = []
    (TS if type(pt).__module__.startswith("pcd_tpu_torch") else RS) \
        ._write_point(out, pt)
    return b"".join(out)


@pytest.fixture
def plain_stream(monkeypatch):
    """Every KZG MSM on the stream tier's plain versions, the windows of
    2 bits on 128 lanes (the fewest torch adds for the tests' short MSMs;
    the card's 12 and 8192 cost the plain versions far more here).
    Returns the list the stream MSMs' sizes are recorded in."""
    monkeypatch.setattr(KZG10, "STREAM_MIN", 0)
    monkeypatch.setattr(msm_dispatch, "WINDOW_BITS", 2)
    monkeypatch.setattr(msm_dispatch, "LANES", 128)
    sizes = []
    orig = KZG10._stream_msm

    def recorded(self, srs, offset, scalars):
        out = orig(self, srs, offset, scalars)
        if out is not None:
            sizes.append(len(scalars))
        return out

    monkeypatch.setattr(KZG10, "_stream_msm", recorded)
    tec.reset_launch_counts()
    return sizes


def assert_one_k1_k4_per_msm(curve, sizes):
    plain = tec.plain_counts()
    assert sizes
    assert plain == {("madd_accumulate", curve.name): len(sizes),
                     ("bucket_finish", curve.name): len(sizes)}
    assert tec.launch_counts() == {}


# -- Poseidon --------------------------------------------------------------
@pytest.mark.parametrize("field", ["toy_mnt4.Fr", "mnt4_298.Fq"])
def test_poseidon_matches_reference(field):
    """Absorb, squeeze, absorb again, nonnative absorb and a 128-bit
    challenge: the port's sponge gives pcd_tpu's values."""
    cname, fname = field.split(".")
    RF = getattr(getattr(RM, cname)(), fname)
    TF = getattr(getattr(TM, cname)(), fname)
    NF = getattr(TM, cname)().Fr
    got = []
    for F, sponge, nf in ((RF, RSponge, getattr(RM, cname)().Fr),
                          (TF, PoseidonSponge, NF)):
        sp = sponge(F)
        sp.absorb([F.from_int(v) for v in (7, 9, 11)])
        a = [e.n for e in sp.squeeze(3)]
        sp.absorb([F.from_int(2)])
        sp.absorb_nonnative([nf.from_int(v) for v in (5, nf.MODULUS - 1)],
                            nf.BITS)
        got.append((a, [e.n for e in sp.squeeze(2)],
                    sp.squeeze_challenge_int(128)))
    assert got[0] == got[1]


def test_poseidon_gadget_matches_native():
    cfg = TM.toy_mnt4()
    sp = PoseidonSponge(cfg.Fr)
    sp.absorb([cfg.Fr.from_int(i) for i in (7, 9, 11)])
    native = [e.n for e in sp.squeeze(3)]
    cs = ConstraintSystem(cfg.Fr)
    V = tfpvar(cs)
    spv = PoseidonSponge(V)
    spv.absorb([V.new_witness(i) for i in (7, 9, 11)])
    assert [e.val for e in spv.squeeze(3)] == native
    assert cs.is_satisfied()


# -- KZG10 -----------------------------------------------------------------
def _kzg_pair(cfg_name, degree, seed=b"kzg port"):
    rcfg, tcfg = getattr(RM, cfg_name)(), getattr(TM, cfg_name)()
    rk, tk = RKZG(rcfg), KZG10(tcfg, device="cpu")
    rsrs, tsrs = rk.setup(degree, RRng(seed)), tk.setup(degree, TRng(seed))
    assert [pt_bytes(p) for p in tsrs.powers_g1] \
        == [pt_bytes(p) for p in rsrs.powers_g1]
    assert pt_bytes(tsrs.tau_h) == pt_bytes(rsrs.tau_h)
    return tcfg, rk, tk, rsrs, tsrs


@pytest.mark.parametrize("cfg_name", TOY)
def test_kzg_matches_reference(cfg_name):
    """Host MSMs (below STREAM_MIN): commit with a degree-bound shadow,
    open and open_batch with a symbolic shift give pcd_tpu's points and
    values; the checks accept them and reject a wrong value."""
    tcfg, rk, tk, rsrs, tsrs = _kzg_pair(cfg_name, 40)
    p = tcfg.Fr.MODULUS
    rng = np.random.default_rng(5)
    polys = [[int(v) for v in rng.integers(0, p, n)] for n in (20, 33, 9)]
    z, xi = int(rng.integers(1, p)), int(rng.integers(1, p))
    for coeffs in polys:
        tc, rc = (k.commit(s, coeffs, degree_bound=32)
                  for k, s in ((tk, tsrs), (rk, rsrs)))
        assert pt_bytes(tc.c) == pt_bytes(rc.c)
        assert pt_bytes(tc.shifted) == pt_bytes(rc.shifted)
        (ty, tpi), (ry, rpi) = (k.open(s, coeffs, z)
                                for k, s in ((tk, tsrs), (rk, rsrs)))
        assert ty == ry and pt_bytes(tpi) == pt_bytes(rpi)
        assert tk.check(tsrs, tc, z, ty, tpi)
        assert not tk.check(tsrs, tc, z, (ty + 1) % p, tpi)
    batch = polys + [(40 - 32, polys[0])]
    (tv, tpi), (rv, rpi) = (k.open_batch(s, batch, z, xi)
                            for k, s in ((tk, tsrs), (rk, rsrs)))
    assert tv == rv and pt_bytes(tpi) == pt_bytes(rpi)
    comms = [tk.commit(tsrs, c) for c in polys]
    comms.append(tkzg.KZGCommitment(c=tk.commit(tsrs, polys[0],
                                                degree_bound=32).shifted))
    assert tk.check_batch(tsrs, comms, z, tv, tpi, xi)
    bad = list(tv)
    bad[1] = (bad[1] + 1) % p
    assert not tk.check_batch(tsrs, comms, z, bad, tpi, xi)


@pytest.mark.parametrize("cfg_name", ["toy_mnt4", "mnt4_298"])
def test_kzg_stream_at_offset(cfg_name, plain_stream):
    """A commit and its degree-bound shadow on the stream tier: rows [0,
    n) and [D - d, D - d + n) of the SRS, each equal to the host MSM
    over the same rows, one K1 and one K4 each."""
    tcfg = getattr(TM, cfg_name)()
    tk = KZG10(tcfg, device="cpu")
    srs = tk.setup(40, TRng(b"kzg stream"))
    draw = random.Random(6)
    coeffs = [draw.randrange(tcfg.Fr.MODULUS) for _ in range(7)]
    comm = tk.commit(srs, coeffs, degree_bound=10)
    powers = msm_dispatch.host_query(srs, "powers_g1")
    off = 40 - 10
    assert comm.c == msm_dispatch.msm_any(
        msm_dispatch.subrange(powers, 0, 7), coeffs)
    assert comm.shifted == msm_dispatch.msm_any(
        msm_dispatch.subrange(powers, off, off + 7), coeffs)
    assert plain_stream == [7, 7]
    assert_one_k1_k4_per_msm(tcfg.g1, plain_stream)


def test_kzg_large_open_through_stream(plain_stream):
    """From 4,096 coefficients up, open divides in the C++ tier and
    commits the quotient through _stream_msm: pcd_tpu's value and
    witness, one K1 and one K4."""
    tcfg, rk, tk, rsrs, tsrs = _kzg_pair("toy_mnt4", 4200, b"kzg open")
    p = tcfg.Fr.MODULUS
    rng = np.random.default_rng(7)
    coeffs = [int(v) for v in rng.integers(0, p, 4100)]
    z = int(rng.integers(1, p))
    ty, tpi = tk.open(tsrs, coeffs, z)
    ry, rpi = rk.open(rsrs, coeffs, z)
    assert ty == ry and pt_bytes(tpi) == pt_bytes(rpi)
    assert plain_stream == [4099]
    assert_one_k1_k4_per_msm(tcfg.g1, plain_stream)


@pytest.mark.parametrize("cfg_name", ["toy_mnt4", "mnt4_298"])
def test_kzg_host_primitives(cfg_name):
    """The C++ primitives KZG10 and the AHP take from 4,096 coefficients
    up, against Python ints and pcd_tpu's poly_eval: poly_div_linear and
    poly_eval_mod (opens), vec_axpy (open_batch), and the limb NTT product
    of ahp.poly_mul_fft, held to a(z) b(z) at a random z."""
    from pcd_tpu.poly.domain import poly_eval
    from pcd_tpu_torch import native
    from pcd_tpu_torch.snark.marlin.ahp import poly_mul_fft

    Fr = getattr(TM, cfg_name)().Fr
    p = Fr.MODULUS
    draw = random.Random(9)
    coeffs = [draw.randrange(p) for _ in range(4100)]
    z, s = draw.randrange(p), draw.randrange(p)
    q, y = native.poly_div_linear(p, coeffs, z)
    want_q, acc = [0] * (len(coeffs) - 1), 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (coeffs[i] + acc * z) % p
        want_q[i - 1] = acc
    assert native.limbs_to_ints(q) == want_q
    assert y == native.poly_eval_mod(p, coeffs, z) == poly_eval(coeffs, z, p)
    acc = native.scalars_to_limbs(coeffs[::-1])
    native.vec_axpy(p, acc, coeffs, s)
    assert native.limbs_to_ints(acc) == [(a + s * b) % p for a, b in
                                         zip(coeffs[::-1], coeffs)]
    a, b = coeffs[:2100], coeffs[2100:]
    prod = poly_mul_fft(Fr, a, b)
    assert len(prod) == len(a) + len(b) - 1
    assert poly_eval(prod, z, p) == poly_eval(a, z, p) * poly_eval(b, z, p) % p


# -- Marlin ------------------------------------------------------------------
def ref_marlin_pk_bytes(pk, Fr):
    """pcd_tpu's Marlin index key in the port's checkpoint layout
    (serialize.marlin_pk_to_bytes), written with pcd_tpu's own point,
    query and vk writers."""
    vk_b = RS.marlin_vk_to_bytes(pk.vk)
    out = [struct.pack("<Q", len(vk_b)), vk_b]
    idx = pk.index
    out.append(struct.pack("<5Q", idx.n, idx.k_size, idx.input_size,
                           idx.num_instance, idx.num_vars))
    out.append(struct.pack(f"<Q{len(idx.col_map)}I", len(idx.col_map),
                           *idx.col_map))

    def frs(vals):
        out.append(struct.pack("<Q", len(vals)))
        out.extend(Fr.from_int(v).to_bytes() for v in vals)

    for name in "ABC":
        m = idx.mats[name]
        for vec in (m.row, m.col, m.val, m.row_evals, m.col_evals,
                    m.val_evals):
            frs(vec)
        entries = idx.rows_cols_vals[name]
        out.append(struct.pack("<Q", len(entries)))
        for r, c, v in entries:
            out.append(struct.pack("<II", r, c) + Fr.from_int(v).to_bytes())
    qo = []
    RS._write_query(qo, pk.srs.powers_g1)
    blob = b"".join(qo)
    out += [struct.pack("<Q", len(blob)), blob]
    RS._write_point(out, pk.srs.h)
    RS._write_point(out, pk.srs.tau_h)
    out.append(struct.pack("<Q", pk.srs.max_degree))
    return b"".join(out)


def _u8(b):
    return np.frombuffer(b, dtype=np.uint8)


@pytest.mark.parametrize("cfg_name", TOY + ["mnt4_298", "mnt6_298"])
def test_marlin_proof_matches_reference(cfg_name, plain_stream):
    """pcd_tpu indexes MulCircuit and proves; the port takes the index key
    through convert (written back to the same bytes), proves from a
    ChaChaRng in the same state with every commit MSM on the plain K1/K4
    (the opens, under 4,096 coefficients, take the host MSM as in
    pcd_tpu), and gets the same proof bytes; it verifies, and a wrong
    input is rejected."""
    rcfg, tcfg = getattr(RM, cfg_name)(), getattr(TM, cfg_name)()
    rm, tm = RMarlin(rcfg), MarlinSNARK(tcfg, device="cpu")
    rpk, rvk = rm.index(rm.universal_setup(RBound(SRS_DEGREE),
                                           RRng(b"marlin setup")), RMul())
    pk_blob = ref_marlin_pk_bytes(rpk, rcfg.Fr)
    tpk = convert.marlin_pk_from_reference(tm, _u8(pk_blob))
    assert TS.marlin_pk_to_bytes(tcfg, tpk) == pk_blob
    tvk = convert.marlin_vk_from_reference(tm,
                                           _u8(RS.marlin_vk_to_bytes(rvk)))
    ref = rm.prove(rpk, RMul(3, 7), RRng(b"marlin prove"))
    proof = tm.prove(tpk, TMul(3, 7), TRng(b"marlin prove"))
    assert TS.marlin_proof_to_bytes(proof, tcfg.Fr) \
        == RS.marlin_proof_to_bytes(ref, rcfg.Fr)
    # 6 round-1, 3 round-2 and 9 round-3 commits streamed
    assert len(plain_stream) == 18
    assert_one_k1_k4_per_msm(tcfg.g1, plain_stream)
    assert tm.verify(tvk, [tcfg.Fr.from_int(21)], proof)
    assert not tm.verify(tvk, [tcfg.Fr.from_int(22)], proof)


@pytest.mark.parametrize("cfg_name", TOY + ["mnt4_298"])
def test_marlin_device_fft_matches_reference(cfg_name, monkeypatch):
    """fft_any's device branch on the CPU: the threshold lowered to 2
    points and the CPU routed to it, so every transform of the port's own
    index and prove runs through fft_ctx on K5's plain version (and K7's
    Montgomery conversions): 9 in the index, 8 in the prove (round 1's
    three Mz and z, round 2's r, round 3's three f).  The index key (from
    the same universal-setup rng) and the proof are byte-equal to
    pcd_tpu's, which runs every transform on the host."""
    monkeypatch.setattr(tahp, "_DEVICE_FFT_THRESHOLD", 2)
    monkeypatch.setattr(tahp, "on_card", lambda dev: dev is not None)
    rcfg, tcfg = getattr(RM, cfg_name)(), getattr(TM, cfg_name)()
    rm, tm = RMarlin(rcfg), MarlinSNARK(tcfg, device="cpu")
    rpk, rvk = rm.index(rm.universal_setup(RBound(SRS_DEGREE),
                                           RRng(b"marlin fft")), RMul())
    tahp.DEVICE_FFTS.clear()
    tec.reset_launch_counts()
    tpk, tvk = tm.index(tm.universal_setup(MarlinBound(SRS_DEGREE),
                                           TRng(b"marlin fft")), TMul())
    assert tahp.DEVICE_FFTS == {("ifft", False): 9}
    assert TS.marlin_pk_to_bytes(tcfg, tpk) == ref_marlin_pk_bytes(
        rpk, rcfg.Fr)
    tahp.DEVICE_FFTS.clear()
    ref = rm.prove(rpk, RMul(3, 7), RRng(b"marlin fft prove"))
    proof = tm.prove(tpk, TMul(3, 7), TRng(b"marlin fft prove"))
    assert tahp.DEVICE_FFTS == {("ifft", False): 8}
    assert TS.marlin_proof_to_bytes(proof, tcfg.Fr) \
        == RS.marlin_proof_to_bytes(ref, rcfg.Fr)
    passes = sum(v for (k, _), v in tec.plain_counts().items()
                 if k == "ntt_pass")
    assert passes >= 17 and tec.launch_counts() == {}
    assert tm.verify(tvk, [tcfg.Fr.from_int(21)], proof)
    assert not tm.verify(tvk, [tcfg.Fr.from_int(22)], proof)


def test_fft_any_host_by_default():
    """Without a card the AHP keeps the host path: a CPU device, or none,
    never reaches the device NTT at any size."""
    Fr = TM.toy_mnt4().Fr
    vec = list(range(1, 40))
    want = tahp.fft_any(Fr, vec, 64, "ifft")
    tahp.DEVICE_FFTS.clear()
    for dev in (None, torch.device("cpu")):
        assert tahp.fft_any(Fr, vec, 64, "ifft", device=dev) == want
        assert MarlinSNARK(TM.toy_mnt4(), device="cpu").ahp.device == \
            torch.device("cpu")
    assert not tahp.DEVICE_FFTS


def test_marlin_layouts_match_reference():
    """The port's own setup and prove on toy MNT4 give pcd_tpu's vk and
    proof bytes, under the SNARK and PCD entry points, and read back; a
    tampered sigma3 or evaluation is rejected."""
    rcfg, tcfg = RM.toy_mnt4(), TM.toy_mnt4()
    rm, tm = RMarlin(rcfg), MarlinSNARK(tcfg, device="cpu")
    rpk, rvk = rm.circuit_specific_setup(RMul(), RRng(b"layouts"))
    tpk, tvk = tm.circuit_specific_setup(TMul(), TRng(b"layouts"))
    vk_b = TS.snark_vk_to_bytes(tm, tvk)
    assert vk_b == RS.snark_vk_to_bytes(rm, rvk)
    assert TS.marlin_vk_to_bytes(TS.snark_vk_from_bytes(tm, vk_b)) == vk_b
    proof = tm.prove(tpk, TMul(5, 5), TRng(b"layouts p"))
    ref = rm.prove(rpk, RMul(5, 5), RRng(b"layouts p"))
    pb = TS.snark_proof_to_bytes(tm, proof)
    assert pb == RS.snark_proof_to_bytes(rm, ref)
    back = TS.snark_proof_from_bytes(tm, pb)
    assert TS.snark_proof_to_bytes(tm, back) == pb
    x = tcfg.Fr.from_int(25)
    assert tm.verify(tvk, [x], back)
    bad = proof.clone()
    bad.sigma3 = (bad.sigma3 + 1) % tcfg.Fr.MODULUS
    assert not tm.verify(tvk, [x], bad)
    bad = proof.clone()
    bad.evals = dict(proof.evals)
    bad.evals["g_3A"] = (proof.evals["g_3A"] + 1) % tcfg.Fr.MODULUS
    assert not tm.verify(tvk, [x], bad)


def test_marlin_universal_setup_retry():
    """An SRS too small for the circuit raises NeedLargerBound with
    pcd_tpu's bound; the SRS of that bound indexes to pcd_tpu's vk."""
    rcfg, tcfg = RM.toy_mnt4(), TM.toy_mnt4()
    rm, tm = RMarlin(rcfg), MarlinSNARK(tcfg, device="cpu")
    rrng, trng = RRng(b"universal"), TRng(b"universal")
    small = (rm.universal_setup(RBound(max_degree=4), rrng),
             tm.universal_setup(MarlinBound(max_degree=4), trng))
    with pytest.raises(RNeedLargerBound) as rexc:
        rm.index(small[0], RMul())
    with pytest.raises(NeedLargerBound) as texc:
        tm.index(small[1], TMul())
    assert texc.value.bound.max_degree == rexc.value.bound.max_degree > 4
    assert tm.circuit_degree(TMul()) == texc.value.bound.max_degree
    _, rvk = rm.index(rm.universal_setup(rexc.value.bound, rrng), RMul())
    _, tvk = tm.index(tm.universal_setup(texc.value.bound, trng), TMul())
    assert TS.marlin_vk_to_bytes(tvk) == RS.marlin_vk_to_bytes(rvk)


def test_stream_failure_propagates(plain_stream, monkeypatch):
    """A stream MSM that raises inside _stream_msm raises out of prove,
    with no host MSM in its place; the next prove streams again (nothing
    latched the stream tier off)."""
    tcfg = TM.toy_mnt4()
    tm = MarlinSNARK(tcfg, device="cpu")
    tpk, tvk = tm.index(tm.universal_setup(MarlinBound(SRS_DEGREE),
                                           TRng(b"fault")), TMul())
    host = []
    orig_host = tkzg.msm_any
    monkeypatch.setattr(tkzg, "msm_any",
                        lambda q, s: host.append(len(s)) or orig_host(q, s))
    orig_k1 = tec.ECCtx.madd_accumulate

    def broken(self, *args):
        raise RuntimeError("injected stream fault")

    monkeypatch.setattr(tec.ECCtx, "madd_accumulate", broken)
    with pytest.raises(RuntimeError, match="injected stream fault"):
        tm.prove(tpk, TMul(3, 7), TRng(b"fault p"))
    assert host == []
    monkeypatch.setattr(tec.ECCtx, "madd_accumulate", orig_k1)
    del plain_stream[:]
    tec.reset_launch_counts()
    proof = tm.prove(tpk, TMul(3, 7), TRng(b"fault p"))
    assert len(plain_stream) == 18
    assert_one_k1_k4_per_msm(tcfg.g1, plain_stream)
    assert tm.verify(tvk, [tcfg.Fr.from_int(21)], proof)


# -- the toy PCD chain -------------------------------------------------------
def ref_pcd_pk_bytes(rpcd, pk):
    """pcd_tpu's Marlin PCD pk in the port's frame: the seed, then the
    main and help index keys and the help vk, u64-length-prefixed."""
    ic = rpcd.ic
    seed = pk.crh_pp.seed
    out = [struct.pack("<I", len(seed)), seed]
    for blob in (ref_marlin_pk_bytes(pk.main_pk, ic.cycle.main.Fr),
                 ref_marlin_pk_bytes(pk.help_pk, ic.cycle.help.Fr),
                 RS.marlin_vk_to_bytes(pk.help_vk)):
        out += [struct.pack("<Q", len(blob)), blob]
    return b"".join(out)


@pytest.mark.slow
def test_toy_marlin_chain_matches_reference(monkeypatch):
    """configs.toy_marlin: pcd_tpu sets up the Counter chain and proves
    twice; the port takes the keys through convert and proves from a
    ChaChaRng in the same state: the same proof bytes, both verify, the
    old message is rejected.  The KZG MSMs stay on the host tier here
    (STREAM_MIN above every MSM): the chain's SRS-length MSMs on the
    plain versions would take hours on the CPU, and the tests above hold
    the stream tier.  Slow, as pcd_tpu's own toy Marlin chains are: the
    Marlin verifier circuit is about 90k constraints even on the toy
    cycle."""
    from pcd_tpu import configs as RC
    from pcd_tpu.pcd.api import FpPredicate as RPredicate
    from pcd_tpu_torch import configs as TC
    from pcd_tpu_torch.pcd.api import FpPredicate as TPredicate

    from _torch_support import predicate

    rpcd = RC.toy_marlin()
    F = rpcd.ic.main_field
    rpred = predicate(RPredicate, F)
    pk, vk = rpcd.circuit_specific_setup(rpred, RRng(b"marlin chain setup"))
    rng = RRng(b"marlin chain prove")
    one = F.from_int(1)
    ref1 = rpcd.prove(pk, rpred, one, one, [], [], rng)
    ref2 = rpcd.prove(pk, rpred, F.from_int(2), one, [one], [ref1], rng)

    monkeypatch.setattr(KZG10, "STREAM_MIN", 1 << 62)
    tpcd = TC.toy_marlin(device="cpu")
    TF = tpcd.ic.main_field
    tpred = predicate(TPredicate, TF)
    blob = ref_pcd_pk_bytes(rpcd, pk)
    tpk = convert.pcd_pk_from_reference(tpcd, _u8(blob))
    assert TS.pcd_pk_to_bytes(tpcd, tpk) == blob
    seed = vk.crh_pp.seed
    vk_blob = (struct.pack("<I", len(seed)) + seed
               + RS.marlin_vk_to_bytes(vk.help_vk))
    tvk = convert.pcd_vk_from_reference(tpcd, _u8(vk_blob))
    assert TS.pcd_vk_to_bytes(tpcd, tvk) == vk_blob
    rng = TRng(b"marlin chain prove")
    one_t = TF.from_int(1)
    p1 = tpcd.prove(tpk, tpred, one_t, one_t, [], [], rng)
    p2 = tpcd.prove(tpk, tpred, TF.from_int(2), one_t, [one_t], [p1], rng)
    assert TS.pcd_proof_to_bytes(tpcd, p1) == RS.pcd_proof_to_bytes(rpcd,
                                                                    ref1)
    assert TS.pcd_proof_to_bytes(tpcd, p2) == RS.pcd_proof_to_bytes(rpcd,
                                                                    ref2)
    assert tpcd.verify(tvk, tpred, one_t, p1)
    assert tpcd.verify(tvk, tpred, TF.from_int(2), p2)
    assert not tpcd.verify(tvk, tpred, one_t, p2)
