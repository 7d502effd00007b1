"""The port's GM17 (pcd_tpu_torch/snark/gm17) against pcd_tpu's, on the
CPU with the plain versions of the kernels:

  - the toy PCD chains of toy_gm17 and both mixed Groth16/GM17 configs:
    pcd_tpu runs setup and two proves, the port takes its proving key
    through convert.pcd_pk_from_reference and proves from a ChaChaRng in
    the same state with every commitment MSM on its stream tier; the
    proof bytes must be equal, the chain verifies and rejects the old
    message, and K1 runs exactly once per commitment MSM (GM17: a, c, h
    in G1 and b in G2; Groth16: a, b1, l, h in G1 and b2 in G2);
  - the GM17 SNARK alone on toy MNT4 and MNT6, on the host tier and
    streamed, byte-equal to pcd_tpu's;
  - the GM17 proof, vk and pk layouts against pcd_tpu's writers;
  - a streamed prove missing any one of its four MSMs raises;
  - the device quotient tier (msm_dispatch.QUOTIENT = "device": K6, K7's
    SAP evaluations, the squaring hpoly on K5 and K7), host-MSM and
    streamed: the same proof bytes as pcd_tpu's host-tier prove, and a
    replayed unsatisfied witness raises SNARKError.
"""

import struct

import pytest

torch = pytest.importorskip("torch")

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.snark.gm17.native import GM17 as RGM17  # noqa: E402
from pcd_tpu.utils import serialize as RS  # noqa: E402
from pcd_tpu.utils.rng import ChaChaRng as RRng  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.gadgets.fp import fpvar_class  # noqa: E402
from pcd_tpu_torch.ops import ec as tec  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402
from pcd_tpu_torch.snark.gm17.native import GM17  # noqa: E402
from pcd_tpu_torch.utils import serialize as TS  # noqa: E402
from pcd_tpu_torch.utils.rng import ChaChaRng as TRng  # noqa: E402

from _torch_support import ReplayChain, SquareChain  # noqa: E402
from _torch_support import reference_native_loaded  # noqa: E402,F401
from _torch_support import toy_chain_matches_reference  # noqa: E402
from _torch_support import two_torch_threads  # noqa: E402,F401


def _ref_gm17_pk_bytes(pk):
    """pcd_tpu's GM17 pk in the port's checkpoint layout, written with
    pcd_tpu's own point, query and vk writers."""
    vk_b = RS.gm17_vk_to_bytes(pk.vk)
    out = [struct.pack("<Q", len(vk_b)), vk_b]
    RS._write_point(out, pk.delta_g1)
    RS._write_point(out, pk.delta_g2)
    for q in (pk.a_query, pk.b_query, pk.c_query, pk.h_query):
        qo = []
        RS._write_query(qo, q)
        blob = b"".join(qo)
        out += [struct.pack("<Q", len(blob)), blob]
    out.append(struct.pack("<III", pk.num_instance, pk.num_vars,
                           pk.domain_size))
    return b"".join(out)


def _ref_pcd_pk_bytes(rpcd, pk):
    """pcd_tpu's PCD pk in the port's frame: the seed, then the main pk,
    the help pk and the help vk, each u64-length-prefixed."""
    ic = rpcd.ic

    def snark_pk(snark, spk):
        if type(snark).__name__ == "GM17":
            return _ref_gm17_pk_bytes(spk)
        return RS.groth16_pk_to_bytes(spk)

    seed = pk.crh_pp.seed
    out = [struct.pack("<I", len(seed)), seed]
    for blob in (snark_pk(ic.main_snark, pk.main_pk),
                 snark_pk(ic.help_snark, pk.help_pk),
                 RS.snark_vk_to_bytes(ic.help_snark, pk.help_vk)):
        out += [struct.pack("<Q", len(blob)), blob]
    return b"".join(out)


@pytest.fixture
def streamed(monkeypatch):
    """Every circuit's commitment MSMs on the stream tier; the toy's MSMs
    take windows of 8 bits on 2048 lanes (the card's 12 and 8192 cost the
    plain versions several times more here)."""
    monkeypatch.setattr(GM17, "STREAM_MIN", 0)
    monkeypatch.setattr(msm_dispatch, "WINDOW_BITS", 8)
    monkeypatch.setattr(msm_dispatch, "LANES", 2048)


@pytest.mark.pcd_toy
@pytest.mark.parametrize("name", ["toy_gm17", "toy_mix_groth16_gm17",
                                  "toy_mix_gm17_groth16"])
def test_toy_chain_matches_reference(name, monkeypatch):
    toy_chain_matches_reference(name, _ref_pcd_pk_bytes, b"torch gm17",
                                monkeypatch)


class MulCircuit:
    """x = a b (public), a + b witnessed (reference tests of gm17)."""

    def __init__(self, a=3, b=5):
        self.a, self.b = a, b

    def generate_constraints(self, cs):
        V = fpvar_class(cs)
        x = V.new_instance((self.a * self.b) % cs.p)
        a = V.new_witness(self.a)
        b = V.new_witness(self.b)
        (a * b).enforce_equal(x)
        (a + b).enforce_equal(V.new_witness(self.a + self.b))


CURVES = ["toy_mnt4", "toy_mnt6"]


def _pair(cfg_name, circuit, setup_seed):
    """pcd_tpu's and the port's GM17 on one toy curve, each set up from a
    ChaChaRng in the same state."""
    rcfg, tcfg = getattr(RM, cfg_name)(), getattr(TM, cfg_name)()
    rg, tg = RGM17(rcfg), GM17(tcfg, device="cpu")
    rpk, rvk = rg.circuit_specific_setup(circuit, RRng(setup_seed))
    tpk, tvk = tg.circuit_specific_setup(circuit, TRng(setup_seed))
    assert TS.gm17_vk_to_bytes(tvk) == RS.gm17_vk_to_bytes(rvk)
    return rcfg, tcfg, rg, tg, rpk, rvk, tpk, tvk


@pytest.mark.parametrize("cfg_name", CURVES)
def test_gm17_snark_matches_reference(cfg_name):
    """The host tier (a circuit below STREAM_MIN): the same proof bytes
    as pcd_tpu's; it verifies, and a wrong input, a tampered A and a
    foreign B are rejected."""
    rcfg, tcfg, rg, tg, rpk, _, tpk, tvk = _pair(cfg_name, MulCircuit(),
                                                 b"gm17 port")
    proof = tg.prove(tpk, MulCircuit(4, 6), TRng(b"gm17 p"))
    ref = rg.prove(rpk, MulCircuit(4, 6), RRng(b"gm17 p"))
    assert TS.gm17_proof_to_bytes(proof) == RS.gm17_proof_to_bytes(ref)
    x = tcfg.Fr.from_int(24)
    assert tg.verify(tvk, [x], proof)
    assert not tg.verify(tvk, [tcfg.Fr.from_int(25)], proof)
    bad = proof.clone()
    bad.a = bad.a + tcfg.g1_gen
    assert not tg.verify(tvk, [x], bad)
    other = tg.prove(tpk, MulCircuit(4, 6), TRng(b"other"))
    frank = proof.clone()
    frank.b = other.b                      # eq. 2 catches it
    assert not tg.verify(tvk, [x], frank)


@pytest.mark.parametrize("cfg_name", CURVES)
def test_streamed_gm17_matches_reference(cfg_name, streamed):
    """All four commitment MSMs on the stream tier, K1 exactly three
    times in G1 and once in G2, and the same proof bytes as pcd_tpu's
    host-tier prove."""
    rcfg, tcfg, rg, tg, rpk, _, tpk, tvk = _pair(cfg_name, SquareChain(),
                                                 b"gm17 stream")
    tec.reset_launch_counts()
    proof = tg.prove(tpk, SquareChain(), TRng(b"gm17 sp"))
    plain = tec.plain_counts()
    assert plain[("madd_accumulate", tcfg.g1.name)] == 3       # a, c, h
    assert plain[("madd_accumulate", tcfg.g2.name)] == 1       # b
    assert tec.launch_counts() == {}
    ref = rg.prove(rpk, SquareChain(), RRng(b"gm17 sp"))
    assert TS.gm17_proof_to_bytes(proof) == RS.gm17_proof_to_bytes(ref)
    x = tcfg.Fr.from_int(pow(3, 1 << 40, tcfg.Fr.MODULUS))
    assert tg.verify(tvk, [x], proof)
    assert not tg.verify(tvk, [x + tcfg.Fr.from_int(1)], proof)


@pytest.mark.parametrize("what", ["proof", "vk", "pk"])
def test_gm17_layouts_match_reference(what):
    """The port writes pcd_tpu's bytes for a GM17 proof and vk, and for a
    pk the layout the pcd_tpu writers give; each parses back to the same
    bytes."""
    cfg = TM.toy_mnt4()
    rcfg, tcfg, rg, tg, rpk, rvk, tpk, tvk = _pair("toy_mnt4", SquareChain(),
                                                   b"gm17 ser")
    if what == "proof":
        obj = tg.prove(tpk, SquareChain(), TRng(b"gm17 ser p"))
        want = RS.gm17_proof_to_bytes(rg.prove(rpk, SquareChain(),
                                               RRng(b"gm17 ser p")))
        to, frm = TS.gm17_proof_to_bytes, TS.gm17_proof_from_bytes
    elif what == "vk":
        obj, want = tvk, RS.gm17_vk_to_bytes(rvk)
        to, frm = TS.gm17_vk_to_bytes, TS.gm17_vk_from_bytes
    else:
        obj, want = tpk, _ref_gm17_pk_bytes(rpk)
        to, frm = TS.gm17_pk_to_bytes, TS.gm17_pk_from_bytes
    got = to(obj)
    assert got == want
    assert to(frm(cfg, got)) == got


@pytest.mark.parametrize("drop", GM17.STREAMED)
def test_missing_stream_msm_raises(drop, streamed, monkeypatch):
    tcfg = TM.toy_mnt4()
    tg = GM17(tcfg, device="cpu")
    tpk, _ = tg.circuit_specific_setup(SquareChain(), TRng(b"gm17 drop"))
    if drop == "h_query":
        monkeypatch.setattr(GM17, "_stream_launch_h",
                            lambda self, pk, futs, h: None)
    else:
        launch = GM17._stream_launch

        def dropping(self, *args):
            futs = launch(self, *args)
            del futs[drop]
            return futs

        monkeypatch.setattr(GM17, "_stream_launch", dropping)
    with pytest.raises(RuntimeError, match=drop):
        tg.prove(tpk, SquareChain(), TRng(b"gm17 drop p"))


@pytest.mark.parametrize("cfg_name,stream", [("toy_mnt4", False),
                                             ("toy_mnt6", True)])
def test_device_quotient_matches_reference(cfg_name, stream, monkeypatch):
    """The device quotient tier on the CPU: pcd_tpu's host-tier proof
    bytes, its h-query MSM reading h as a device tensor when streamed;
    K6 three times, K5 once per level of the three transforms, and no
    launch."""
    monkeypatch.setattr(msm_dispatch, "QUOTIENT", "device")
    if stream:
        monkeypatch.setattr(GM17, "STREAM_MIN", 0)
        monkeypatch.setattr(msm_dispatch, "WINDOW_BITS", 8)
        monkeypatch.setattr(msm_dispatch, "LANES", 2048)
    rcfg, tcfg, rg, tg, rpk, _, tpk, tvk = _pair(cfg_name, SquareChain(),
                                                 b"gm17 quotient")
    tec.reset_launch_counts()
    proof = tg.prove(tpk, SquareChain(), TRng(b"gm17 qp"))
    plain = tec.plain_counts()
    ref = rg.prove(rpk, SquareChain(), RRng(b"gm17 qp"))
    assert TS.gm17_proof_to_bytes(proof) == RS.gm17_proof_to_bytes(ref)
    x = tcfg.Fr.from_int(pow(3, 1 << 40, tcfg.Fr.MODULUS))
    assert tg.verify(tvk, [x], proof)
    Fr = tcfg.Fr.NAME
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx

    npass = len(fft_ctx(tcfg.Fr, tpk.domain_size, "cpu").passes)
    assert plain[("spmv_rows", Fr)] == 3
    assert plain[("ntt_pass", Fr)] == 3 * npass
    assert plain.get(("madd_accumulate", tcfg.g1.name), 0) == (3 if stream
                                                               else 0)
    assert tec.launch_counts() == {}


@pytest.mark.parametrize("tier", ["host", "device"])
def test_replayed_unsatisfied_witness_raises(tier, monkeypatch):
    """A replayed witness that fails a constraint raises SNARKError on
    either quotient tier (the even SAP rows' check)."""
    from pcd_tpu_torch.snark.api import SNARKError

    monkeypatch.setattr(msm_dispatch, "QUOTIENT", tier)
    tcfg = TM.toy_mnt4()
    p = tcfg.Fr.MODULUS
    tg = GM17(tcfg, device="cpu")
    tpk, tvk = tg.circuit_specific_setup(ReplayChain(p), TRng(b"gm17 r"))
    proof = tg.prove(tpk, ReplayChain(p), TRng(b"gm17 r1"))
    proof = tg.prove(tpk, ReplayChain(p), TRng(b"gm17 r2"))
    assert tpk._plan.replay_count == 1
    assert tg.verify(tvk, [tcfg.Fr.from_int(ReplayChain(p).x)], proof)
    with pytest.raises(SNARKError, match="replayed witness"):
        tg.prove(tpk, ReplayChain(p, x=5), TRng(b"gm17 r3"))
