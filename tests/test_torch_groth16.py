"""The port's Groth16 prover on its stream tier (pcd_tpu_torch/snark), on
the CPU with the plain versions: a streamed prove sends all five
commitment MSMs through K1 and verifies, and nothing reaches the host
MSM quietly: a missing future or a table the stream tier cannot take
raises.  Under the device quotient tier (msm_dispatch.QUOTIENT =
"device": K6, then hpoly on K5 and K7) a prove gives pcd_tpu's host-tier
proof bytes (pcd_tpu imported inside that test only), a replayed
unsatisfied witness raises SNARKError, and an unknown tier raises.
"""

import pytest

torch = pytest.importorskip("torch")

from pcd_tpu_torch.curves import models as M  # noqa: E402
from pcd_tpu_torch.ops import ec  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402
from pcd_tpu_torch.snark.groth16.native import Groth16  # noqa: E402
from pcd_tpu_torch.utils.rng import ChaChaRng  # noqa: E402

from _torch_support import ReplayChain, SquareChain  # noqa: E402


@pytest.fixture
def streamed(monkeypatch):
    monkeypatch.setattr(Groth16, "STREAM_MIN", 0)
    monkeypatch.setattr(msm_dispatch, "WINDOW_BITS", 6)
    monkeypatch.setattr(msm_dispatch, "LANES", 128)
    cfg = M.toy_mnt4()
    g16 = Groth16(cfg, device="cpu")
    pk, vk = g16.circuit_specific_setup(SquareChain(), ChaChaRng(b"g16 s"))
    return cfg, g16, pk, vk


def test_streamed_prove_runs_every_msm_on_k1(streamed):
    cfg, g16, pk, vk = streamed
    ec.reset_launch_counts()
    proof = g16.prove(pk, SquareChain(), ChaChaRng(b"g16 p"))
    x = cfg.Fr.from_int(pow(3, 1 << 40, cfg.Fr.MODULUS))
    assert g16.verify(vk, [x], proof)
    assert not g16.verify(vk, [x + cfg.Fr.from_int(1)], proof)
    plain = ec.plain_counts()
    assert plain[("madd_accumulate", cfg.g1.name)] == 4     # a, b1, l, h
    assert plain[("madd_accumulate", cfg.g2.name)] == 1     # b2
    assert ec.launch_counts() == {}


def test_missing_stream_msm_raises(streamed, monkeypatch):
    _, g16, pk, _ = streamed
    launch = Groth16._stream_launch

    def drop_b1(self, *args):
        futs = launch(self, *args)
        del futs["b_g1_query"]
        return futs

    monkeypatch.setattr(Groth16, "_stream_launch", drop_b1)
    with pytest.raises(RuntimeError, match="b_g1_query"):
        g16.prove(pk, SquareChain(), ChaChaRng(b"g16 p"))


def test_unstreamable_table_raises(streamed):
    """Below the C++ tier's encoding threshold a query table stays a host
    point list, which the stream tier refuses instead of handing the MSM
    to the host."""
    cfg, g16, _, _ = streamed
    pk, _ = g16.circuit_specific_setup(SquareChain(k=3), ChaChaRng(b"g16 t"))
    with pytest.raises(RuntimeError, match="native encoding"):
        g16.prove(pk, SquareChain(k=3), ChaChaRng(b"g16 p"))


@pytest.mark.parametrize("stream", [False, True])
def test_device_quotient_matches_reference(stream, monkeypatch):
    """pcd_tpu's host-tier proof bytes from the same ChaCha seeds; when
    streamed, the h-query MSM reads h as a tensor (K1 four times in G1);
    K6 three times, K5 once per level of the three transforms."""
    from pcd_tpu.curves import models as RM
    from pcd_tpu.snark.groth16.native import Groth16 as RG16
    from pcd_tpu.utils import serialize as RS
    from pcd_tpu.utils.rng import ChaChaRng as RRng
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx
    from pcd_tpu_torch.utils import serialize as TS

    monkeypatch.setattr(msm_dispatch, "QUOTIENT", "device")
    if stream:
        monkeypatch.setattr(Groth16, "STREAM_MIN", 0)
        monkeypatch.setattr(msm_dispatch, "WINDOW_BITS", 6)
        monkeypatch.setattr(msm_dispatch, "LANES", 128)
    rcfg, cfg = RM.toy_mnt4(), M.toy_mnt4()
    rg, g16 = RG16(rcfg), Groth16(cfg, device="cpu")
    rpk, _ = rg.circuit_specific_setup(SquareChain(), RRng(b"g16 q s"))
    pk, vk = g16.circuit_specific_setup(SquareChain(), ChaChaRng(b"g16 q s"))
    ec.reset_launch_counts()
    proof = g16.prove(pk, SquareChain(), ChaChaRng(b"g16 q p"))
    plain = ec.plain_counts()
    ref = rg.prove(rpk, SquareChain(), RRng(b"g16 q p"))
    assert TS.groth16_proof_to_bytes(proof) == RS.groth16_proof_to_bytes(ref)
    x = cfg.Fr.from_int(pow(3, 1 << 40, cfg.Fr.MODULUS))
    assert g16.verify(vk, [x], proof)
    npass = len(fft_ctx(cfg.Fr, pk.domain_size, "cpu").passes)
    assert plain[("spmv_rows", cfg.Fr.NAME)] == 3
    assert plain[("ntt_pass", cfg.Fr.NAME)] == 3 * npass
    assert plain.get(("madd_accumulate", cfg.g1.name), 0) == (4 if stream
                                                              else 0)
    assert ec.launch_counts() == {}


@pytest.mark.parametrize("tier", ["host", "device"])
def test_replayed_unsatisfied_witness_raises(tier, monkeypatch):
    """A replayed witness that fails a constraint raises SNARKError on
    either quotient tier (the check on rows [:n_cons])."""
    from pcd_tpu_torch.snark.api import SNARKError

    monkeypatch.setattr(msm_dispatch, "QUOTIENT", tier)
    cfg = M.toy_mnt4()
    p = cfg.Fr.MODULUS
    g16 = Groth16(cfg, device="cpu")
    pk, vk = g16.circuit_specific_setup(ReplayChain(p), ChaChaRng(b"g16 r"))
    g16.prove(pk, ReplayChain(p), ChaChaRng(b"g16 r1"))
    proof = g16.prove(pk, ReplayChain(p), ChaChaRng(b"g16 r2"))
    assert pk._plan.replay_count == 1
    assert g16.verify(vk, [cfg.Fr.from_int(ReplayChain(p).x)], proof)
    with pytest.raises(SNARKError, match="replayed witness"):
        g16.prove(pk, ReplayChain(p, x=5), ChaChaRng(b"g16 r3"))


def test_unknown_quotient_raises(monkeypatch):
    monkeypatch.setattr(msm_dispatch, "QUOTIENT", "gpu")
    g16 = Groth16(M.toy_mnt4(), device="cpu")
    pk, _ = g16.circuit_specific_setup(SquareChain(k=3), ChaChaRng(b"g16 u"))
    with pytest.raises(ValueError, match="QUOTIENT"):
        g16.prove(pk, SquareChain(k=3), ChaChaRng(b"g16 u p"))
