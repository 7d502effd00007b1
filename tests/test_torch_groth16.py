"""The port's Groth16 prover on its stream tier (pcd_tpu_torch/snark), on
the CPU with the plain versions: a streamed prove sends all five
commitment MSMs through K1 and verifies, and nothing reaches the host
MSM quietly: a missing future or a table the stream tier cannot take
raises.  The port alone; no JAX.
"""

import pytest

torch = pytest.importorskip("torch")

from pcd_tpu_torch.curves import models as M  # noqa: E402
from pcd_tpu_torch.ops import ec  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402
from pcd_tpu_torch.snark.groth16.native import Groth16  # noqa: E402
from pcd_tpu_torch.utils.rng import ChaChaRng  # noqa: E402

from _torch_support import SquareChain  # noqa: E402


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
