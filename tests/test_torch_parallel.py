"""The port's proof farm and pipelined chain prover
(pcd_tpu_torch/parallel/farm.py and pipeline.py, copies of pcd_tpu's)
against pcd_tpu's on the toy Groth16 cycle, on the CPU:

  - a DAG of two leaves and a root under an arity-2 predicate
    (tests/test_dag_farm.py's SumPredicate), proved by `DagFarm` with one
    worker: every node's proof byte-equal to pcd_tpu's farm's for the
    same pk and seed, the root and a leaf verify, a wrong message is
    rejected, and `ProofDag.waves` orders a larger DAG as pcd_tpu's does;
  - a two-step chain proved by `PipelinedChainProver` (its help stage on
    a worker thread): both proofs byte-equal to pcd_tpu's, both verify,
    and the old message against the newest proof is rejected.

The port takes pcd_tpu's keys through convert.  Its provers run their
commitment MSMs and quotient on the C++ host tier here (STREAM_MIN above
every circuit, QUOTIENT "host"): the stream tier and the device quotient
have byte-equal proofs of their own in test_torch_pcd.py and
test_torch_groth16.py.  The multiprocess farm, whose workers rebuild the
pk on the card (the configs' default device), has its card-only cases
in test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu import configs as RC  # noqa: E402
from pcd_tpu.parallel.farm import DagFarm as RFarm  # noqa: E402
from pcd_tpu.parallel.farm import ProofDag as RDag  # noqa: E402
from pcd_tpu.parallel.pipeline import PipelinedChainProver as RPipe  # noqa
from pcd_tpu.pcd.api import FpPredicate as RPredicate  # noqa: E402
from pcd_tpu.utils import serialize as RS  # noqa: E402
from pcd_tpu.utils.rng import ChaChaRng as RRng  # noqa: E402
from pcd_tpu_torch import configs as TC  # noqa: E402
from pcd_tpu_torch import convert  # noqa: E402
from pcd_tpu_torch.parallel.farm import DagFarm, ProofDag  # noqa: E402
from pcd_tpu_torch.parallel.pipeline import PipelinedChainProver  # noqa
from pcd_tpu_torch.pcd.api import FpPredicate as TPredicate  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402
from pcd_tpu_torch.snark.groth16.native import Groth16  # noqa: E402
from pcd_tpu_torch.utils import serialize as TS  # noqa: E402

from _torch_support import predicate  # noqa: E402
from _torch_support import reference_native_loaded  # noqa: E402,F401
from _torch_support import two_torch_threads  # noqa: E402,F401

NODES = ("leaf0", "leaf1", "root")


def sum_predicate(base, F):
    class SumPredicate(base):
        """msg = prior0 + prior1 + witness (PRIOR_MSG_LEN = 2)."""

        PRIOR_MSG_LEN = 2

        def generate_constraints(self, cs, msg, wit, priors, base_case):
            (priors[0] + priors[1] + wit).enforce_equal(msg)

    return SumPredicate(F)


def _dag(cls, F):
    dag = cls()
    for i in range(2):
        dag.add_node(f"leaf{i}", F.from_int(i + 1), F.from_int(i + 1))
    dag.add_node("root", F.from_int(1 + 2 + 7), F.from_int(7),
                 priors=["leaf0", "leaf1"])
    return dag


def _port(rpcd, pk, vk):
    """The port's toy_groth16 on the CPU with pcd_tpu's keys."""
    tpcd = TC.toy_groth16(device="cpu")
    tpk = convert.pcd_pk_from_reference(tpcd, np.frombuffer(
        RS.pcd_pk_to_bytes(rpcd, pk), dtype=np.uint8))
    seed = vk.crh_pp.seed
    tvk = convert.pcd_vk_from_reference(tpcd, np.frombuffer(
        len(seed).to_bytes(4, "little") + seed
        + RS.snark_vk_to_bytes(rpcd.ic.help_snark, vk.help_vk),
        dtype=np.uint8))
    return tpcd, tpk, tvk


@pytest.fixture(scope="module")
def host_tiers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Groth16, "STREAM_MIN", 1 << 40)
        mp.setattr(msm_dispatch, "QUOTIENT", "host")
        yield


@pytest.fixture(scope="module")
def dag_run(host_tiers):
    rpcd = RC.toy_groth16()
    F = rpcd.ic.main_field
    rpred = sum_predicate(RPredicate, F)
    pk, vk = rpcd.circuit_specific_setup(rpred, RRng(b"torch dag"))
    ref = RFarm(rpcd, rpred, pk, workers=1).run(_dag(RDag, F), b"dag")
    tpcd, tpk, tvk = _port(rpcd, pk, vk)
    TF = tpcd.ic.main_field
    tpred = sum_predicate(TPredicate, TF)
    got = DagFarm(tpcd, tpred, tpk, workers=1).run(_dag(ProofDag, TF),
                                                   b"dag")
    return rpcd, ref, tpcd, tpred, tvk, got


@pytest.mark.pcd_toy
@pytest.mark.parametrize("node", NODES)
def test_dag_proof_matches_reference(dag_run, node):
    rpcd, ref, tpcd, _, _, got = dag_run
    assert sorted(got) == sorted(ref) == sorted(NODES)
    assert TS.pcd_proof_to_bytes(tpcd, got[node]) == RS.pcd_proof_to_bytes(
        rpcd, ref[node])


@pytest.mark.pcd_toy
def test_dag_verifies_and_rejects(dag_run):
    _, _, tpcd, tpred, tvk, got = dag_run
    F = tpcd.ic.main_field
    assert tpcd.verify(tvk, tpred, F.from_int(10), got["root"])
    assert tpcd.verify(tvk, tpred, F.from_int(2), got["leaf1"])
    assert not tpcd.verify(tvk, tpred, F.from_int(11), got["root"])
    assert not tpcd.verify(tvk, tpred, F.from_int(1), got["leaf1"])


def test_dag_waves_match_reference():
    """Topological waves of a two-level tree with a skip edge, and the
    refusals (a duplicate id, an unknown predecessor)."""
    edges = [("a", ()), ("b", ()), ("c", ("a",)), ("d", ("a", "b")),
             ("e", ("c", "d")), ("f", ("b",)), ("g", ("e", "a"))]
    waves = []
    for cls in (ProofDag, RDag):
        dag = cls()
        for nid, pri in edges:
            dag.add_node(nid, None, None, priors=pri)
        waves.append(list(dag.waves()))
        with pytest.raises(AssertionError):
            dag.add_node("a", None, None)
        with pytest.raises(AssertionError):
            dag.add_node("h", None, None, priors=["zz"])
    assert waves[0] == waves[1] == [["a", "b"], ["c", "d", "f"], ["e"],
                                    ["g"]]


@pytest.fixture(scope="module")
def pipe_run(host_tiers):
    rpcd = RC.toy_groth16()
    F = rpcd.ic.main_field
    rpred = predicate(RPredicate, F)
    pk, vk = rpcd.circuit_specific_setup(rpred, RRng(b"torch pipe"))
    one = F.from_int(1)
    ref = RPipe(rpcd, rpred, pk).prove_chain([one, F.from_int(2)],
                                             [one, one], b"pipe")
    tpcd, tpk, tvk = _port(rpcd, pk, vk)
    TF = tpcd.ic.main_field
    tpred = predicate(TPredicate, TF)
    t1 = TF.from_int(1)
    got = PipelinedChainProver(tpcd, tpred, tpk).prove_chain(
        [t1, TF.from_int(2)], [t1, t1], b"pipe")
    return rpcd, ref, tpcd, tpred, tvk, got


@pytest.mark.pcd_toy
@pytest.mark.parametrize("step", [0, 1])
def test_pipeline_proof_matches_reference(pipe_run, step):
    rpcd, ref, tpcd, _, _, got = pipe_run
    assert len(got) == len(ref) == 2
    assert TS.pcd_proof_to_bytes(tpcd, got[step]) == RS.pcd_proof_to_bytes(
        rpcd, ref[step])


@pytest.mark.pcd_toy
def test_pipeline_verifies_and_rejects(pipe_run):
    _, _, tpcd, tpred, tvk, got = pipe_run
    F = tpcd.ic.main_field
    assert tpcd.verify(tvk, tpred, F.from_int(1), got[0])
    assert tpcd.verify(tvk, tpred, F.from_int(2), got[1])
    assert not tpcd.verify(tvk, tpred, F.from_int(1), got[1])
