"""The port's sharded Groth16 prover (pcd_tpu_torch/parallel/{dist,fft,
mesh,dryrun}.py) on the CPU, against the host oracles of
tests/test_dist.py and pcd_tpu's unsharded prove: ranks are threads over
gloo in one process (thread_meshes), the kernels' plain versions run on
each rank's blocks.  The reference's own sharded programs are not called
(their JAX compiles alone take minutes).

- `_split` equals pcd_tpu's on real and toy sizes;
- DistributedFFT at 1, 2 and 4 ranks equals the host domain's fft;
- DistHPoly at 1, 2 and 4 ranks equals the host coset pipeline and the
  port's unsharded `hpoly`, on the toy Fr and MNT4-298's Fr at N = 64;
- DistMatVec at 2 and 3 ranks, 101 rows, equals the host row
  evaluation;
- where N has no split for the size (64 at 3 ranks) DistContext.h_poly is
  None, the prove runs the unsharded quotient and still gives pcd_tpu's
  bytes;
- a toy Groth16 prove with `.dist` at 2 ranks (synthesis, then a replay)
  gives both ranks pcd_tpu's proof bytes, with K1 and K4 once a rank an
  MSM, K6 once a rank a matrix, K5 and K7 as the sharded quotient runs
  them; an unsatisfied replayed witness makes
  both ranks raise SNARKError within 30 s; below STREAM_MIN the MSMs
  stay on the host and each rank gathers the sharded h for them;
- make_mesh at world size 1 on the CPU; the dryrun at 2 ranks;
- PipelinedChainProver raises a help prove's error (the module it copies
  waits for ever there).
"""

import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.poly.domain import EvaluationDomain as RDomain  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops import ec  # noqa: E402
from pcd_tpu_torch.parallel.mesh import run_ranks, thread_meshes  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch  # noqa: E402

from _torch_support import ReplayChain  # noqa: E402
from _torch_support import reference_native_loaded  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the plain versions: the ranks are threads
    of their own, and their small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

MODELS = {"toy": "toy_mnt4", "mnt4": "mnt4_298"}


def _fields(which):
    return getattr(RM, MODELS[which])().Fr, getattr(TM, MODELS[which])().Fr


def _host_h(dom, a_ev, b_ev, c_ev):
    """The host coset pipeline (tests/test_dist.py's oracle)."""
    p = dom.F.MODULUS
    cos = [dom.coset_fft(dom.ifft(v)) for v in (a_ev, b_ev, c_ev)]
    zh_inv = pow(dom.vanishing_poly_at(dom.coset_shift), -1, p)
    return dom.coset_ifft([(cos[0][i] * cos[1][i] - cos[2][i]) % p * zh_inv
                           % p for i in range(dom.n)])


@pytest.fixture
def card_operands(monkeypatch):
    """The card's wrappers of K5 and K7 refuse operands that are not
    contiguous; their plain versions take any.  Hold the plain calls to
    the card's rule."""
    from pcd_tpu_torch.ops.fft_tensor import FFTTensorCtx
    from pcd_tpu_torch.ops.field import FieldCtx

    def held(fn, n):
        def call(self, *args, **kw):
            for t in args[:n]:
                assert t.is_contiguous(), f"{fn.__name__}: a strided operand"
            return fn(self, *args, **kw)
        return call

    monkeypatch.setattr(FFTTensorCtx, "ntt_pass",
                        held(FFTTensorCtx.ntt_pass, 2))
    monkeypatch.setattr(FieldCtx, "vmul", held(FieldCtx.vmul, 2))
    monkeypatch.setattr(FieldCtx, "abc", held(FieldCtx.abc, 4))


@pytest.mark.parametrize("N,size", [(64, 1), (64, 2), (64, 3), (64, 4),
                                    (48, 4), (12288, 2), (31360, 3),
                                    (225792, 4)])
def test_split_matches_reference(N, size):
    from pcd_tpu.parallel.dist import _split as ref_split
    from pcd_tpu_torch.parallel.dist import _split

    try:
        want = ref_split(N, size)
    except ValueError:
        with pytest.raises(ValueError, match="no \\(n1, n2\\) split"):
            _split(N, size)
        return
    assert _split(N, size) == want


@pytest.mark.parametrize("size,n1,n2", [(1, 8, 8), (2, 4, 16), (4, 8, 8)])
def test_distributed_fft_matches_domain(size, n1, n2, card_operands):
    from pcd_tpu_torch.parallel.fft import DistributedFFT

    rF, tF = _fields("toy")
    rng = np.random.default_rng(9)
    coeffs = [int(x) for x in rng.integers(0, rF.MODULUS, n1 * n2 - 3)]
    want = RDomain(rF, n1 * n2).fft(coeffs + [0, 0, 0])
    got = run_ranks(thread_meshes(size), lambda mesh: DistributedFFT(
        tF, n1, n2, mesh).fft(coeffs), timeout_s=120)
    assert got == [want] * size


@pytest.mark.parametrize("which", ["toy", "mnt4"])
@pytest.mark.parametrize("size", [1, 2, 4])
def test_dist_h_poly_matches_host(which, size, card_operands):
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx, hpoly
    from pcd_tpu_torch.ops.field import limbs_to_ints
    from pcd_tpu_torch.parallel.dist import DistHPoly

    rF, tF = _fields(which)
    p = rF.MODULUS
    dom = RDomain.new(rF, 64)
    N = dom.n
    rng = np.random.default_rng(5)
    a_ev = [int(rng.integers(1, min(p, 1 << 62))) for _ in range(N)]
    b_ev = [int(rng.integers(1, min(p, 1 << 62))) for _ in range(N)]
    c_ev = [a * b % p for a, b in zip(a_ev, b_ev)]
    want = _host_h(dom, a_ev, b_ev, c_ev)
    got = run_ranks(thread_meshes(size), lambda mesh: DistHPoly(
        tF, N, mesh).h_poly(a_ev, b_ev, c_ev), timeout_s=120)
    assert got == [want] * size
    # the port's unsharded device quotient on the same evaluations
    fctx = fft_ctx(tF, N, "cpu")
    evs = [fctx.encode(v) for v in (a_ev, b_ev, c_ev)]
    zh = pow(dom.vanishing_poly_at(dom.coset_shift), -1, p)
    assert limbs_to_ints(hpoly(fctx, *evs, zh).numpy()) == want


@pytest.mark.parametrize("size", [2, 3])
def test_dist_matvec_matches_host(size):
    from pcd_tpu_torch.parallel.dist import DistContext

    rF, tF = _fields("toy")
    p = rF.MODULUS
    rng = np.random.default_rng(7)
    n_rows, n_cols = 101, 37  # deliberately not multiples of the size
    rows = []
    for _ in range(n_rows):
        def lc():
            return {int(c): int(rng.integers(1, p))
                    for c in rng.choice(n_cols, rng.integers(0, 6),
                                        replace=False)}
        rows.append((lc(), lc(), lc()))
    z = [int(rng.integers(0, p)) for _ in range(n_cols)]

    def rank(mesh):
        dmv = DistContext(mesh).matvec(tF, rows, n_rows, n_cols)
        f = dmv.f
        zm = torch.from_numpy(np.stack([np.frombuffer(
            (v * f.r % p).to_bytes(40, "little"), "<i4") for v in z]))
        outs = dmv.apply_all(zm)
        return list(dmv.local), [f.decode_ints(outs[k].numpy())
                                 for k in range(3)]

    got = run_ranks(thread_meshes(size), rank, timeout_s=120)
    assert sum((loc for loc, _ in got), []) == list(range(n_rows))
    for loc, outs in got:
        for k in range(3):
            want = [sum(co * z[c] for c, co in rows[r][k].items()) % p
                    for r in loc]
            assert outs[k] == want, f"matrix {k} mismatch"


@pytest.fixture(scope="module")
def ref_g16():
    """pcd_tpu's toy MNT4 Groth16 keys for ReplayChain(k=61): 62
    constraints and two instance rows, a domain of 64 points."""
    from pcd_tpu.snark.groth16.native import Groth16 as RG16
    from pcd_tpu.utils import serialize as RS
    from pcd_tpu.utils.rng import ChaChaRng as RRng

    rcfg = RM.toy_mnt4()
    p = rcfg.Fr.MODULUS
    rg = RG16(rcfg)
    rpk, rvk = rg.circuit_specific_setup(ReplayChain(p, k=61),
                                         RRng(b"dist g16 setup"))
    assert rpk.domain_size == 64
    return (rg, rpk, RS.groth16_pk_to_bytes(rpk),
            RS.groth16_vk_to_bytes(rvk), p)


def _toy_stream(mp):
    """Every commitment MSM of the port's prover on the stream tier at
    c = 6, L = 128, and the device quotient."""
    from pcd_tpu_torch.snark.groth16.native import Groth16

    mp.setattr(Groth16, "STREAM_MIN", 0)
    mp.setattr(msm_dispatch, "WINDOW_BITS", 6)
    mp.setattr(msm_dispatch, "LANES", 128)
    mp.setattr(msm_dispatch, "QUOTIENT", "device")


@pytest.fixture
def toy_g16(ref_g16, monkeypatch):
    _toy_stream(monkeypatch)
    return ref_g16


def _port_prover(blob, mesh):
    """Each rank's own pk (parsed from pcd_tpu's bytes) and prover."""
    from pcd_tpu_torch.parallel.dist import DistContext
    from pcd_tpu_torch.snark.groth16.native import Groth16
    from pcd_tpu_torch.utils import serialize as TS

    cfg = TM.toy_mnt4()
    g16 = Groth16(cfg, device="cpu")
    g16.dist = DistContext(mesh)
    return cfg, g16, TS.groth16_pk_from_bytes(cfg, blob)


@pytest.fixture(scope="module")
def two_ranks(ref_g16):
    """Two ranks, each with its own pk and prover, after the synthesis
    prove (the pk's witness plan):
    (meshes, [(cfg, g16, pk)] by rank, each rank's proof bytes)."""
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx
    from pcd_tpu_torch.utils import serialize as TS
    from pcd_tpu_torch.utils.rng import ChaChaRng

    _, _, blob, _, p = ref_g16
    fft_ctx(TM.toy_mnt4().Fr, 8, "cpu")    # its root tables (K7) built once
    meshes = thread_meshes(2)

    def rank(mesh):
        cfg, g16, pk = _port_prover(blob, mesh)
        pr = g16.prove(pk, ReplayChain(p, k=61), ChaChaRng(b"dist g16 p1"))
        return (cfg, g16, pk), TS.groth16_proof_to_bytes(pr)

    with pytest.MonkeyPatch.context() as mp:
        _toy_stream(mp)
        out = run_ranks(meshes, rank, timeout_s=120)
    return meshes, [o[0] for o in out], [o[1] for o in out]


def test_groth16_dist_prove_matches_reference(toy_g16, two_ranks,
                                              card_operands):
    """2 ranks: the synthesis prove and a replayed one (its check on each
    rank's rows) give both ranks pcd_tpu's unsharded proof bytes; the
    proofs verify."""
    from pcd_tpu.utils import serialize as RS
    from pcd_tpu.utils.rng import ChaChaRng as RRng
    from pcd_tpu_torch.utils import serialize as TS
    from pcd_tpu_torch.utils.rng import ChaChaRng

    rg, rpk, _, vk_blob, p = toy_g16
    meshes, provers, first = two_ranks
    want = [RS.groth16_proof_to_bytes(rg.prove(rpk, ReplayChain(p, k=61),
                                               RRng(t)))
            for t in (b"dist g16 p1", b"dist g16 p2")]
    assert first == [want[0]] * 2

    def rank(mesh):
        cfg, g16, pk = provers[mesh.rank]
        pr = g16.prove(pk, ReplayChain(p, k=61), ChaChaRng(b"dist g16 p2"))
        vk = TS.groth16_vk_from_bytes(cfg, vk_blob)
        assert g16.verify(vk, [cfg.Fr.from_int(ReplayChain(p, k=61).x)], pr)
        assert pk._plan.replay_count >= 1
        assert g16.dist.unsharded == []
        return TS.groth16_proof_to_bytes(pr)

    ec.reset_launch_counts()
    assert run_ranks(meshes, rank, timeout_s=120) == [want[1]] * 2
    cfg = TM.toy_mnt4()
    plain = ec.plain_counts()
    # the replayed prove on two ranks: K1 and K4 once a rank an MSM, K6
    # once a rank a matrix, K5 once a pass of the n1 and n2 (8-point)
    # transforms of three 4-step transforms, K7 eight times a rank (z to
    # Montgomery, the check, three twiddle products, the coset scale,
    # (a b - c) Z_H^-1 and the unscale)
    assert plain[("madd_accumulate", cfg.g1.name)] == 2 * 4
    assert plain[("madd_accumulate", cfg.g2.name)] == 2 * 1
    assert plain[("bucket_finish", cfg.g1.name)] == 2 * 4
    assert plain[("spmv_rows", cfg.Fr.NAME)] == 2 * 3
    assert plain[("ntt_pass", cfg.Fr.NAME)] == 2 * 3 * 2
    assert plain[("fp_vec", cfg.Fr.NAME)] == 2 * 8


def test_dist_prove_host_msms(ref_g16, two_ranks, monkeypatch):
    """Below Groth16.STREAM_MIN the commitment MSMs stay on the host tier;
    the quotient is still sharded, and each rank gathers h for the h-query
    MSM: both ranks give pcd_tpu's proof bytes, and K1 never runs."""
    from pcd_tpu.utils import serialize as RS
    from pcd_tpu.utils.rng import ChaChaRng as RRng
    from pcd_tpu_torch.utils import serialize as TS
    from pcd_tpu_torch.utils.rng import ChaChaRng

    monkeypatch.setattr(msm_dispatch, "QUOTIENT", "device")
    rg, rpk, _, _, p = ref_g16
    meshes, provers, _ = two_ranks
    want = RS.groth16_proof_to_bytes(rg.prove(rpk, ReplayChain(p, k=61),
                                              RRng(b"dist g16 host")))

    def rank(mesh):
        _, g16, pk = provers[mesh.rank]
        pr = g16.prove(pk, ReplayChain(p, k=61), ChaChaRng(b"dist g16 host"))
        return TS.groth16_proof_to_bytes(pr)

    ec.reset_launch_counts()
    assert run_ranks(meshes, rank, timeout_s=120) == [want] * 2
    plain = ec.plain_counts()
    assert plain[("spmv_rows", TM.toy_mnt4().Fr.NAME)] == 2 * 3
    assert not any(k == "madd_accumulate" for k, _ in plain)


def test_unsplittable_domain_runs_unsharded(toy_g16):
    """N = 64 has no split for 3 ranks: pcd_tpu's _split raises (its
    DistHPoly raises and its h_poly caches None); the port's
    DistContext.h_poly is None, cached, and the prove runs the unsharded
    quotient on every rank with sharded MSMs, still pcd_tpu's bytes."""
    from pcd_tpu.parallel.dist import _split as ref_split
    from pcd_tpu.utils import serialize as RS
    from pcd_tpu.utils.rng import ChaChaRng as RRng
    from pcd_tpu_torch.utils import serialize as TS
    from pcd_tpu_torch.utils.rng import ChaChaRng

    rg, rpk, blob, _, p = toy_g16
    with pytest.raises(ValueError):
        ref_split(64, 3)
    want = RS.groth16_proof_to_bytes(rg.prove(rpk, ReplayChain(p, k=61),
                                              RRng(b"dist g16 u")))

    def rank(mesh):
        cfg, g16, pk = _port_prover(blob, mesh)
        assert g16.dist.h_poly(cfg.Fr, 64) is None
        assert g16.dist._h_cache == {(cfg.Fr.MODULUS, 64, 3): None}
        pr = g16.prove(pk, ReplayChain(p, k=61), ChaChaRng(b"dist g16 u"))
        assert g16.dist.unsharded == [(cfg.Fr.NAME, 64)]
        return TS.groth16_proof_to_bytes(pr)

    assert run_ranks(thread_meshes(3), rank, timeout_s=120) == [want] * 3


def test_failing_rank_raises_on_every_rank(ref_g16, two_ranks,
                                           monkeypatch):
    """An unsatisfied replayed witness (x = 5: the last constraint, a row
    of rank 1's block only) makes both ranks raise SNARKError, within
    30 s, and neither waits in a collective.  (Below STREAM_MIN: the check
    runs before any MSM, on either tier.)"""
    from pcd_tpu_torch.snark.api import SNARKError
    from pcd_tpu_torch.utils.rng import ChaChaRng

    monkeypatch.setattr(msm_dispatch, "QUOTIENT", "device")
    p = ref_g16[4]
    meshes, provers, _ = two_ranks

    def rank(mesh):
        _, g16, pk = provers[mesh.rank]
        t0 = time.monotonic()
        try:
            g16.prove(pk, ReplayChain(p, k=61, x=5),
                      ChaChaRng(b"dist g16 f2"))
        except SNARKError as e:
            return "replayed witness" in str(e), time.monotonic() - t0
        return False, time.monotonic() - t0

    out = run_ranks(meshes, rank, timeout_s=60)
    assert [ok for ok, _ in out] == [True, True]
    assert all(dt < 30 for _, dt in out)


def test_make_mesh_world_one():
    """make_mesh("cpu") without a group: gloo at world size 1; without a
    card, the default device (the card) raises before any group."""
    import torch.distributed as dist

    from pcd_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_mesh()
    assert not dist.is_initialized()
    try:
        mesh = make_mesh("cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
        assert torch.equal(mesh.all_gather(x), x[None])
        assert torch.equal(mesh.all_to_all(x, 0, 1), x)
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_two_ranks():
    from pcd_tpu_torch.parallel.dryrun import dryrun_multichip

    said = dryrun_multichip(2, "cpu")
    assert len(said) == 2
    for r, lines in enumerate(said):
        assert len(lines) == 3 and all(f"rank {r}:" in ln for ln in lines)
        assert "(sharded quotient;" in lines[1]


def test_pipeline_help_failure_raises():
    """A help prove that raises makes prove_chain raise it instead of
    waiting for ever (thread join with a timeout: no hang)."""
    from pcd_tpu_torch.parallel.pipeline import PipelinedChainProver

    class Help:
        def prove(self, *args):
            raise RuntimeError("help prove failed")

    class Main:
        def prove(self, *args):
            return "main proof"

    pcd = types.SimpleNamespace(
        ic=types.SimpleNamespace(help_snark=Help(), main_snark=Main()),
        _input_hash=lambda *args: b"hash")
    pk = types.SimpleNamespace(main_pvk=None, help_pk=None, main_pk=None,
                               crh_pp=None, help_vk=None)
    out = []

    def run():
        try:
            PipelinedChainProver(pcd, None, pk).prove_chain([1, 2], [0, 0])
        except RuntimeError as e:
            out.append(str(e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(30)
    assert not t.is_alive(), "prove_chain hung on a failed help prove"
    assert out == ["help prove failed"]
