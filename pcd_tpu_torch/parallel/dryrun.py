"""A quick proof that the sharded prover runs: the counterpart of
`dryrun_multichip` (`__graft_entry__.py:97-200`), toy shapes on every
rank of a mesh, each held to the port's own host oracles:

  - the sharded stream MSM (parallel/stream_dist.py) of 8 n toy MNT4 G1
    points against the host Pippenger (msm/host.py);
  - a batched FFT, one polynomial a rank, against the host domain;
  - the toy Groth16 prove of the reference's `_Circ` with `.dist` set
    (the sharded matvec and quotient; its MSMs, below Groth16.STREAM_MIN,
    on the host tier, each rank gathering h), which verifies and rejects
    a wrong input;
  - DistHPoly on MNT4-298's Fr at N = 64 against the host coset pipeline,
    when 64 splits for the mesh's size.

Usage: dryrun_multichip(n) runs n ranks as threads over gloo on the CPU
(parallel/mesh.thread_meshes); dryrun_multichip(n, device, mesh=mesh)
runs this process's rank of a mesh made elsewhere (make_mesh under
torchrun, n its size).  Every rank prints its lines and raises on a
mismatch.
"""

from __future__ import annotations

import contextlib

from .mesh import Mesh, run_ranks, shard_batch, thread_meshes


class _Circ:
    """x = a b (public x = 35), then a b^59 as one more witness: enough
    variables for the C++ tier's table encoding, and 64 R1CS rows, a
    domain that splits for 1, 2 and 4 ranks."""

    def generate_constraints(self, cs):
        from ..gadgets.fp import fpvar_class

        V = fpvar_class(cs)
        x = V.new_instance(35)
        a = V.new_witness(5)
        b = V.new_witness(7)
        (a * b).enforce_equal(x)
        acc = a
        for _ in range(59):
            acc = acc * b
        acc.enforce_equal(V.new_witness(acc.val))


@contextlib.contextmanager
def _toy_stream():
    """The stream tier at windows of 6 bits on 128 lanes, the fewest plain
    adds for toy MSMs, restored after."""
    from ..snark import msm_dispatch

    saved = msm_dispatch.WINDOW_BITS, msm_dispatch.LANES
    msm_dispatch.WINDOW_BITS, msm_dispatch.LANES = 6, 128
    try:
        yield
    finally:
        msm_dispatch.WINDOW_BITS, msm_dispatch.LANES = saved


def _rank(mesh: Mesh) -> list:
    import torch

    from ..curves import models as M
    from ..msm.host import msm as host_msm
    from ..ops.fft_tensor import fft_ctx
    from ..poly.domain import EvaluationDomain
    from ..snark.groth16.native import Groth16
    from ..utils.rng import ChaChaRng
    from .dist import DistContext, DistHPoly, _split
    from .stream_dist import ShardedStreamMSM

    n, r, dev = mesh.size, mesh.rank, mesh.device
    said = []

    def say(msg):
        said.append(f"dryrun_multichip({n}) rank {r}: {msg}")
        print(said[-1], flush=True)

    cfg = M.toy_mnt4()
    npts = 8 * n
    g = cfg.g1_gen
    pts = [g * (i + 1) for i in range(npts)]
    scalars = [(i * 7 + 3) % cfg.g1.order for i in range(npts)]
    smsm = ShardedStreamMSM(cfg.g1, cfg.Fr.BITS, mesh, c=6, lanes=128)
    if smsm.msm(pts, scalars) != host_msm(pts, scalars):
        raise AssertionError("sharded stream MSM mismatch in dryrun")
    # a batch of polynomials sharded over the ranks, one a rank
    dom = EvaluationDomain.new(cfg.Fr, 8)
    fctx = fft_ctx(cfg.Fr, dom.n, dev)
    coeffs = [[(b + 1) * (j + 1) for j in range(dom.n)] for b in range(n)]
    polys = torch.stack([fctx.encode(c) for c in coeffs])
    got = fctx.decode(fctx.fft(shard_batch(polys, mesh)))
    if got != dom.fft(coeffs[r]):
        raise AssertionError("batched FFT mismatch in dryrun")
    say("sharded STREAM MSM + batched FFT OK")

    snark = Groth16(cfg, device=dev)
    snark.dist = DistContext(mesh)
    rng = ChaChaRng(b"dryrun dist prove")
    pk, vk = snark.circuit_specific_setup(_Circ(), rng)
    proof = snark.prove(pk, _Circ(), rng)
    if not snark.verify(vk, [cfg.Fr.from_int(35)], proof) \
            or snark.verify(vk, [cfg.Fr.from_int(36)], proof):
        raise AssertionError("distributed prove failed verification")
    how = ("unsharded quotient" if snark.dist.unsharded
           else "sharded quotient")
    say(f"Groth16 prove with .dist OK ({how}; the MSMs on the host below "
        f"STREAM_MIN)")

    Fq = M.mnt4_298().Fr
    dom64 = EvaluationDomain.new(Fq, 64)
    try:
        _split(dom64.n, n)
    except ValueError:
        return said
    p = Fq.MODULUS
    a_ev = [(i * 3 + 1) % p for i in range(dom64.n)]
    b_ev = [(i * 5 + 2) % p for i in range(dom64.n)]
    c_ev = [a * b % p for a, b in zip(a_ev, b_ev)]
    got_h = DistHPoly(Fq, dom64.n, mesh).h_poly(a_ev, b_ev, c_ev)
    cos = [dom64.coset_fft(dom64.ifft(v)) for v in (a_ev, b_ev, c_ev)]
    zi = pow(dom64.vanishing_poly_at(dom64.coset_shift), -1, p)
    h_cos = [(cos[0][i] * cos[1][i] - cos[2][i]) % p * zi % p
             for i in range(dom64.n)]
    if got_h != dom64.coset_ifft(h_cos):
        raise AssertionError("dist h-poly mismatch")
    say("all_to_all h-poly pipeline OK (MNT4-298 Fr)")
    return said


def dryrun_multichip(n_devices: int, device="cpu", mesh: Mesh = None) -> list:
    """The dryrun on n_devices ranks; returns each rank's lines."""
    with _toy_stream():
        if mesh is not None:
            if mesh.size != n_devices:
                raise ValueError(f"dryrun_multichip({n_devices}) on a mesh "
                                 f"of {mesh.size}")
            return [_rank(mesh)]
        return run_ranks(thread_meshes(n_devices, device), _rank)
