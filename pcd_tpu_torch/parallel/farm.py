"""PCD DAG-node proof farm (SURVEY.md §2c: independent DAG-node proofs are
embarrassingly parallel — prove() shares only the proving key — and are
farmed across workers/hosts; BASELINE.json configs[4]).

A `ProofDag` holds nodes (msg, local witness, predecessor ids); `DagFarm`
proves them in topological waves.  Within a wave, nodes are independent and
can be proved concurrently:

  - workers=1: inline (same process, device-accelerated).
  - workers>1: a spawn-based process pool; every worker rebuilds the
    (deterministic) proving key from the registered config factory + seed —
    the same replication strategy a multi-host deployment uses (each host
    holds a pk replica; only (msg, proof) pairs cross host boundaries,
    serialized via pcd_tpu.utils.serialize).

The port's copy of `pcd_tpu/parallel/farm.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DagNode:
    node_id: str
    msg: object
    witness: object
    priors: list = field(default_factory=list)  # predecessor node ids


class ProofDag:
    def __init__(self):
        self.nodes = {}
        self.order = []

    def add_node(self, node_id: str, msg, witness, priors=()):
        assert node_id not in self.nodes
        for p in priors:
            assert p in self.nodes, f"unknown predecessor {p}"
        self.nodes[node_id] = DagNode(node_id, msg, witness, list(priors))
        self.order.append(node_id)
        return node_id

    def waves(self):
        """Topological waves of node ids."""
        done = set()
        remaining = list(self.order)
        while remaining:
            wave = [nid for nid in remaining
                    if all(p in done for p in self.nodes[nid].priors)]
            assert wave, "cycle in proof DAG"
            yield wave
            done.update(wave)
            remaining = [nid for nid in remaining if nid not in wave]


# -- worker-side state (spawned processes) ----------------------------------
_worker_state = {}


def _worker_init(config_name: str, seed: bytes, predicate_builder):
    import pcd_tpu_torch.configs as configs
    from pcd_tpu_torch.utils.rng import ChaChaRng

    pcd = getattr(configs, config_name)()
    pred = predicate_builder(pcd.ic.main_field)
    rng = ChaChaRng(seed)
    pk, vk = pcd.circuit_specific_setup(pred, rng)
    _worker_state.update(pcd=pcd, pred=pred, pk=pk, vk=vk)


def _worker_prove(args):
    from pcd_tpu_torch.utils.rng import ChaChaRng
    from pcd_tpu_torch.utils.serialize import pcd_proof_from_bytes, \
        pcd_proof_to_bytes

    node_id, msg_int, wit_int, prior_msg_ints, prior_blobs, rng_seed = args
    st = _worker_state
    pcd, pred, pk = st["pcd"], st["pred"], st["pk"]
    F = pcd.ic.main_field
    msg = F.from_int(msg_int)
    wit = F.from_int(wit_int)
    priors = [F.from_int(v) for v in prior_msg_ints]
    proofs = [pcd_proof_from_bytes(pcd, b) for b in prior_blobs]
    proof = pcd.prove(pk, pred, msg, wit, priors, proofs,
                      ChaChaRng(rng_seed))
    return node_id, pcd_proof_to_bytes(pcd, proof)


class DagFarm:
    def __init__(self, pcd, predicate, pk, workers: int = 1,
                 config_name: str | None = None, seed: bytes = b"",
                 predicate_builder=None):
        self.pcd = pcd
        self.predicate = predicate
        self.pk = pk
        self.workers = workers
        self.config_name = config_name
        self.seed = seed
        self.predicate_builder = predicate_builder

    def run(self, dag: ProofDag, rng_seed: bytes = b"farm") -> dict:
        """Prove every node; returns {node_id: proof}."""
        from ..utils.rng import ChaChaRng

        proofs = {}
        if self.workers <= 1:
            for wave in dag.waves():
                for nid in wave:
                    node = dag.nodes[nid]
                    prior_msgs = [dag.nodes[p].msg for p in node.priors]
                    prior_proofs = [proofs[p] for p in node.priors]
                    proofs[nid] = self.pcd.prove(
                        self.pk, self.predicate, node.msg, node.witness,
                        prior_msgs, prior_proofs,
                        ChaChaRng(rng_seed + nid.encode()))
            return proofs

        from ..utils.serialize import pcd_proof_from_bytes

        assert self.config_name is not None and self.predicate_builder, \
            "multi-worker farm needs a config factory for pk replication"
        blobs = {}
        pool = self._new_pool()
        try:
            for wave in dag.waves():
                jobs = []
                for nid in wave:
                    node = dag.nodes[nid]
                    jobs.append((
                        nid, node.msg.n, node.witness.n,
                        [dag.nodes[p].msg.n for p in node.priors],
                        [blobs[p] for p in node.priors],
                        rng_seed + nid.encode()))
                pool = self._run_wave(pool, jobs, blobs)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        for nid, blob in blobs.items():
            proofs[nid] = pcd_proof_from_bytes(self.pcd, blob)
        return proofs

    # -- failure handling ------------------------------------------------
    MAX_ATTEMPTS = 2

    def _new_pool(self):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        ctx = mp.get_context("spawn")
        return ProcessPoolExecutor(
            max_workers=self.workers, mp_context=ctx,
            initializer=_worker_init,
            initargs=(self.config_name, self.seed, self.predicate_builder))

    def _run_wave(self, pool, jobs, blobs):
        """Prove one wave with per-node retry.  An ordinary per-node
        exception is retried once; a worker DEATH (BrokenProcessPool — the
        whole executor is poisoned) rebuilds the pool and resubmits every
        unfinished node of the wave, bounded by MAX_ATTEMPTS per node.
        Node proofs are deterministic given the per-node rng seed, so
        retries are safe.  Returns the (possibly replaced) pool."""
        import concurrent.futures as _cf

        attempts = {j[0]: 0 for j in jobs}
        pending = list(jobs)
        while pending:
            for j in pending:
                attempts[j[0]] += 1
            futures = {pool.submit(_worker_prove, j): j for j in pending}
            pending = []
            broken = False
            while futures and not broken:
                done, _ = _cf.wait(futures, return_when=_cf.FIRST_COMPLETED)
                for fut in done:
                    job = futures.pop(fut)
                    try:
                        nid, blob = fut.result()
                        blobs[nid] = blob
                    except _cf.process.BrokenProcessPool:
                        # executor poisoned: every in-flight node is lost
                        broken = True
                        pending.append(job)
                    except Exception:
                        if attempts[job[0]] >= self.MAX_ATTEMPTS:
                            raise
                        attempts[job[0]] += 1
                        futures[pool.submit(_worker_prove, job)] = job
            if broken:
                pending.extend(futures.values())
                over = [j[0] for j in pending
                        if attempts[j[0]] >= self.MAX_ATTEMPTS]
                if over:
                    raise RuntimeError(
                        f"farm nodes failed after {self.MAX_ATTEMPTS} "
                        f"attempts (worker death): {over}")
                pool.shutdown(wait=False, cancel_futures=True)
                pool = self._new_pool()
        return pool
