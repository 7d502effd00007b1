"""Two-stage IVC chain prover with help-stage offload (SURVEY.md §2c PP).

Dependency reality check: in a *linear* chain, step i+1's MainCircuit takes
step i's help proof as witness (reference data_structures.rs:189-212), so
the two SNARK proves of consecutive steps cannot fully overlap.  What CAN
overlap with the help prover of step i:

  - step i+1's input-hash computation (depends only on msg and vk);
  - (in a DAG) the entire proving of sibling nodes — that is the proof
    farm's job (pcd_tpu/parallel/farm.py), which is where the real
    multi-device win lives.

This module runs the help stage on a worker thread so the overlap that is
legal happens automatically, and provides the chain-driver API.

The port's copy of `pcd_tpu/parallel/pipeline.py`; the pcd_tpu paths
named here are the JAX package's modules.  One hunk differs: the help
worker marks its failing item done, so a help prove that raises makes
prove_chain raise where the module waits for ever.
"""

from __future__ import annotations

import threading
from queue import Queue

from ..pcd.ec_cycle import HelpCircuit, MainCircuit
from ..utils.rng import ChaChaRng


class PipelinedChainProver:
    """Proves a linear IVC chain msg_1 -> msg_2 -> ... with the main and
    help stages overlapped."""

    def __init__(self, pcd, predicate, pk):
        self.pcd = pcd
        self.predicate = predicate
        self.pk = pk

    def prove_chain(self, msgs, witnesses, rng_seed: bytes = b"pipeline"):
        """msgs[i] is the message after step i; witnesses[i] the local
        witness of step i.  Step 0 is the base case.  Returns the list of
        PCD proofs per step."""
        ic = self.pcd.ic
        pk = self.pcd_pk = self.pk
        pred = self.predicate
        n = len(msgs)
        assert len(witnesses) == n

        help_in: Queue = Queue(maxsize=1)
        proofs = [None] * n
        errors = []

        def help_worker():
            # every item taken is marked done, the failing one too, so the
            # main thread's join returns and raises the error
            while True:
                item = help_in.get()
                try:
                    if item is None:
                        return
                    i, input_hash, main_proof = item
                    help_circuit = HelpCircuit(
                        ic, pk.main_pvk, input_hash=input_hash,
                        main_proof=main_proof)
                    proofs[i] = ic.help_snark.prove(
                        pk.help_pk, help_circuit,
                        ChaChaRng(rng_seed + b"h%d" % i))
                except Exception as e:
                    errors.append(e)
                    return
                finally:
                    help_in.task_done()

        t = threading.Thread(target=help_worker, daemon=True)
        t.start()

        for i in range(n):
            msg = msgs[i]
            wit = witnesses[i]
            # the input hash depends only on (vk, msg): compute it while
            # the previous step's help prover may still be running
            input_hash = self.pcd._input_hash(pk.crh_pp, pk.help_vk, pred, msg)
            if i == 0:
                priors, prior_proofs, base = [], [], True
            else:
                # the prior help proof is a MainCircuit witness: must wait
                help_in.join()
                if errors:
                    raise errors[0]
                priors, prior_proofs, base = [msgs[i - 1]], [proofs[i - 1]], False
            main_circuit = MainCircuit(
                ic, pred, pk.crh_pp, input_hash=input_hash,
                help_vk=pk.help_vk, msg=msg, witness=wit,
                prior_msgs=priors, prior_proofs=prior_proofs,
                base_case_bit=base)
            main_proof = ic.main_snark.prove(
                pk.main_pk, main_circuit, ChaChaRng(rng_seed + b"m%d" % i))
            help_in.put((i, input_hash, main_proof))

        help_in.join()
        help_in.put(None)
        t.join(timeout=5)
        if errors:
            raise errors[0]
        return proofs
