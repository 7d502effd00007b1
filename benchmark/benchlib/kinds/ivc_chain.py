"""Traffic kind "ivc_chain": one incrementally verifiable chain, closed
loop.  Each request is one warm `ECCyclePCD.prove` step (a main prove and
a help prove) on the counter predicate, msg = prior msg + witness with one
prior, sent as soon as the step before it returns.

Set-up: the port's configuration on the card, its circuit-specific setup
from a ChaCha stream of the seed (the keys), the base case, and as many
warm steps as the mix's "warm_steps" (the device quotient's one-time
tables and every kernel the window launches).  The witnesses and the
provers' randomness are ChaCha streams of the seed too, so a seed gives
the same keys, messages and proofs.

Check: the reference (benchmark/reference/checks.py) draws the keys'
trapdoor again and judges the verifying keys by it, then verifies the
main proof and the PCD proof of "check_steps" window steps drawn from
the seed, and always of the last one, each against the message it
proved.  The main proof is the one the main SNARK's `prove` returned
inside the step, kept as it passes.
"""

from __future__ import annotations

import hashlib
import random
import time
import traceback

from reference import checks
from reference.rng import ChaChaRng


def seed_bytes(label: str, seed: int) -> bytes:
    return hashlib.sha256(f"{label}:{seed}".encode()).digest()


def plain(obj, names) -> dict:
    """A key's or proof's points, by name, as the reference's plain
    encodings (lists stay lists)."""
    out = {}
    for n in names:
        v = getattr(obj, n)
        out[n] = ([checks.encode(p) for p in v] if isinstance(v, list)
                  else checks.encode(v))
    return out


class Generator:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.steps = []           # (msg, proof, main proof) of the window
        self.main_proof = None    # the main SNARK's last proof
        self.failed = 0           # steps that raised (the chain stops)

    def setup(self):
        from pcd_tpu_torch import configs
        from pcd_tpu_torch.ops import kernels
        from pcd_tpu_torch.pcd.api import FpPredicate

        class Counter(FpPredicate):
            PRIOR_MSG_LEN = 1

            def generate_constraints(self, cs, msg, wit, priors, base):
                (priors[0] + wit).enforce_equal(msg)

        if self.device.type == "cuda":
            kernels.build(wait=False)      # every nvcc at once, first run
        self.pcd = getattr(configs, self.cfg["factory"])(self.device)
        F = self.F = self.pcd.ic.main_field
        self.pred = Counter(F)
        self.keys_seed = seed_bytes("keys", self.seed)
        self.pk, _ = self.pcd.circuit_specific_setup(
            self.pred, ChaChaRng(self.keys_seed))
        self._keep_main_proofs(self.pcd.ic.main_snark)
        self.rng = ChaChaRng(seed_bytes("prove", self.seed))
        self.wit = ChaChaRng(seed_bytes("witness", self.seed))
        w = self.wit.randrange(F.MODULUS)
        self.msg = w
        self.proof = self.pcd.prove(self.pk, self.pred, F.from_int(w),
                                    F.from_int(w), [], [], self.rng)
        for _ in range(self.mix["warm_steps"]):
            self._step()
        self._sync()

    def _keep_main_proofs(self, snark):
        """Keep each main proof the step makes, as it passes: the main
        SNARK's `prove` is wrapped on this one object."""
        prove = snark.prove

        def keep(*a, **k):
            self.main_proof = prove(*a, **k)
            return self.main_proof

        snark.prove = keep

    def _sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def _step(self):
        F = self.F
        w = self.wit.randrange(F.MODULUS)
        msg = (self.msg + w) % F.MODULUS
        self.proof = self.pcd.prove(self.pk, self.pred, F.from_int(msg),
                                    F.from_int(w), [F.from_int(self.msg)],
                                    [self.proof], self.rng)
        self.msg = msg

    def window(self, seconds: float) -> list:
        import torch

        records = []
        t_end = time.perf_counter() + seconds
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end and records:
                break
            try:
                with torch.profiler.record_function("bench/step"):
                    self._step()
                    self._sync()
            except Exception:                 # a failed request: reported
                traceback.print_exc()
                self.failed += 1
                break
            records.append((t0, time.perf_counter()))
            self.steps.append((self.msg, self.proof, self.main_proof))
        return records

    def free(self):
        """Keep what the check reads (the keys' points, the sampled
        proofs), as plain integers, and drop the program's state."""
        ic = self.pcd.ic
        kinds = [type(s).__name__.lower() for s in (ic.main_snark,
                                                    ic.help_snark)]
        self.kinds = kinds
        order = checks.VK_ORDER
        self.keys = {"crh_seed": self.pk.crh_pp.seed,
                     "main_vk": plain(self.pk.main_pvk.vk, order[kinds[0]]),
                     "help_vk": plain(self.pk.help_vk, order[kinds[1]])}
        n = len(self.steps)
        pick = random.Random(self.seed).sample(
            range(n - 1), min(self.mix["check_steps"], n - 1)) + [n - 1] \
            if n else []
        self.sample = [(msg, plain(pf, ("a", "b", "c")),
                        plain(main, ("a", "b", "c")))
                       for msg, pf, main in (self.steps[i]
                                             for i in sorted(pick))]
        self.cycle = "toy" if "toy" in ic.cycle.name else "mnt"
        del self.pcd, self.pk, self.proof, self.steps, self.main_proof

    def check(self, control: bool = False) -> dict:
        """{name: (number, limit)}: key elements and sampled steps whose
        proofs the reference rejects.  control: each proof judged against msg + 1."""
        got = checks.check_chain(self.cycle, self.kinds, self.keys_seed,
                                 self.keys, self.sample,
                                 shift=1 if control else 0)
        return {"bad_keys": (got["bad_keys"], 0),
                "bad_proofs": (got["bad_proofs"], 0)}
