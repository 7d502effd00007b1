"""Traffic kind "step_msm": one warm IVC step's commitment phase as one
batch, closed loop, one batch in flight.  A step proves on both curves of
the cycle in turn: the main side, then the help side once the main proof
is assembled, as a chain does.  Each side is an instance of the program's
`Groth16` on its curve, with a `Groth16PK` of the benchmark's own; the
window calls its `_stream_launch` (a, b_g1, b_g2 and l over z, l padded
to z by `msm_dispatch.zpad_query`, on one schedule) and then its
`_prove_commit` (the h MSM through `_stream_launch_h`, the five collects
and the proof's assembly), each side inside a profiling request the
generator keeps (`help_requests`: the help side's, a batch).

The mix names the sides ("side": the configuration's "main" or "help",
"n_inst": the instance columns of the program's circuit on that side)
and the queries, [name, group, rows]: group "g1" or "g2" of the side's
curve, rows "z" (the configuration's z), "l" (z less n_inst) or "h" (its
"domain" - 1).  Set-up makes each table from the seed: integers t_i, 38
random bytes each, go to points t_i G by the port's keygen kernel (K8,
`ops/fixed_base.py`), whose words become the table through
`EncodedPoints.from_affine_words`, with no host point objects; alpha,
beta and delta, uniform in [1, r) from the seed, become host points of
the key.  One batch then warms every shape.  Batch i's scalars: z (host
limbs) and h (on the card) uniform below 2^(bits - 1), fresh for each
side, and r', s' uniform in [0, r), all from (seed, i, side).

Check: the sides of a sample of the window's batches, drawn from the
seed, whose A, B or C differs from the reference's
(`reference/commit.groth16_proof`, from the same scalars).
"""

from __future__ import annotations

import hashlib
import random
import time
import traceback
from types import SimpleNamespace

import numpy as np

from reference import checks
from reference.commit import groth16_proof


def seed_int(seed: int, *parts) -> int:
    """63 bits of sha256 of the seed and `parts`."""
    text = ":".join(["step", str(seed)] + [str(p) for p in parts])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") & ((1 << 63) - 1)


class Generator:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.failed = 0           # batches that raised
        self.results = {}         # batch -> {side: program's proof}
        self.help_requests = []   # the window's help sides' requests

    # -- the scalars -----------------------------------------------------
    def sizes(self, side: str, n_inst: int) -> dict:
        z, domain = self.cfg[side]["z"], self.cfg[side]["domain"]
        return {"z": z, "l": z - n_inst, "h": domain - 1}

    def scalars(self, i: int) -> dict:
        """Batch i's scalars by side: {"z": (n, 5) u64 host limbs, "h":
        (m, 10) int32 words on the device, both uniform below
        2^(bits - 1), "rs": (r', s') uniform in [0, r)}."""
        import torch

        top = self.bits - 1
        out = {}
        for sd in self.mix["sides"]:
            side = sd["side"]
            sz = self.sizes(side, sd["n_inst"])
            z = np.random.default_rng(seed_int(self.seed, i, side)).integers(
                0, 1 << 64, size=(sz["z"], 5), dtype=np.uint64)
            for j in range(5):
                z[:, j] &= np.uint64((1 << min(max(top - 64 * j, 0), 64)) - 1)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed_int(self.seed, i, side, "h"))
            h = torch.randint(-(1 << 31), 1 << 31, (sz["h"], 10),
                              dtype=torch.int32, generator=gen,
                              device=self.device)
            for j in range(10):
                keep = min(max(top - 32 * j, 0), 32)
                if keep < 32:
                    h[:, j] &= (1 << keep) - 1
            pick = random.Random(seed_int(self.seed, i, side, "rs"))
            out[side] = {"z": z, "h": h, "rs": (pick.randrange(self.r[side]),
                                                pick.randrange(self.r[side]))}
        return out

    # -- set-up ----------------------------------------------------------
    def setup(self):
        import torch

        # a program without the table constructor stops here, before any
        # build
        from pcd_tpu_torch.native import EncodedPoints
        make = EncodedPoints.from_affine_words

        from pcd_tpu_torch.curves import models
        from pcd_tpu_torch.ops import kernels
        from pcd_tpu_torch.ops.fixed_base import fixed_base_device
        from pcd_tpu_torch.snark.groth16.native import (Groth16, Groth16PK,
                                                        Groth16VK)

        if self.device.type == "cuda":
            kernels.build(wait=False)      # every nvcc at once, first run
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed_int(self.seed, "tables"))
        trap = random.Random(seed_int(self.seed, "trapdoor"))
        self.sides, self.r = [], {}
        bits = set()
        for sd in self.mix["sides"]:
            side, n_inst = sd["side"], sd["n_inst"]
            name = self.cfg[side]["curve"]
            cc = getattr(models, name)()
            sz = self.sizes(side, n_inst)
            tables, t_bytes = {}, {}
            for nm, grp, rows in self.mix["queries"]:
                curve, base = ((cc.g1, cc.g1_gen) if grp == "g1"
                               else (cc.g2, cc.g2_gen))
                fb = fixed_base_device(curve, base, cc.Fr.BITS)
                digits = torch.randint(0, 256, (fb.nwin, sz[rows]),
                                       dtype=torch.uint8, generator=gen,
                                       device=self.device)
                tables[nm] = make(curve, fb.mul_digits(digits))
                t_bytes[nm] = np.ascontiguousarray(digits.cpu().numpy().T)
            r = cc.Fr.MODULUS
            td = tuple(trap.randrange(1, r) for _ in range(3))
            alpha, beta, delta = td
            vk = Groth16VK(alpha_g1=cc.g1_gen * alpha,
                           beta_g2=cc.g2_gen * beta, gamma_g2=None,
                           delta_g2=cc.g2_gen * delta, gamma_abc=[])
            pk = Groth16PK(vk=vk, beta_g1=cc.g1_gen * beta,
                           delta_g1=cc.g1_gen * delta, num_instance=n_inst,
                           domain_size=self.cfg[side]["domain"], **tables)
            self.sides.append(SimpleNamespace(
                side=side, curve=name, n_inst=n_inst, g16=Groth16(
                    cc, self.device), pk=pk, trapdoor=td, t_bytes=t_bytes,
                deg={"g1": 1, "g2": cc.g2.F.extension_degree_over_prime()}))
            self.r[side] = r
            bits.add(cc.Fr.BITS)
        (self.bits,) = bits
        self.batch(0, self.scalars(0), keep=False)   # every shape, once

    def batch(self, i: int, sc: dict, keep: bool = True):
        """Batch i on its scalars sc: main's commitments, then help's
        (batch 0 is the set-up's, the window's are 1, 2, ...)."""
        import torch

        from pcd_tpu_torch.utils import profiling

        got = {}
        with torch.profiler.record_function("bench/batch"):
            for sd in self.sides:
                s = sc[sd.side]
                with profiling.request() as rid:
                    futs = sd.g16._stream_launch(sd.pk, s["z"], sd.n_inst)
                    got[sd.side] = sd.g16._prove_commit(
                        sd.pk, sd.n_inst, None, s["h"], *s["rs"],
                        z_limbs=s["z"], hybrid=futs)
                if keep and sd.side == "help":
                    self.help_requests.append(rid)
        if keep:
            self.results[i] = got

    def window(self, seconds: float) -> list:
        records = []
        t_end = time.perf_counter() + seconds
        while True:
            if time.perf_counter() >= t_end and records:
                break
            i = len(records) + self.failed + 1
            sc = self.scalars(i)          # the client's, not the latency's
            t0 = time.perf_counter()
            try:
                self.batch(i, sc)
            except Exception:                 # a failed request: reported
                traceback.print_exc()
                self.failed += 1
                continue
            records.append((t0, time.perf_counter()))
        return records

    def points(self) -> int:
        """Rows of one batch, l at its padded length (z), as the program
        schedules it."""
        return sum(4 * self.cfg[sd["side"]]["z"]
                   + self.cfg[sd["side"]]["domain"] - 1
                   for sd in self.mix["sides"])

    def work(self, i: int):
        """Batch i's scalars as (n, 10) int32 word tensors on the card:
        ({"<side>.z": tensor, "<side>.h": tensor}, [(side.query, its
        scalars' key, the degree of its curve's coordinate field)]), the
        padded l over z."""
        import torch

        sc = self.scalars(i)
        scal, queries = {}, []
        for sd in self.sides:
            s = sc[sd.side]
            scal[sd.side + ".z"] = torch.from_numpy(
                s["z"].view(np.int32)).to(self.device)
            scal[sd.side + ".h"] = s["h"]
            queries += [(f"{sd.side}.{nm}",
                         sd.side + (".h" if rows == "h" else ".z"),
                         sd.deg[grp])
                        for nm, grp, rows in self.mix["queries"]]
        return scal, queries

    # -- check -----------------------------------------------------------
    def free(self):
        done = sorted(self.results)
        pick = random.Random(self.seed).sample(
            done, min(self.mix["check_batches"], len(done)))
        self.sample = {i: {side: {k: checks.encode(getattr(pf, k))
                                  for k in ("a", "b", "c")}
                           for side, pf in self.results[i].items()}
                       for i in sorted(pick)}
        for sd in self.sides:
            del sd.g16, sd.pk
        del self.results

    def check(self, control: bool = False) -> dict:
        """{name: (number, limit)}: the sampled batches' sides whose A, B
        or C differs from the reference's.  control: the reference's
        proofs of the scalars with the top 12-bit window left out, in the
        program's place."""
        from pcd_tpu_torch.ops.field import limbs_host
        from reference import models

        def ints(rows):
            return [int.from_bytes(row.tobytes(), "little") for row in rows]

        ref = {}
        for sd in self.sides:
            ref[sd.side] = (getattr(models, sd.curve)(),
                            {q: ints(tb) for q, tb in sd.t_bytes.items()})
        cut = 1 << (12 * ((self.bits - 1) // 12))
        bad = 0
        for i, got in self.sample.items():
            sc = self.scalars(i)
            for sd in self.sides:
                cfg, t = ref[sd.side]
                s = sc[sd.side]
                z, h = ints(s["z"]), ints(limbs_host(s["h"]))
                want = groth16_proof(cfg, t, z, h, sd.n_inst, sd.trapdoor,
                                     s["rs"])
                if control:
                    got[sd.side] = groth16_proof(
                        cfg, t, [v % cut for v in z], [v % cut for v in h],
                        sd.n_inst, sd.trapdoor, s["rs"])
                bad += int(got[sd.side] != want)
        return {"bad_proofs": (bad, 0)}
