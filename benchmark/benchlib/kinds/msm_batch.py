"""Traffic kind "msm_batch": the commitment MSMs of one prove as one batch,
closed loop, one batch in flight.  Each batch gets fresh dense scalars;
the window drives the port's stream tier as a GM17 prove does
(`GM17._stream_launch`, `_stream_launch_h`): `msm_dispatch.stream_launch`
for the queries over z on one shared schedule, then `stream_msm_async`
for h from scalars on the card, then `stream_collect` of each.

The mix names the queries: [name, group, scalars], group "g1" or "g2" of
the configuration's main curve, scalars "z" (the configuration's "z"
scalars, host limbs, shared by those queries) or "h" ("domain" - 1
scalars on the card).  Set-up makes each query's table from the seed:
integers t_i, a query's 38 random bytes each, are taken to points t_i G by
the port's keygen kernel (K8, `ops/fixed_base.py`), and the table goes to
the card through `stream_table` as a proving key's query does; then one
batch warms every shape.  Batch i's scalars come from a numpy generator
seeded by (seed, i), uniform below 2^(bits - 1), bits the scalar field's.

Check: a sample of the window's batches, drawn from the seed, each MSM
against the reference's (sum s_i t_i mod r) G.
"""

from __future__ import annotations

import hashlib
import random
import time
import traceback
from types import SimpleNamespace

import numpy as np

from reference import checks


def seed_int(seed: int) -> int:
    return int.from_bytes(hashlib.sha256(f"msm:{seed}".encode()).digest()
                          [:8], "little")


class Generator:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.failed = 0           # batches that raised
        self.results = {}         # batch -> {query: program's point}

    # -- the scalars -----------------------------------------------------
    def sizes(self) -> dict:
        return {"z": self.cfg["main"]["z"], "h": self.cfg["main"]["domain"]
                - 1}

    def scalars(self, i: int) -> dict:
        """Batch i's scalars, uniform below 2^(bits - 1): {"z": (n, 5)
        u64 host limbs from a numpy generator seeded by (seed, i), "h":
        (m, 10) int32 words on the device from a torch generator seeded
        by (seed, i)}."""
        import torch

        sizes = self.sizes()
        top = self.bits - 1
        z = np.random.default_rng([seed_int(self.seed), i]).integers(
            0, 1 << 64, size=(sizes["z"], 5), dtype=np.uint64)
        for j in range(5):
            z[:, j] &= np.uint64((1 << min(max(top - 64 * j, 0), 64)) - 1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((seed_int(self.seed) ^ i) & ((1 << 63) - 1))
        h = torch.randint(-(1 << 31), 1 << 31, (sizes["h"], 10),
                          dtype=torch.int32, generator=gen,
                          device=self.device)
        for j in range(10):
            keep = min(max(top - 32 * j, 0), 32)
            if keep < 32:
                h[:, j] &= (1 << keep) - 1
        return {"z": z, "h": h}

    def host_scalars(self, i: int) -> dict:
        """Batch i's scalars as (n, 5) u64 host limbs, by key."""
        from pcd_tpu_torch.ops.field import limbs_host

        sc = self.scalars(i)
        return {"z": sc["z"], "h": limbs_host(sc["h"])}

    # -- set-up ----------------------------------------------------------
    def setup(self):
        import torch

        from pcd_tpu_torch.curves import models
        from pcd_tpu_torch.ops import kernels
        from pcd_tpu_torch.ops.fixed_base import fixed_base_device

        if self.device.type == "cuda":
            kernels.build(wait=False)      # every nvcc at once, first run
        self.curve = getattr(models, self.cfg["main"]["curve"])()
        self.bits = self.curve.Fr.BITS
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed_int(self.seed) & ((1 << 63) - 1))
        self.pk = SimpleNamespace()
        self.owner = SimpleNamespace()       # holds the MSM streams
        self.t_bytes = {}
        sizes = self.sizes()
        for name, grp, key in self.mix["queries"]:
            curve = self.curve.g1 if grp == "g1" else self.curve.g2
            base = self.curve.g1_gen if grp == "g1" else self.curve.g2_gen
            fb = fixed_base_device(curve, base, self.bits)
            n = sizes[key]
            digits = torch.randint(0, 256, (fb.nwin, n), dtype=torch.uint8,
                                   generator=gen, device=self.device)
            out = fb.mul_digits(digits).cpu().numpy().view(np.uint32)
            self.t_bytes[name] = np.ascontiguousarray(
                digits.cpu().numpy().T)                   # (n, nwin)
            setattr(self.pk, name, encoded(curve, out))
        self.batch(0, self.scalars(0), keep=False)   # every shape, once

    def batch(self, i: int, sc: dict, keep: bool = True):
        """Batch i on its scalars sc: the queries' MSMs, launch to collect
        (batch 0 is the set-up's, the window's are 1, 2, ...)."""
        import torch

        from pcd_tpu_torch.snark.msm_dispatch import (side_stream,
                                                      stream_collect,
                                                      stream_launch,
                                                      stream_msm_async)
        from pcd_tpu_torch.utils.profiling import span

        g = {"g1": self.curve.g1, "g2": self.curve.g2}
        dev = self.device
        zq = tuple((n, g[grp]) for n, grp, key in self.mix["queries"]
                   if key == "z")
        hq = [(n, g[grp]) for n, grp, key in self.mix["queries"]
              if key == "h"]
        with torch.profiler.record_function("bench/batch"):
            h = sc["h"]
            with side_stream(self.owner, dev) as sched:
                futs = stream_launch(self.pk, zq, hq[0][1], self.bits,
                                     sc["z"], dev, sched)
            with side_stream(self.owner, dev, (h,)) as sched, \
                    span("stream_dispatch_h"):
                for n, curve in hq:
                    futs[n] = stream_msm_async(self.pk, n, curve, self.bits,
                                               h, dev, sched_stream=sched)
            got = {n: stream_collect(f) for n, f in futs.items()}
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
        """Points of one batch."""
        sizes = self.sizes()
        return sum(sizes[key] for _, _, key in self.mix["queries"])

    def work(self, i: int):
        """Batch i's scalars as (n, 10) int32 word tensors on the card:
        ({"z": tensor, "h": tensor}, [(query, its scalars' key, the
        degree of its curve's coordinate field)])."""
        import torch

        sc = self.scalars(i)
        deg = {"g1": 1, "g2": self.curve.g2.F.extension_degree_over_prime()}
        return ({"z": torch.from_numpy(sc["z"].view(np.int32)).to(
            self.device), "h": sc["h"]},
                [(n, key, deg[grp]) for n, grp, key in self.mix["queries"]])

    # -- check -----------------------------------------------------------
    def free(self):
        done = sorted(self.results)
        pick = random.Random(self.seed).sample(
            done, min(self.mix["check_batches"], len(done)))
        self.sample = {i: {q: checks.encode(p) for q, p in
                           self.results[i].items()} for i in sorted(pick)}
        self.groups = {n: grp for n, grp, _ in self.mix["queries"]}
        self.keys = {n: key for n, _, key in self.mix["queries"]}
        self.cycle_cfg = self.cfg["main"]["curve"]
        del self.pk, self.owner, self.results

    def check(self, control: bool = False) -> dict:
        """{name: (number, limit)}: sampled MSMs that differ from the
        reference.  control: the reference's MSMs of the scalars with the
        top 12-bit window left out, in the program's place."""
        from reference import models

        cfg = getattr(models, self.cycle_cfg)()
        t = {q: [int.from_bytes(row.tobytes(), "little")
                 for row in tb] for q, tb in self.t_bytes.items()}
        bad = 0
        for i, got in self.sample.items():
            s_of = {k: [int.from_bytes(row.tobytes(), "little")
                        for row in v]
                    for k, v in self.host_scalars(i).items()}
            for q, grp in self.groups.items():
                s = s_of[self.keys[q]]
                want = checks.msm_expected(cfg, grp, t[q], s)
                if control:
                    cut = 1 << (12 * ((self.bits - 1) // 12))
                    got[q] = checks.msm_expected(cfg, grp, t[q],
                                                 [v % cut for v in s])
                bad += int(got[q] != want)
        return {"bad_msms": (bad, 0)}


def encoded(curve, out: np.ndarray):
    """K8's (n, 2, d, 10) affine canonical words as the C++ tier's
    EncodedPoints table, with no host point objects."""
    from pcd_tpu_torch import native
    from pcd_tpu_torch.native import EncodedPoints

    n, _, d, _ = out.shape
    inf = (out[:, 0, 0, 9] >> 31).astype(bool)
    words = out.copy()
    words[:, 0, 0, 9] &= np.uint32(0x7FFFFFFF)
    xy = words.reshape(n, -1).view("<u8")                  # (n, 2 d 5)
    enc = object.__new__(EncodedPoints)
    enc.curve = curve
    enc.handle, enc.deg, _ = native.curve_handle(curve)
    enc.xs = np.ascontiguousarray(xy[:, : 5 * d])
    enc.ys = np.ascontiguousarray(xy[:, 5 * d:])
    enc.inf = inf.astype(np.uint8)
    enc.n = n
    return enc
