"""Toy-size runs of the harness on the CPU, for the benchmark's tests: a
copy of benchmark/ in a scratch root with toy cells added as new files,
and one run of a cell there in a child process, with the card checks
skipped (cli.main's `device`), the toy cycle's stream-MSM shape (8-bit
windows on 2,048 lanes, as the port's tests use) and, optionally, one of
FAULTS planted under the timed path."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TOY_CONFIGS = {
    "toy_groth16": {"name": "toy_groth16", "factory": "toy_groth16",
                    "main": {"snark": "groth16", "curve": "toy_mnt4"}},
    "toy_gm17": {"name": "toy_gm17", "factory": "toy_gm17",
                 "main": {"snark": "gm17", "curve": "toy_mnt4", "z": 300,
                          "domain": 512}},
}
TOY_CELLS = {"toy_g16_chain": ("toy_groth16", "ivc_counter"),
             "toy_gm17_chain": ("toy_gm17", "ivc_counter"),
             "toy_gm17_msm": ("toy_gm17", "gm17_commit_msm")}

# faults planted in the child before the run; each names what it breaks
FAULTS = {
    # a step that returns its state unchanged: the prior proof again
    "stale_step": """
from pcd_tpu_torch.pcd.ec_cycle import ECCyclePCD
_prove = ECCyclePCD.prove
def prove(self, pk, pred, msg, wit, prior_msgs, prior_proofs, rng):
    if prior_proofs:
        return prior_proofs[0]
    return _prove(self, pk, pred, msg, wit, prior_msgs, prior_proofs, rng)
ECCyclePCD.prove = prove
""",
    # an answer altered where it is produced: the help proof's A doubled,
    # from the window's first step on (the set-up proves the base case and
    # one warm step)
    "altered_proof": """
from pcd_tpu_torch.pcd.ec_cycle import ECCyclePCD
_prove, _calls = ECCyclePCD.prove, []
def prove(*a, **k):
    pf = _prove(*a, **k)
    _calls.append(1)
    if len(_calls) > 2:
        pf.a = pf.a.double()
    return pf
ECCyclePCD.prove = prove
""",
    # half of the batch left out: each MSM over its first half of rows
    "half_batch": """
from pcd_tpu_torch.snark import msm_dispatch
_async = msm_dispatch.stream_msm_async
def stream_msm_async(pk, nm, curve, bits, scal, *a, **k):
    scal = scal.clone() if hasattr(scal, "clone") else scal.copy()
    scal[scal.shape[0] // 2:] = 0
    return _async(pk, nm, curve, bits, scal, *a, **k)
msm_dispatch.stream_msm_async = stream_msm_async
""",
    # an answer altered where it is produced: each MSM's sum doubled
    "altered_msm": """
from pcd_tpu_torch.snark import msm_dispatch
_collect = msm_dispatch.stream_collect
msm_dispatch.stream_collect = lambda fut: _collect(fut).double()
""",
}


def make_root(tmp: str) -> str:
    """A scratch checkout: BENCHMARK.json with the toy cells added, and a
    copy of benchmark/ with the toy configurations added."""
    root = os.path.join(tmp, "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, cfg in TOY_CONFIGS.items():
        path = os.path.join(root, "benchmark", "configs", name + ".json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": "toy cycle",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "toy"})
    for cell, (cfg, mix) in TOY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["toy_" + w for w in m["workloads"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root


RUNNER = """
import sys, time
T = time.perf_counter()
root, fault, control = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
sys.path[:0] = [root + "/benchmark", {repo!r}]
import pcd_tpu_torch.snark.msm_dispatch as md
from pcd_tpu_torch.snark.gm17.native import GM17
from pcd_tpu_torch.snark.groth16.native import Groth16
md.WINDOW_BITS, md.LANES = 8, 2048
Groth16.STREAM_MIN = GM17.STREAM_MIN = 0
exec(FAULTS.get(fault, ""))
from benchlib import cli
sys.exit(cli.main(sys.argv[4:], t_start=T, root=root, device="cpu",
                  control=control))
"""


def run(root: str, cell: str, seed: int, seconds: float = 2, trace: int = 0,
        control: bool = False, fault: str = "none", timeout: int = 900):
    """One toy run in a child process: (exit code, result or None,
    stderr)."""
    code = "FAULTS = " + repr(FAULTS) + "\n" + RUNNER.format(repo=REPO)
    p = subprocess.run(
        [sys.executable, "-c", code, root, fault, "1" if control else "0",
         "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)],
        capture_output=True, text=True, timeout=timeout, cwd=root)
    lines = p.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if lines and lines[-1].startswith(
        '{"correct"') else None
    return p.returncode, res, p.stderr
