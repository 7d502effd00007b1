"""One run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  Set-up (imports, the kernels' build on a
checkout's first run, the keys or tables from the seed, the warm-up of
every shape the window uses), then the measured window of `--seconds`,
then the check of what the window produced against the plain reference
(benchmark/reference/), run once the program's state is freed.  The last
line of standard output is the result; the last lines of standard error
are the numbers compared, each beside its limit.  Exits non-zero with no
result when there is no card, too few cards, or JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from . import registry, stats, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "pcd_tpu")


class Run:
    """What a window left for the metric readers: the requests' (start,
    end) host times, the window's and set-up's seconds, the program's span
    totals of the set-up and of the window, the profiler's events (traced
    runs), and the generator that made the traffic."""

    def __init__(self, gen, setup_s, records, spans=None, setup_spans=None,
                 events=None):
        self.gen = gen
        self.setup_s = setup_s
        self.records = records
        self.window_s = stats.window(records) if records else 0.0
        self.spans = spans or {}
        self.setup_spans = setup_spans or {}
        self.events = events


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, dev, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def knobs() -> dict:
    """The program's knobs as it runs them (the benchmark sets none)."""
    from pcd_tpu_torch.snark import msm_dispatch as md

    return {k: getattr(md, k) for k in ("SCHEDULER", "QUOTIENT", "KEYGEN",
                                        "WINDOW_BITS", "LANES")}


def main(argv=None, t_start=None, root=None, device=None,
         control=False) -> int:
    """Run one cell once; returns the exit code.  `device`, `control` and
    `root` are for the benchmark's own tests and tools: a CPU device skips
    the card checks, `control` judges the control's output in the
    program's place (benchmark/tools/control.py)."""
    t_start = time.perf_counter() if t_start is None else t_start
    out, err = sys.stdout, sys.stderr
    args = parse(argv)
    root = root or os.getcwd()
    bench = registry.load_benchmark(root)
    cell = registry.by_name(bench["workloads"], args.workload, "workload")
    cfg = registry.data("configs", cell["config"])
    mix = registry.data("traffic", cell["traffic"])

    import torch

    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            err.write(f"{args.workload} needs {cell['chips']} CUDA "
                      f"device(s); found "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
            return 2
        device = "cuda:0"
    dev = torch.device(device)
    traced = bool(args.trace)
    out_dir = os.path.join(root, "benchmark_out", args.workload,
                           f"seed{args.seed}")

    from pcd_tpu_torch.utils import profiling
    if traced:
        trace.annotate_spans()
        profiling.enable()
    gen = registry.kind(mix["kind"]).Generator(cfg, mix, args.seed, dev)
    gen.setup()
    setup_spans = profiling.totals()
    profiling.reset()
    out.write(json.dumps({"knobs": knobs()}) + "\n")
    out.flush()
    setup_s = time.perf_counter() - t_start

    events = None
    if traced:
        with trace.profiled(out_dir, dev.type == "cuda") as got:
            records = gen.window(args.seconds)
        events = trace.load(got["path"])
    else:
        records = gen.window(args.seconds)
    spans = profiling.totals()
    profiling.enable(False)
    device_rec = device_info(torch, dev, cell["chips"])

    found = loaded_forbidden()
    if found:
        err.write("modules of JAX or the JAX package were loaded: "
                  + ", ".join(found) + "\n")
        return 3

    run = Run(gen, setup_s, records, spans, setup_spans, events)
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in registry.cell_metrics(bench, args.workload, section):
        if not records:
            break
        v = registry.metric(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if traced and events is not None:
        device_rec["busy_s"] = trace.busy_s(events)
        device_rec["window_s"] = run.window_s

    gen.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = {"failed_requests": (gen.failed, 0),
              **gen.check(control=control)}
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": len(records) + gen.failed,
              "failed": gen.failed,
              "metrics": metrics, "device": device_rec}
    if traced and events is not None:
        result["breakdown"] = {"device_ops": trace.device_ops(events),
                               "idle_gaps": trace.idle_gaps(events)}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    out.write(json.dumps(result) + "\n")
    out.flush()
    took = sorted(b - a for a, b in records)
    if took:
        err.write(f"requests: {len(took)} in {run.window_s:.3f} s; each "
                  f"min {took[0]:.4f} median {took[len(took) // 2]:.4f} "
                  f"max {took[-1]:.4f} s; first three "
                  + ", ".join(f"{b - a:.4f}" for a, b in records[:3]) + "\n")
    for k, (v, lim) in checks.items():
        err.write(f"check {k}: {v} (limit {lim})\n")
    err.flush()
    return 0
