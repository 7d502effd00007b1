"""Run one cell several times, one process a run, as the benchmark's
checks do, and keep every result:

    python3 benchmark/tools/runs.py --workload g16_chain --seeds 11,12,13 \
        --seconds 51 --trace 0 [--control] [--out benchmark_out/runs.jsonl]

from the root of a checkout.  Each run is `python3 benchmark/run.py ...`
(or, with --control, benchmark/tools/control.py: the control judged in
the program's place); its exit code, seconds, last stdout line (the
result) and last stderr lines (the numbers compared) are appended to
--out as one JSON line, and a short line is printed.  With several runs,
the spread of each end-to-end metric (interquartile distance over the
median) is printed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from benchlib.stats import spread  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default="benchmark_out/runs.jsonl")
    a = ap.parse_args(argv)
    script = os.path.join(HERE, "tools" if a.control else "",
                          "control.py" if a.control else "run.py")
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    print("card:", card(), flush=True)
    vals = {}
    worst = 0
    for seed in a.seeds.split(","):
        cmd = [sys.executable, script, "--workload", a.workload, "--seed",
               seed, "--seconds", str(a.seconds), "--trace", str(a.trace)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True)
        took = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        rec = {"workload": a.workload, "seed": int(seed), "trace": a.trace,
               "control": a.control, "seconds": a.seconds, "rc": p.returncode,
               "took_s": took, "knobs": lines[0] if lines else None,
               "result": res, "stderr_tail": p.stderr[-3000:]}
        with open(a.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        worst = max(worst, p.returncode)
        if res is None:
            print(f"seed {seed}: rc {p.returncode} in {took:.1f}s, no "
                  f"result\n{p.stderr[-2500:]}", flush=True)
            continue
        short = {k: v["value"] for k, v in res["metrics"].items()}
        for k, v in short.items():
            vals.setdefault(k, []).append(v)
        dev = {k: res["device"].get(k) for k in ("memory_peak_bytes",
                                                 "busy_s", "window_s")}
        print(f"seed {seed}: rc {p.returncode} in {took:.1f}s correct "
              f"{res['correct']} attempted {res['attempted']} "
              f"{json.dumps(short)} {json.dumps(dev)} checks "
              f"{json.dumps(res.get('checks'))}", flush=True)
        if res.get("breakdown"):
            print("  breakdown " + json.dumps(res["breakdown"]), flush=True)
    for k, v in vals.items():
        if len(v) >= 2:
            print(f"{k}: median {sorted(v)[len(v) // 2]} spread "
                  f"{spread(v):.5f} over {len(v)} runs", flush=True)
    return worst


if __name__ == "__main__":
    sys.exit(main())
