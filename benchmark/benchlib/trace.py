"""The traced run's instruments: the program's span totals, a
torch.profiler capture of the window, and what the harness reads from
them (the card's busy seconds, the device
operations that took most time, the idle gaps by the host span they fell
in, a kernel's seconds)."""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def annotate_spans():
    """Make the program's `span` also open a torch.profiler annotation of
    its name, so that the trace shows what the host was doing.  Call it
    before any module of the program that uses `span` is imported (they
    bind the function when imported); the totals are as before."""
    import torch

    from pcd_tpu_torch.utils import profiling

    plain = profiling.span

    @contextlib.contextmanager
    def span(name: str):
        with plain(name), torch.profiler.record_function(name):
            yield

    profiling.span = span


@contextlib.contextmanager
def profiled(out_dir: str, cuda: bool):
    """torch.profiler over the block; yields a dict that gets "path", the
    trace file written when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    got = {}
    with profile(activities=acts) as prof:
        yield got
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    got["path"] = path


def load(path: str) -> dict:
    """The events of a Chrome trace: {"device": [(name, start_us, dur_us)],
    "host": [(name, start_us, dur_us)] of the annotations}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        row = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            dev.append(row)
        elif cat == "user_annotation":
            host.append(row)
    return {"device": dev, "host": host}


def merged(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(ev: dict) -> float:
    """Seconds in which some operation ran on the card."""
    return sum(e - s for s, e in merged(
        (t, t + d) for _, t, d in ev["device"])) / 1e6


def device_ops(ev: dict, top: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time,
    summed by name."""
    tot = defaultdict(float)
    for name, _, d in ev["device"]:
        tot[name] += d / 1e6
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def idle_gaps(ev: dict, top: int = 10) -> list:
    """[[host span, seconds]]: the card's idle time between its first and
    last operation, each gap given to the innermost host annotation that
    holds the gap's middle ("none" when none does), summed by name."""
    busy = merged((t, t + d) for _, t, d in ev["device"])
    spans = sorted(ev["host"], key=lambda r: r[2])      # innermost first
    tot = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        name = next((n for n, t, d in spans if t <= mid <= t + d), "none")
        tot[name] += (b - a) / 1e6
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def kernel_s(ev: dict, needle: str) -> float:
    """Seconds of the kernels whose name holds `needle`."""
    return sum(d for n, _, d in ev["device"] if needle in n) / 1e6


def _under(k: str, names) -> bool:
    """Whether span name `k` is, or ends in, one of `names` (span names
    join their enclosing spans' with "/")."""
    return any(k == n or k.endswith("/" + n) for n in names)


def _outermost(keys) -> list:
    """The span names of `keys` that no other one of them encloses."""
    return [k for k in keys
            if not any(k.startswith(o + "/") for o in keys if o != k)]


def span_sum(totals: dict, leaves, less=()) -> float:
    """Seconds of the program's spans whose name is, or ends in, one of
    `leaves`, each second counted once: a span that another counted span
    encloses is not counted again, and the spans named in `less` that a
    counted span encloses are taken off it (their own outermost only)."""
    outer = _outermost([k for k in totals if _under(k, leaves)])
    off = _outermost([k for k in totals if _under(k, less) and any(
        k.startswith(o + "/") for o in outer)])
    return (sum(totals[k][0] for k in outer)
            - sum(totals[k][0] for k in off))


def span_per_request(run, leaves, less=(), scale: float = 1.0):
    """span_sum over the traced window's spans, per request of the
    window, times `scale`; None where the spans are not there."""
    s = span_sum(run.spans, leaves, less)
    return scale * s / len(run.records) if s > 0 else None
