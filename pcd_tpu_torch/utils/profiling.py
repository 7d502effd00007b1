"""Structured span timing + device profiling hooks (SURVEY.md §5: the
reference has only a `print-trace` cargo feature forwarding to ark-std
timers; this framework treats observability as a real subsystem).

The port's copy of `pcd_tpu/utils/profiling.py`; its `device_trace` is a
torch.profiler capture where the reference's is jax.profiler's.

Usage:
    from pcd_tpu_torch.utils.profiling import span, profile_report, enable

    enable()
    with span("prove/main/msm_a"):
        ...
    print(profile_report())
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

_state = threading.local()
_enabled = False
_totals = defaultdict(lambda: [0.0, 0])  # name -> [seconds, count]
_lock = threading.Lock()


def enable(on: bool = True):
    global _enabled
    _enabled = on


def reset():
    with _lock:
        _totals.clear()


@contextlib.contextmanager
def span(name: str):
    """Nested span timer; totals accumulate per hierarchical name."""
    if not _enabled:
        yield
        return
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = []
        _state.stack = stack
    full = "/".join([s for s, _ in stack] + [name])
    stack.append((name, time.perf_counter()))
    try:
        yield
    finally:
        _, t0 = stack.pop()
        dt = time.perf_counter() - t0
        with _lock:
            tot = _totals[full]
            tot[0] += dt
            tot[1] += 1


def profile_report(min_seconds: float = 0.0) -> str:
    with _lock:
        rows = sorted(_totals.items(), key=lambda kv: -kv[1][0])
    lines = [f"{'span':<50} {'total_s':>10} {'count':>8} {'avg_ms':>10}"]
    for name, (secs, cnt) in rows:
        if secs < min_seconds:
            continue
        lines.append(f"{name:<50} {secs:>10.2f} {cnt:>8} "
                     f"{1000 * secs / max(cnt, 1):>10.1f}")
    return "\n".join(lines)


def totals() -> dict:
    with _lock:
        return {k: tuple(v) for k, v in _totals.items()}



@contextlib.contextmanager
def device_trace(logdir: str):
    """Card timeline capture via torch.profiler (host activity, and the
    card's kernels and copies where CUDA is available), written to
    `logdir`/trace.json as a Chrome trace when the block ends.  Yields
    the profiler, whose events() the caller may read afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
