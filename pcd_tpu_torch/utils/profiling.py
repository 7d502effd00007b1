"""Structured spans, counters and the card's timeline (SURVEY.md §5: the
reference has only a `print-trace` cargo feature forwarding to ark-std
timers; this framework treats observability as a real subsystem).

The port's counterpart of `pcd_tpu/utils/profiling.py`, whose spans keep
totals alone; its `device_trace` is a torch.profiler capture where the
reference's is jax.profiler's.

While `enable()` is on:
  span      adds its seconds to `totals()` under its name joined to its
            enclosing spans' names with "/", and keeps a `Record`: name,
            start and end on `time.perf_counter_ns()`, the index of its
            enclosing span's record (its parent, on the same thread), the
            thread and the request.  At most MAX_RECORDS are kept; those
            past the cap are counted by `dropped()`.
  count     adds to `counters()`.
Off, neither does anything and `span` costs one flag test.

A request is one prove's MSMs or one IVC step: `request()` holds one for
a block, or as a decorator for each call (ECCyclePCD.prove: a step);
`open_request()` opens one unless a block holds one, current on the
thread until the next opens (msm_dispatch.stream_launch); `in_request`
carries the thread's request to a function run on another thread (the
provers' background launch).  A record carries the request current when
it opened; the stream MSM's futures carry theirs to the collect.

The shared clock: the first span opened while a torch profiler records
also opens one `record_function(ANCHOR)` marker and keeps the
perf_counter_ns read inside it (`anchor()`).  A record's time t maps onto
that trace's microseconds as marker_ts + (t - anchor()) / 1000, so the
program's records line up with the card's operations without any
annotation of their own.  `reset()` clears the totals, counters, records
and anchor; the next profiled span takes a new anchor.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, namedtuple

Record = namedtuple("Record", "name start_ns end_ns parent thread request")
MAX_RECORDS = 1 << 17
ANCHOR = "profiling/anchor"

_state = threading.local()
_enabled = False
_totals = defaultdict(lambda: [0.0, 0])  # name -> [seconds, count]
_counters = defaultdict(int)
_records = []            # Record fields as tuples, end None while open
_dropped = 0
_anchor = None
_lock = threading.Lock()
_request_ids = itertools.count(1)
_autograd_profiler = None       # torch.autograd.profiler, once enabled


def enable(on: bool = True):
    """Turn recording on or off.  Turning it on outside a profiler also
    enters one unrecorded `record_function`, so that the anchor's marker,
    later, does not pay torch's first-call set-up (about a millisecond,
    which would skew the shared clock by as much)."""
    global _enabled, _autograd_profiler
    _enabled = on
    if on:
        import torch

        _autograd_profiler = torch.autograd.profiler
        if not _profiler_on():
            with torch.profiler.record_function(ANCHOR):
                pass


def reset():
    global _records, _dropped, _anchor
    with _lock:
        _totals.clear()
        _counters.clear()
        _records = []
        _dropped = 0
        _anchor = None


def _profiler_on() -> bool:
    """Whether a torch profiler records."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def _take_anchor():
    """The anchor, where none is taken."""
    global _anchor
    with _lock:
        if _anchor is None:
            with _autograd_profiler.record_function(ANCHOR):
                _anchor = time.perf_counter_ns()


@contextlib.contextmanager
def span(name: str):
    """Nested span timer; totals accumulate per hierarchical name."""
    global _dropped
    if not _enabled:
        yield
        return
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = []
        _state.stack = stack
    if _anchor is None and _profiler_on():
        _take_anchor()
    up = stack[-1] if stack else None
    full = name if up is None else up[0] + "/" + name
    t0 = time.perf_counter_ns()
    with _lock:
        kept = _records
        idx = None
        if len(kept) < MAX_RECORDS:
            parent = up[1] if up is not None and up[2] is kept else None
            rec = (name, t0, None, parent, threading.get_ident(),
                   request_id())
            idx = len(kept)
            kept.append(rec)
        else:
            _dropped += 1
    stack.append((full, idx, kept))
    try:
        yield
    finally:
        stack.pop()
        t1 = time.perf_counter_ns()
        with _lock:
            tot = _totals[full]
            tot[0] += (t1 - t0) / 1e9
            tot[1] += 1
            if idx is not None:
                kept[idx] = rec[:2] + (t1,) + rec[3:]


def totals() -> dict:
    with _lock:
        return {k: tuple(v) for k, v in _totals.items()}


def records() -> list:
    """The kept span records, in the order they opened (a record's parent
    is an index into this list; end_ns None while a span is open)."""
    with _lock:
        return [Record(*r) for r in _records]


def dropped() -> int:
    """Spans opened past MAX_RECORDS since the last reset."""
    return _dropped


def anchor():
    """perf_counter_ns inside the `ANCHOR` marker, or None where no span
    opened under a profiler since the last reset."""
    return _anchor


def count(name: str, n: int):
    """Add n to counter `name`, while recording is on."""
    if not _enabled:
        return
    with _lock:
        _counters[name] += n


def counters() -> dict:
    with _lock:
        return dict(_counters)


def request_id():
    """The thread's current request, or None."""
    held = getattr(_state, "requests", None)
    return held[-1] if held else getattr(_state, "open", None)


def open_request() -> int:
    """The request a `request` block holds on this thread, else a new one,
    current on the thread until the next opens."""
    held = getattr(_state, "requests", None)
    if held:
        return held[-1]
    _state.open = next(_request_ids)
    return _state.open


@contextlib.contextmanager
def request(rid=None):
    """The block's spans belong to request `rid` (None: a new one)."""
    held = getattr(_state, "requests", None)
    if held is None:
        held = []
        _state.requests = held
    held.append(next(_request_ids) if rid is None else rid)
    try:
        yield held[-1]
    finally:
        held.pop()


def in_request(fn):
    """fn, to run on another thread in this thread's request (opened here
    as `open_request` does)."""
    rid = open_request()

    def run(*args, **kwargs):
        with request(rid):
            return fn(*args, **kwargs)

    return run


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
