"""The readers of the stream MSM's schedule, upload and collect on a
synthetic window: each span reader on the program's nested span totals,
`h2d_mb` on the program's counter, `sched_idle_ms` on synthetic device
events and program records with a known anchor offset, and each of them
with nothing to read (a program that keeps no such span, counter, record
or anchor, or a run with no trace of the card)."""

import os
import sys
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from benchlib import registry  # noqa: E402
from benchlib.cli import Run  # noqa: E402

from pcd_tpu_torch.utils import profiling  # noqa: E402

# two batches' span totals as profiling.totals() gives them (seconds)
SPANS = {
    "stream_dispatch": (0.800, 2),
    "stream_dispatch/sched_digest": (0.060, 6),
    "stream_dispatch/schedule_host": (0.600, 2),
    "stream_dispatch/schedule_host/sched_fit": (0.200, 2),
    "stream_dispatch/schedule_host/sched_alloc": (0.040, 2),
    "stream_dispatch/schedule_host/sched_place": (0.300, 2),
    "stream_dispatch/schedule_host/sched_finish": (0.050, 2),
    "stream_dispatch/sched_upload": (0.100, 2),
    "stream_dispatch/launch": (0.030, 6),
    "stream_dispatch_h": (0.500, 2),
    "stream_dispatch_h/schedule_host": (0.440, 2),
    "stream_dispatch_h/schedule_host/sched_fetch": (0.020, 2),
    "stream_dispatch_h/schedule_host/sched_fit": (0.160, 2),
    "stream_dispatch_h/schedule_host/sched_alloc": (0.030, 2),
    "stream_dispatch_h/schedule_host/sched_place": (0.200, 2),
    "stream_dispatch_h/schedule_host/sched_finish": (0.020, 2),
    "stream_dispatch_h/sched_upload": (0.040, 2),
    "stream_dispatch_h/launch": (0.010, 2),
    "stream_collect": (0.400, 8),
    "stream_collect/collect_wait": (0.150, 8),
    "stream_collect/collect_fetch": (0.010, 8),
    "stream_collect/horner": (0.230, 8),
}
BATCHES = [(0.0, 1.0), (1.0, 2.0)]


def _run(spans=SPANS, events=None):
    return Run(SimpleNamespace(), 1.0, BATCHES, spans, {}, events)


@pytest.mark.parametrize("name, want", [
    ("sched_fit_ms", 1e3 * (0.200 + 0.160) / 2),
    ("sched_place_ms", 1e3 * (0.300 + 0.200) / 2),
    ("sched_py_ms", 1e3 * (0.060 + 0.040 + 0.050 + 0.030 + 0.020) / 2),
    ("sched_copy_ms", 1e3 * (0.100 + 0.020 + 0.040) / 2),
    ("collect_host_ms", 1e3 * (0.400 - 0.150) / 2),
])
def test_span_readers(name, want):
    m = registry.metric(name)
    assert m.read(_run()) == pytest.approx(want)
    # the parent's program: stream_dispatch and schedule_host alone
    bare = {k: v for k, v in SPANS.items() if k in (
        "stream_dispatch", "stream_dispatch/schedule_host",
        "stream_dispatch_h", "stream_dispatch_h/schedule_host")}
    assert m.read(_run(bare)) is None


def test_h2d_mb_reads_the_counter(monkeypatch):
    m = registry.metric("h2d_mb")
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"h2d_bytes": 340_000_000})
    assert m.read(_run()) == pytest.approx(170.0)
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert m.read(_run()) is None
    monkeypatch.delattr(profiling, "counters")
    assert m.read(_run()) is None


def _rec(name, start_ns, end_ns):
    return profiling.Record(name, start_ns, end_ns, None, 1, 1)


# the card busy [0, 100) and [400, 450) and [900, 1000) us of the trace:
# two idle gaps, 300 us (middle 250) and 450 us (middle 675)
DEVICE = [("k1", 0.0, 100.0), ("copy", 400.0, 50.0), ("k1", 900.0, 100.0)]
ANCHOR_NS, MARKER_US = 5_000_000_000, 20.0


@pytest.mark.parametrize("recs, want_us", [
    # schedule_host at trace 240-260 us holds the first gap's middle (20
    # us off, on the program's clock unmapped, it would not)
    ([("schedule_host", 240, 260)], 300.0),
    # both gaps, one in a schedule_device record
    ([("schedule_host", 240, 260), ("schedule_device", 600, 700)], 750.0),
    # a record that holds neither middle, and another span's name
    ([("schedule_host", 260, 380), ("sched_upload", 600, 700)], 0.0),
])
def test_sched_idle_ms_on_the_shared_clock(monkeypatch, recs, want_us):
    """Records at trace times (us) given on the program's clock: the
    marker at trace 20 us was read as ANCHOR_NS, so trace t us is
    perf_counter_ns ANCHOR_NS + (t - 20) * 1000."""
    m = registry.metric("sched_idle_ms")
    rs = [_rec(n, ANCHOR_NS + int((s - MARKER_US) * 1e3),
               ANCHOR_NS + int((e - MARKER_US) * 1e3)) for n, s, e in recs]
    monkeypatch.setattr(profiling, "records", lambda: rs)
    monkeypatch.setattr(profiling, "anchor", lambda: ANCHOR_NS)
    ev = {"device": DEVICE,
          "host": [("profiling/anchor", MARKER_US, 1.0),
                   ("bench/batch", 0.0, 1000.0)]}
    want = want_us / 1e3 / len(BATCHES)                  # ms a batch
    assert m.read(_run(events=ev)) == pytest.approx(want)


@pytest.mark.parametrize("missing", ["trace", "device", "marker", "anchor",
                                     "records", "program"])
def test_sched_idle_ms_nothing_to_read(monkeypatch, missing):
    m = registry.metric("sched_idle_ms")
    rs = [_rec("schedule_host", ANCHOR_NS + 100_000, ANCHOR_NS + 300_000)]
    ev = {"device": [] if missing == "device" else DEVICE,
          "host": [] if missing == "marker"
          else [("profiling/anchor", MARKER_US, 1.0)]}
    monkeypatch.setattr(profiling, "records",
                        lambda: [] if missing == "records" else rs)
    monkeypatch.setattr(profiling, "anchor",
                        lambda: None if missing == "anchor" else ANCHOR_NS)
    if missing == "program":              # the parent's: no records at all
        monkeypatch.delattr(profiling, "records")
        monkeypatch.delattr(profiling, "anchor")
    run = _run(events=None if missing == "trace" else ev)
    assert m.read(run) is None
