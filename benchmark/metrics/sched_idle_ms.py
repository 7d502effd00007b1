"""sched_idle_ms (ms a batch, device trace and program records): the
card's idle time inside the schedule, over the traced window's batches.

The program's own records of spans schedule_host and schedule_device
(`profiling.records()`, perf_counter_ns) go onto the trace's clock
through its anchor: the trace's `profiling/anchor` marker and the
perf_counter_ns the program read inside it (`profiling.anchor()`).  The
harness's annotations are not read.  Each idle gap between the card's
operations counts whole where its middle lies in such a record, as
breakdown.idle_gaps gives a gap to an annotation.  Nothing without a
trace of the card, the marker or the records."""

from benchlib.trace import merged

NAMES = ("schedule_host", "schedule_device")
MARKER = "profiling/anchor"


def mapped(records, anchor_ns: int, marker_us: float, names=NAMES) -> list:
    """[(start, end)] in trace microseconds of the finished records named
    in `names`."""
    return [(marker_us + (r.start_ns - anchor_ns) / 1e3,
             marker_us + (r.end_ns - anchor_ns) / 1e3)
            for r in records if r.name in names and r.end_ns is not None]


def idle_in(events: dict, spans) -> float:
    """Seconds of the card's idle gaps whose middle lies in one of
    `spans` [(start, end)], trace microseconds."""
    busy = merged((t, t + d) for _, t, d in events["device"])
    tot = 0.0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        if any(s <= mid <= e for s, e in spans):
            tot += b - a
    return tot / 1e6


def read(run):
    from pcd_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    anchor = getattr(profiling, "anchor", lambda: None)()
    if records is None or anchor is None or not run.events \
            or not run.events["device"]:
        return None
    marks = [t for n, t, _ in run.events["host"] if n == MARKER]
    spans = mapped(records(), anchor, max(marks)) if marks else []
    if not spans:
        return None
    return 1e3 * idle_in(run.events, spans) / len(run.records)
