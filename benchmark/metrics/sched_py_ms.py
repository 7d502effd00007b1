"""sched_py_ms (ms a batch, program spans): the schedule's host work
around the C++: spans sched_digest (the shared schedule's key, a digest
of z), sched_alloc (the output arrays) and sched_finish
(StreamSchedule's per-window finish tables); over the traced window's
batches."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(
        run, ("sched_digest", "sched_alloc", "sched_finish"), scale=1e3)
