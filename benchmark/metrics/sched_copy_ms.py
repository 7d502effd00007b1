"""sched_copy_ms (ms a batch, program spans): the host's time blocked in
the schedule's copies: spans sched_upload (the schedule's arrays, or the
device scheduler's scalars, to the card) and sched_fetch (h's limbs, or
P1's histogram, to the host); over the traced window's batches."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(run, ("sched_upload", "sched_fetch"),
                            scale=1e3)
