"""sched_place_ms (ms a batch, program spans): the schedule's placement,
span sched_place (the C++ placing call, or P2 under the device
scheduler); over the traced window's batches."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(run, ("sched_place",), scale=1e3)
