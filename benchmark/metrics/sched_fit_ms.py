"""sched_fit_ms (ms a batch, program spans): the C++ schedule's sizing
call, span sched_fit (native.msm_schedule with T = 0), whose recode and
bucket counts the placing call (sched_place_ms) repeats; over the traced
window's batches."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(run, ("sched_fit",), scale=1e3)
