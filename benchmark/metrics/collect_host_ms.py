"""collect_host_ms (ms a batch, program spans): the collects' host work,
spans stream_collect less their collect_wait (the wait for the card):
the window sums' fetch and the Horner tail; over the traced window's
batches."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(run, ("stream_collect",),
                            less=("collect_wait",), scale=1e3)
