"""schedule_ms (ms a batch, program spans): the stream MSMs' dispatch, the
schedule of z and the launches of its queries (span stream_dispatch) and
h's (span stream_dispatch_h), each second once, over the traced window's
batches."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(run, ("stream_dispatch", "stream_dispatch_h"),
                            scale=1e3)
