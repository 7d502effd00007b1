"""h_poly_s (s a step, program spans): the quotient, spans groth16/h_poly
and gm17/h_poly, less the h MSM's dispatch (span stream_dispatch_h) that
GM17 opens inside its quotient, which msm_wait_s counts; over the traced
window's steps.  Under the device quotient the span times the enqueue
and the replay check's sync, not the card's time; in GM17 it still holds
an unspanned wait for the a/b/c dispatch's host schedule (PERF.md)."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(run, ("groth16/h_poly", "gm17/h_poly"),
                            less=("stream_dispatch_h",))
