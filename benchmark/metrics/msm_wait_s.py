"""msm_wait_s (s a step, program spans): the MSMs' dispatch and collect,
spans groth16/msm and gm17/msm, and the h MSM's dispatch (span
stream_dispatch_h) where those spans do not enclose it (GM17 opens it in
its quotient); each second once, over the traced window's steps."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(run, ("groth16/msm", "gm17/msm",
                                  "stream_dispatch_h"))
