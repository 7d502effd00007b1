"""help_prove_s (s a step, program spans): the PCD chain's help prove
(pcd/ec_cycle.py), span pcd/help_prove, over the traced window's steps.
It encloses the help SNARK's own witness, quotient and MSM spans, which
the provers' metrics count again: a layer above them, not a share."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(run, ("pcd/help_prove",))
