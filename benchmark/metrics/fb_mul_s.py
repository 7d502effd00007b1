"""fb_mul_s (s, program spans): the set-up's fixed-base products on the
keygen's device tier, span fb_mul_device (msm_dispatch.fb_mul), summed
over the set-up of the traced run.  Nothing when the span is not there."""

from benchlib.trace import span_sum


def read(run):
    return span_sum(run.setup_spans, ("fb_mul_device",)) or None
