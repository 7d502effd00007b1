"""k1_roofline (%, device trace): K1 (`madd_accumulate`, the bucket
accumulation) against its bound, over the traced window: the bounds of
all its launches over its kernels' time in the trace.

The work is counted from each batch's scalars at WINDOW_BITS, never from
the program: every nonzero signed digit is one mixed add over the query's
coordinate field Fp^d (benchlib/roofline.py), for each query the scalars
drive.  Nothing without a trace of the card."""

from benchlib import roofline
from benchlib.trace import kernel_s

KERNEL = "madd_accumulate"
WINDOW_BITS = 12


def read(run):
    if not run.events:
        return None
    t = kernel_s(run.events, KERNEL)
    if t <= 0:
        return None
    gen = run.gen
    mads = 0
    for i in range(1, len(run.records) + 1):
        scal, queries = gen.work(i)
        nz = {k: roofline.msm_work(v, WINDOW_BITS, gen.bits)[0]
              for k, v in scal.items()}
        mads += sum(roofline.mixed_add_mads(nz[key], d)
                    for _, key, d in queries)
    return 100.0 * roofline.bound_s(mads=mads) / t
