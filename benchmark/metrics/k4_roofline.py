"""k4_roofline (%, device trace): K4 (`bucket_finish`, the buckets'
reduction to each window's sum) against its bound, over the traced
window: the bounds of all its launches over its kernels' time.

The work is counted from each batch's scalars at WINDOW_BITS, never from
the program: each window that holds a nonzero signed digit reduces its
2^(c-1) buckets by running sums, 2 B complete adds over the query's
coordinate field Fp^d (benchlib/roofline.py).  Nothing without a trace of
the card."""

from benchlib import roofline
from benchlib.trace import kernel_s

KERNEL = "bucket_finish"
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
        wins = {k: roofline.msm_work(v, WINDOW_BITS, gen.bits)[1]
                for k, v in scal.items()}
        mads += sum(roofline.complete_add_mads(
            roofline.bucket_reduction_adds(wins[key], WINDOW_BITS), d)
            for _, key, d in queries)
    return 100.0 * roofline.bound_s(mads=mads) / t
