"""k4_fq3_roofline (%, device trace): K4's Fq3 instance (MNT6-298's G2,
`bucket_finish_kernel<3>`) against its bound, over the traced window:
the bounds of its launches over its kernels' time in the trace.

The work is counted from the batches' scalars of the queries over Fq3
alone (the help side's b_g2, `gen.work`'s degree 3) at WINDOW_BITS,
never from the program: each window that holds a nonzero signed digit
reduces its 2^(c-1) buckets by running sums, 2 B complete adds over Fp^3
(benchlib/roofline.py).  Nothing without a trace of the card or a launch
of that instance."""

from benchlib import roofline
from benchlib.trace import kernel_s

KERNEL = "bucket_finish_kernel<3>"       # as the trace names the instance
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
        for _, key, d in queries:
            if d == 3:
                wins = roofline.msm_work(scal[key], WINDOW_BITS, gen.bits)[1]
                mads += roofline.complete_add_mads(
                    roofline.bucket_reduction_adds(wins, WINDOW_BITS), 3)
    return 100.0 * roofline.bound_s(mads=mads) / t
