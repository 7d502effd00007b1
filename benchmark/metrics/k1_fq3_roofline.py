"""k1_fq3_roofline (%, device trace): K1's Fq3 instance (MNT6-298's G2,
`madd_accumulate_kernel<3>`) against its bound, over the traced window:
the bounds of its launches over its kernels' time in the trace.

The work is counted from the batches' scalars of the queries over Fq3
alone (the help side's b_g2, `gen.work`'s degree 3) at WINDOW_BITS,
never from the program: every nonzero signed digit is one mixed add over
Fp^3 (benchlib/roofline.py).  Nothing without a trace of the card or a
launch of that instance."""

from benchlib import roofline
from benchlib.trace import kernel_s

KERNEL = "madd_accumulate_kernel<3>"     # as the trace names the instance
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
                nz = roofline.msm_work(scal[key], WINDOW_BITS, gen.bits)[0]
                mads += roofline.mixed_add_mads(nz, 3)
    return 100.0 * roofline.bound_s(mads=mads) / t
