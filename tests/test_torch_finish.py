"""K4's plain version (ECCtx.bucket_finish_plain, the stream-MSM finish)
against the JAX package, window by window as affine points, on the CPU.

The port's K1 plain version folds the lanes of one C++ schedule (c = 6,
128 lanes) and K4's plain version finishes them; each window sum must be
sum_i d_{w,i} P_i with the signed digits d of pcd_tpu's digits_signed and
the points added on pcd_tpu's host curve (buckets, then a running sum).
pcd_tpu's own device finish, window_sums_async, is the reference of
test_torch_msm_stream.py (toy G1, through the whole port pipeline, which
ends in K4's plain version); on the CPU its JAX compile alone takes about a
minute for toy G1 and minutes for the 298-bit and G2 forms, so this file
holds every form to pcd_tpu's digits and host curve instead.  Forms: toy
G1, toy MNT4 Fq2 and MNT6 Fq3 G2, MNT4-298 and MNT6-298 G1 and G2; edge
cases on toy G1: all-zero scalars, every digit in one bucket, only the
top bucket, P and -P in one bucket, more points than lanes, flagged
infinity rows, and c = 9, 10, where a window's buckets span several of
K4's blocks.  K4's plain version must also agree with the K2-step
finish it replaced (StreamMSMCtx.finish_steps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_support import (reference_native_loaded,  # noqa: E402,F401
                            two_torch_threads)
from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.msm.host import fixed_base_many  # noqa: E402
from pcd_tpu.native import _points_to_arrays  # noqa: E402
from pcd_tpu.ops.msm_stream import StreamMSMCtx as RefCtx  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops.ec import plain_counts, reset_launch_counts  # noqa
from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx  # noqa: E402

CPU = torch.device("cpu")
C, LANES = 6, 128
FORMS = [("toy_cycle", "main", "g1"), ("toy_cycle", "main", "g2"),
         ("toy_cycle", "help", "g2"), ("mnt_cycle", "main", "g1"),
         ("mnt_cycle", "main", "g2"), ("mnt_cycle", "help", "g1"),
         ("mnt_cycle", "help", "g2")]
IDS = ["-".join(f) for f in FORMS]


def _affine(P):
    if P.is_infinity():
        return None

    def ints(e):
        cs = e.to_prime_coeffs() if hasattr(e, "to_prime_coeffs") else [e]
        return tuple(int(c.n) for c in cs)

    return ints(P.x), ints(P.y)


def _curves(form):
    cyc, side, grp = form
    rcfg = getattr(getattr(RM, cyc)(), side)
    tcfg = getattr(getattr(TM, cyc)(), side)
    return (getattr(rcfg, grp), getattr(rcfg, grp + "_gen"),
            getattr(tcfg, grp), rcfg.Fr.BITS)


def _points(gen, bits, n, seed):
    rng = np.random.default_rng(seed)
    return fixed_base_many(gen, [int(s) for s in rng.integers(1, 1 << 40, n)],
                           bits)


def _ref_windows(rcurve, bits, pts, limbs, c=C, lanes=LANES):
    """pcd_tpu's window sums: its signed digits, each window's buckets
    summed on its host curve, then sum_b b S_b by a running sum."""
    rc = RefCtx(rcurve, bits, c=c, lanes=lanes)
    mags, signs = rc.digits_signed(limbs)
    out = []
    for w in range(rc.nwin):
        S = [rcurve.infinity()] * (rc.B + 1)
        for i, P in enumerate(pts):
            m = int(mags[w, i])
            if m:
                S[m] = S[m] + (-P if signs[w, i] else P)
        run = tot = rcurve.infinity()
        for b in range(rc.B, 0, -1):
            run = run + S[b]
            tot = tot + run
        out.append(_affine(tot))
    return out


def _port_finish(tcurve, bits, pts, limbs, steps=False, c=C, lanes=LANES):
    """The port's K1 and K4 plain versions on its C++ schedule: affine
    window sums (and finish_steps' too, when asked)."""
    pc = StreamMSMCtx(tcurve, bits, c=c, lanes=lanes)
    xs, ys, inf = _points_to_arrays(pts, pc.ec.d)
    table = pc.table_from_limbs(xs, ys, inf.astype(bool), CPU)
    sched = pc.schedule_native(limbs)
    perm, loads, bidx, runrem = sched.on(CPU)
    accs = pc.ec.madd_accumulate(table, perm, loads)
    reset_launch_counts()
    ws = pc.ec.bucket_finish(accs, bidx, runrem).numpy()
    assert plain_counts() == {("bucket_finish", tcurve.name): 1}
    got = [_affine(pc.ec.decode_point(ws[w])) for w in range(pc.nwin)]
    if not steps:
        return got, sched
    old = pc.finish_steps(accs, bidx, runrem, sched.maxrun).numpy()
    return got, [_affine(pc.ec.decode_point(old[w]))
                 for w in range(pc.nwin)]


def _limbs(scalars, bits):
    nb = (bits + 63) // 64 * 8
    return StreamMSMCtx.limb_rows(scalars, nb)


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_finish_matches_reference(form):
    """Random 62-bit scalars (declared as 64-bit: 11 windows, where the
    298-bit scalar field's 50 would only add windows of the same kind)
    with an infinity row and a repeated point."""
    rcurve, rgen, tcurve, bits = _curves(form)
    n = 40
    pts = _points(rgen, bits, n, 1)
    pts[5] = rcurve.infinity()
    pts[9] = pts[3]
    bits = min(bits, 64)
    rng = np.random.default_rng(2)
    scalars = [int(x) % rcurve.order for x in rng.integers(0, 1 << 62, n)]
    limbs = _limbs(scalars, bits)
    got, _ = _port_finish(tcurve, bits, pts, limbs)
    assert got == _ref_windows(rcurve, bits, pts, limbs)


def _toy_case(scalars, pts=None, n=None, steps=False, c=C, lanes=LANES):
    rcurve, rgen, tcurve, bits = _curves(FORMS[0])
    if pts is None:
        pts = _points(rgen, bits, n or len(scalars), 3)
    limbs = _limbs(scalars, bits)
    got, extra = _port_finish(tcurve, bits, pts, limbs, steps, c, lanes)
    assert got == _ref_windows(rcurve, bits, pts, limbs, c, lanes)
    return got, extra, rcurve, pts


def test_finish_all_zero_scalars():
    got, sched, _, _ = _toy_case([0] * 20)
    assert got == [None] * len(got)
    assert int(sched.loads.sum()) == 0


def test_finish_one_bucket():
    """Every nonzero digit in bucket 5 of window 0: one run of lanes over
    the whole window (more points than lanes, so each lane folds several
    points)."""
    got, sched, _, _ = _toy_case([5] * 400)
    assert sched.T > 1 and int(sched.runrem[0].max()) > 1
    assert got[1:] == [None] * (len(got) - 1)


def test_finish_top_bucket_only():
    """Digit B = 2^(c-1) (signed: -B plus a carry): window 0 uses only the
    top bucket, window 1 only bucket 1."""
    B = 1 << (C - 1)
    got, sched, _, _ = _toy_case([B] * 30)
    nwin, L = sched.loads.shape
    assert list(np.flatnonzero(sched.bidx[0] != nwin * L)) == [B - 1]


def test_finish_p_and_minus_p():
    """P and -P with the same scalars share every bucket: their sums
    cancel, and a window of only those two is the identity."""
    rcurve, rgen, _, bits = _curves(FORMS[0])
    P = _points(rgen, bits, 1, 4)[0]
    pts = [P, -P, P * 3]
    rng = np.random.default_rng(5)
    s = [int(x) % rcurve.order for x in rng.integers(1, 1 << 62, 2)]
    got, _, _, _ = _toy_case([s[0], s[0], s[1]], pts=pts)
    got2, _, _, _ = _toy_case([s[0], s[0]], pts=pts[:2])
    assert got2 == [None] * len(got2)
    assert any(g is not None for g in got)


def test_finish_more_points_than_lanes():
    rng = np.random.default_rng(6)
    order = _curves(FORMS[0])[0].order
    _, sched, _, _ = _toy_case([int(x) % order for x in rng.integers(
        0, 1 << 62, 300)])
    assert sched.T > 1


def test_finish_flagged_infinity_rows():
    rcurve, rgen, _, bits = _curves(FORMS[0])
    pts = _points(rgen, bits, 30, 7)
    for i in (0, 4, 17):
        pts[i] = rcurve.infinity()
    rng = np.random.default_rng(8)
    _toy_case([int(x) % rcurve.order for x in rng.integers(0, 1 << 62, 30)],
              pts=pts)


@pytest.mark.parametrize("c", [9, 10])
def test_finish_multi_block(c):
    """c = 9, 10: 256 and 512 buckets a window, so K4's blocks of
    FINISH_BLOCK = 128 buckets are 2 and 4 a window and the window combine
    runs (the blocks' suffix scan and trees, log2(128) doublings), as at
    the chains' c = 12 with 16.  Forty points each on the buckets either
    side of every block edge give runs of several lanes there."""
    rcurve, _, _, _ = _curves(FORMS[0])
    B = 1 << (c - 1)
    rng = np.random.default_rng(12)
    hi = [int(x) << c for x in rng.integers(0, 1 << 20, 400)]
    scalars = [int(x) % rcurve.order for x in rng.integers(0, 1 << 31, 120)]
    edges = [b for k in range(1, B // 128) for b in (128 * k, 128 * k + 1)]
    scalars += [(e + hi[i]) % rcurve.order
                for i, e in enumerate(e for e in edges for _ in range(40))]
    _, sched, _, _ = _toy_case(scalars, c=c, lanes=512)
    assert sched.bidx.shape[1] == B and B // 128 > 1
    lanes_at = [int(sched.runrem[0, sched.bidx[0, e - 1]]) for e in edges]
    assert min(lanes_at) > 1


@pytest.mark.parametrize("form", FORMS[:2], ids=IDS[:2])
def test_finish_steps_agrees(form):
    """K4's plain version and the K2-step finish give the same affine
    window sums (runs of several lanes, empty buckets, an infinity row)."""
    rcurve, rgen, tcurve, bits = _curves(form)
    pts = _points(rgen, bits, 200, 9)
    pts[2] = rcurve.infinity()
    rng = np.random.default_rng(10)
    scalars = [int(x) % rcurve.order for x in rng.integers(0, 1 << 62, 200)]
    scalars[:60] = [7] * 60
    got, old = _port_finish(tcurve, bits, pts, _limbs(scalars, bits), True)
    assert got == old
