"""The port's EC kernels (pcd_tpu_torch/ops/ec.py) against the JAX
package's EC32 contexts (pcd_tpu/ops/ec32.py) on the CPU: the plain
versions of K1 (madd_accumulate) and K2 (complete add) take the same
u64-limb inputs as EC32Ctx / EC32ExtCtx (their non-Pallas branches) and
must give the same affine points, exactly, for the toy and the real
MNT4/MNT6 fields in G1 and G2 form.  Cases include infinity-flagged table
rows, zero loads, negative digits, P = Q, P = -Q and identities.  Data
crosses between the packages as numpy arrays; the port's limbs are decoded
here into pcd_tpu's host points, so every expected value comes from the
JAX package.  (The CUDA kernels
themselves are held to these plain versions on the card by
test_torch_kernels_cuda.py and chip_smoke.py.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.msm.host import fixed_base_many  # noqa: E402
from pcd_tpu.native import _points_to_arrays  # noqa: E402
from pcd_tpu.ops.ec32 import _ExtOpsT, _rcb_madd_extT  # noqa: E402
from pcd_tpu.ops.msm_stream import StreamMSMCtx  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops.ec import ec_ctx  # noqa: E402

# (cycle, side, group): toy forms (29/31-bit fields) and the real ones
FORMS = [("toy_cycle", "main", "g1"), ("toy_cycle", "main", "g2"),
         ("toy_cycle", "help", "g2"), ("mnt_cycle", "main", "g1"),
         ("mnt_cycle", "main", "g2"), ("mnt_cycle", "help", "g1"),
         ("mnt_cycle", "help", "g2")]
L, T, M = 128, 4, 40
# pcd_tpu's EC32ExtCtx computes off-curve points over the toy MNT6 Fq3
# (its complete add and mixed add alike; its f32 lazy-reduction bounds
# assume 298-bit moduli), which pcd_tpu's own host curve sums witness.
# The toy chains run their G2 MSMs on the host, so pcd_tpu's own tests
# never reach it.  There the port is held to pcd_tpu's host curve alone.
REF_FAULTS = {("toy_cycle", "help", "g2")}


def _curves(form):
    cyc, side, grp = form
    rcfg = getattr(getattr(RM, cyc)(), side)
    tcfg = getattr(getattr(TM, cyc)(), side)
    return (getattr(rcfg, grp), getattr(rcfg, grp + "_gen"),
            getattr(tcfg, grp), rcfg.Fr.BITS)


def _inputs(form, seed):
    """Shared inputs: table points as u64 limbs (two flagged infinite),
    a signed schedule (nwin = 1) and loads with zeros."""
    rcurve, rgen, tcurve, bits = _curves(form)
    rng = np.random.default_rng(seed)
    pts = fixed_base_many(rgen, [int(s) for s in rng.integers(1, 1 << 40, M)],
                          bits)
    pts[3] = pts[7] = rcurve.infinity()
    deg = rcurve.F.extension_degree_over_prime()
    xs, ys, inf = _points_to_arrays(pts, deg)
    idx = rng.integers(0, M, (T, L)).astype(np.uint32)
    idx[0, :8] = 3                                # flagged rows
    idx[1, 8:16] = idx[0, 8:16]                   # same point twice
    sign = rng.integers(0, 2, (T, L)).astype(np.uint32)
    sign[1, 16:24] = 1 - sign[0, 16:24]
    idx[1, 16:24] = idx[0, 16:24]                 # P + (-P)
    loads = rng.integers(0, T + 1, L).astype(np.int32)
    loads[::5] = 0
    loads[8:24] = T
    return pts, xs, ys, inf.astype(bool), idx, sign, loads


def _ref_accumulate(rcurve, bits, xs, ys, inf, idx, sign, loads):
    """pcd_tpu's mixed-add accumulation (the CPU branches of
    madd_accumulate, ec32.py:651-662 and 1236-1259) on the gathered,
    sign-resolved stream its own pipeline builds (msm_stream.py:261-277).
    The rounds run one by one in Python rather than in lax.scan: the same
    computation, without minutes of XLA compile for the Fp3 body."""
    sctx = StreamMSMCtx(rcurve, bits, c=6, lanes=L)
    ec = sctx.ec
    XY, _ = sctx.table_from_limbs(xs, ys, inf)
    XY = np.asarray(XY)
    m2 = XY.shape[0] // 2
    G = XY[(idx + sign * m2).astype(np.int64)]             # (T, L, 2W)
    Gt = jnp.asarray(np.transpose(G, (0, 2, 1)).astype(np.float32))
    fp, kw = ec.fp, ec.kw
    if not hasattr(ec, "d"):
        acc = ec.identity((L,))                            # rows (L, kw)
        for t in range(T):
            act = jnp.asarray((t < loads).astype(np.float32))
            acc = ec.madd(acc, (Gt[t, :kw].T, Gt[t, kw:].T),
                          jnp.zeros((L,), jnp.float32), act)
        return ec, tuple(np.asarray(c).T for c in acc)
    spec, carr = ec._madd_consts()
    carr = dict(carr)
    carr["offX3"] = jnp.asarray(fp.off_mult_p(spec.offX3).reshape(-1, 1))
    carr["offT2n"] = jnp.asarray(fp.off_mult_p(spec.offT2n).reshape(-1, 1))
    ops = _ExtOpsT(fp, ec.d, ec.nr_int, (
        jnp.asarray(fp.N0.T.copy(), dtype=jnp.bfloat16),
        jnp.asarray(fp.P0.T.copy(), dtype=jnp.bfloat16),
        jnp.asarray(fp.off4p().reshape(-1, 1)),
        jnp.asarray(fp.wide_p_offset().reshape(-1, 1))))
    acc = ec.identity_cols(L)
    for t in range(T):
        act = jnp.asarray((t < loads).astype(np.float32)).reshape(1, L)
        R = _rcb_madd_extT(ops, spec, carr,
                           tuple(ec._splitT(c) for c in acc),
                           (ec._splitT(Gt[t, :kw]), ec._splitT(Gt[t, kw:])),
                           act)
        acc = tuple(jnp.concatenate(c, axis=0) for c in R)
    return ec, tuple(np.asarray(c) for c in acc)            # (kw, L) each


def _port_accumulate(tcurve, xs, ys, inf, idx, sign, loads):
    ec = ec_ctx(tcurve)
    table = torch.from_numpy(ec.table_from_u64(xs, ys, inf))
    perm = (idx | (sign << 31)).reshape(1, T, L).view(np.int32)
    acc = ec.madd_accumulate(table, torch.from_numpy(perm.copy()),
                             torch.from_numpy(loads.reshape(1, L)))
    return ec, acc[0]


def _ref_point(rcurve, limbs):
    """The port's (3, d, 10) Montgomery u32 limbs (R = 2^320) -> pcd_tpu
    host point, decoded without the port's code."""
    F = rcurve.F
    d = F.extension_degree_over_prime()
    prime = F.prime_subfield()
    p = prime.MODULUS
    rinv = pow(1 << 320, -1, p)
    raw = np.ascontiguousarray(np.asarray(limbs, dtype=np.int32)).view(
        "<u4").reshape(3, d, 10)

    def coord(k):
        cs = [prime(int.from_bytes(raw[k, i].tobytes(), "little") * rinv % p)
              for i in range(d)]
        return cs[0] if d == 1 else F.from_prime_coeffs(cs)

    x, y, z = (coord(k) for k in range(3))
    if z.is_zero():
        return rcurve.infinity()
    zi = z.inv()
    return rcurve.point(x * zi, y * zi)


def _affine(P):
    """A point as comparable canonical ints (None for infinity)."""
    if P.is_infinity():
        return None

    def ints(e):
        cs = e.to_prime_coeffs() if hasattr(e, "to_prime_coeffs") else [e]
        return tuple(int(c.n) for c in cs)

    return ints(P.x), ints(P.y)


@pytest.mark.parametrize("form", FORMS, ids=["-".join(f) for f in FORMS])
def test_kernels_match_ec32(form):
    """K1 on a schedule with flagged rows, zero loads, doubled points and
    P + (-P); then K2 on its outputs with P = Q, P = -Q, Q = O, P = O and
    generic pairs.  Both against the host curve sums and pcd_tpu's EC32
    contexts (madd rounds, add_cols on column slabs, and for G1 the
    row-layout add)."""
    rcurve, _, tcurve, bits = _curves(form)
    pts, xs, ys, inf, idx, sign, loads = _inputs(form, 11)
    tec, tacc = _port_accumulate(tcurve, xs, ys, inf, idx, sign, loads)
    k1 = [_affine(_ref_point(rcurve, a.numpy())) for a in tacc]
    for lane in range(L):
        exp = rcurve.infinity()
        for t in range(loads[lane]):
            p = pts[idx[t, lane]]
            exp = exp + (-p if sign[t, lane] else p)
        assert k1[lane] == _affine(exp), f"K1 lane {lane}"
    # K2 operands from K1's projective outputs
    perm = np.random.default_rng(5).permutation(L)
    k = 16
    Qt = tacc[torch.from_numpy(perm)].clone()
    Qt[:k] = tacc[:k]                                       # Q = P
    f = tec.f
    Qt[k:2 * k] = tacc[k:2 * k]
    Qt[k:2 * k, 1] = f.from_plain(f.neg(f.to_plain(tacc[k:2 * k, 1])))
    Qt[2 * k:3 * k] = tec.identity((k,), "cpu")             # Q = O
    Pt = tacc.clone()
    Pt[3 * k:4 * k] = tec.identity((k,), "cpu")             # P = O
    k2 = [_affine(_ref_point(rcurve, r.numpy())) for r in tec.add(Pt, Qt)]
    for i in range(L):
        exp = _ref_point(rcurve, Pt[i].numpy()) + _ref_point(
            rcurve, Qt[i].numpy())
        assert k2[i] == _affine(exp), f"K2 pair {i}"
        if k <= i < 2 * k:
            assert k2[i] is None
    if form in REF_FAULTS:
        return
    rec, P = _ref_accumulate(rcurve, bits, xs, ys, inf, idx, sign, loads)
    for lane in range(L):
        want = rec.decode_point(tuple(c[:, lane] for c in P))
        assert k1[lane] == _affine(want), f"K1 lane {lane} vs EC32"
    # the same K2 operands in pcd_tpu's column layout (kw, L)
    Q = [c[:, perm].copy() for c in P]
    for c, src in zip(Q, P):
        c[:, :k] = src[:, :k]
    negP = rec.neg(tuple(jnp.asarray(c[:, k:2 * k].T) for c in P))
    for c, n_ in zip(Q, negP):
        c[:, k:2 * k] = np.asarray(n_).T
    ident = [np.asarray(c) for c in rec.identity_cols(k)]
    for c, i0 in zip(Q, ident):
        c[:, 2 * k:3 * k] = i0
    P2 = [c.copy() for c in P]
    for c, i0 in zip(P2, ident):
        c[:, 3 * k:4 * k] = i0
    r_cols = [np.asarray(c) for c in rec.add_cols(
        tuple(jnp.asarray(c) for c in P2), tuple(jnp.asarray(c) for c in Q))]
    r_rows = None
    if not hasattr(rec, "d"):
        r_rows = [np.asarray(c) for c in rec.add(
            tuple(jnp.asarray(c.T) for c in P2),
            tuple(jnp.asarray(c.T) for c in Q))]
    for i in range(L):
        want = _affine(rec.decode_point(tuple(c[:, i] for c in r_cols)))
        assert k2[i] == want, f"K2 pair {i} vs EC32.add_cols"
        if r_rows is not None:
            assert k2[i] == _affine(rec.decode_point(
                tuple(c[i] for c in r_rows))), f"K2 pair {i} vs EC32.add"
