"""The port's mixed-radix NTT and device quotient (pcd_tpu_torch/ops/
fft_tensor.py) on the CPU, where every level of K5 and every K7 step runs
its plain version: the transforms against pcd_tpu's FFTTensorCtx on
JAX-CPU at the reference test's sizes (tests/test_ops_device.py:144) and
against the port's host EvaluationDomain on domains with the factors 3, 5
and 7; K5's plan, digit reversal, passes and twiddle indices at the real
domains' sizes without running a transform; a tiled emulation of K5's
passes (each block's tile gathered and scattered by the kernel's index
formulas, its levels run as the kernel runs them) against the untiled
plain transform and pcd_tpu's; `hpoly` against the C++ tier's
`native.hpoly` over the 298-bit fields.  Values are compared as canonical
field elements; the tolerance is exact equality.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.ops.fft_tensor import fft_ctx as ref_fft_ctx  # noqa: E402
from pcd_tpu_torch import native  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops import ec as tec  # noqa: E402
from pcd_tpu_torch.ops.fft_tensor import (NTT_SMALL_N, NTT_TILE,  # noqa: E402
                                          NTT_TILE_SMALL, fft_ctx,
                                          hpoly, input_permutation,
                                          level_twiddles, passes, plan)
from pcd_tpu_torch.ops.field import limbs_host, upload_limbs  # noqa: E402
from pcd_tpu_torch.poly.domain import EvaluationDomain  # noqa: E402

from _torch_support import two_torch_threads  # noqa: E402,F401

CPU = torch.device("cpu")
FIELDS = {"toy_r": (RM.toy_mnt4, TM.toy_mnt4),
          "mnt4_r": (RM.mnt4_298, lambda: TM.mnt_cycle().main),
          "mnt6_r": (RM.mnt6_298, lambda: TM.mnt_cycle().help)}
DIRECTIONS = ("fft", "ifft", "coset_fft", "coset_ifft")
# the real domains: Groth16 main and help, GM17 main and help, with the
# provers' transform batch
REAL = {225_792: ("mnt4_r", (2,) * 9 + (3, 3, 7, 7), 3),
        31_360: ("mnt6_r", (2,) * 7 + (5, 7, 7), 3),
        688_128: ("mnt4_r", (2,) * 15 + (3, 7), 2),
        107_520: ("mnt6_r", (2,) * 10 + (3, 5, 7), 2)}
# K5's tile (fft_tensor.ntt_tile) and passes a transform at those domains
REAL_PASSES = {225_792: (512, 2), 31_360: (256, 2), 688_128: (512, 3),
               107_520: (256, 3)}
# small domains with each real domain's radix mix, and a K5 tile small
# enough for two passes or more and two blocks a pass or more
SMALL = [("mnt4_r", 2 ** 3 * 3 * 7 * 7, 64),
         ("mnt6_r", 2 ** 2 * 5 * 7 * 7, 128),
         ("mnt4_r", 2 ** 4 * 3 * 7, 32), ("mnt6_r", 2 ** 3 * 3 * 5 * 7, 64)]


@pytest.mark.parametrize("field_name,size_hint",
                         [("toy_r", 24), ("mnt4_r", 32), ("mnt6_r", 70)])
def test_fft_matches_reference(field_name, size_hint):
    """All four directions, as values, against pcd_tpu's FFTTensorCtx."""
    RF, TF = (f().Fr for f in FIELDS[field_name])
    dom = EvaluationDomain.new(TF, size_hint)
    rng = random.Random(size_hint)
    coeffs = [rng.randrange(TF.MODULUS) for _ in range(dom.n)]
    ref = ref_fft_ctx(RF, dom.n)
    a_ref = jnp.asarray(ref.encode(coeffs))[None]
    ctx = fft_ctx(TF, dom.n, CPU)
    a = ctx.encode(coeffs)[None]
    for fn in DIRECTIONS:
        want = ref.decode(jax.jit(getattr(ref, fn))(a_ref))
        assert ctx.decode(getattr(ctx, fn)(a)) == want, fn


@pytest.mark.parametrize("field_name,n", [("mnt6_r", 210), ("mnt4_r", 252),
                                          ("mnt6_r", 3 * 5 * 7 * 4)])
def test_fft_matches_host_domain(field_name, n):
    """Domains whose factors include 3, 5 and 7, a batch of two, against
    the port's host EvaluationDomain; K5's plain version once per level
    and transform."""
    F = FIELDS[field_name][1]().Fr
    dom = EvaluationDomain(F, n)
    rng = random.Random(n)
    rows = [[rng.randrange(F.MODULUS) for _ in range(n)] for _ in range(2)]
    ctx = fft_ctx(F, n, CPU)
    a = torch.stack([ctx.encode(r) for r in rows])
    tec.reset_launch_counts()
    for fn in DIRECTIONS:
        got = getattr(ctx, fn)(a)
        for i, r in enumerate(rows):
            assert ctx.decode(got[i]) == getattr(dom, fn)(r), (fn, i)
    assert tec.plain_counts()[("ntt_pass", F.NAME)] == 4 * len(ctx.passes)
    assert tec.launch_counts() == {}


@pytest.mark.parametrize("n", sorted(REAL))
def test_plan_and_twiddle_indices_at_real_sizes(n):
    """K5's integer arithmetic at the real domains, without a transform:
    the plan's radixes, the digit reversal (mixed radix, not a bit
    reversal), and every level's stepped twiddle index (level_twiddles,
    the plain version's) against (stride j k) mod n in Python ints; every
    index stays below n and every step below 2^31."""
    field_name, want, _ = REAL[n]
    factors = EvaluationDomain(FIELDS[field_name][1]().Fr, n).factors
    assert tuple(factors) == want
    levels = plan(factors)
    assert [r for r, _ in levels] == factors[::-1]
    assert np.prod([r for r, _ in levels]) == n
    perm = input_permutation(n, factors)
    assert np.array_equal(np.sort(perm), np.arange(n))
    rng = random.Random(n)
    for i in rng.sample(range(n), 200):
        # digit reversal: i's mixed-radix digits, least significant first
        # over the factors, read back most significant first
        x, v = i, 0
        for r in factors:
            x, d = divmod(x, r)
            v = v * r + d
        assert perm[v] == i
    for r, m in levels:
        nl, stride = r * m, n // (r * m)
        got = level_twiddles(n, r, m)
        j = np.arange(r, dtype=np.int64)[:, None]
        k = np.arange(nl, dtype=np.int64)[None, :]
        assert np.array_equal(got, (stride * j * k) % n)
        assert got.max() < n and 2 * nl < 2 ** 31
        for jj, kk in zip(rng.choices(range(r), k=50),
                          rng.choices(range(nl), k=50)):
            assert int(got[jj, kk]) == stride * jj * kk % n


def _lines(ps, n, batch, block):
    """K5's index formulas (csrc/ntt.cu): the points of a block's tile,
    p = u C + c for point u of line c, as (batch row, point) pairs, -1
    past the last line; the lines' columns k'."""
    lpr, lines = n // ps.Q, n // ps.Q * batch
    Lg = block * ps.C + np.arange(ps.C)
    row, L = Lg // lpr, Lg % lpr
    kc = L % ps.M
    off = np.where(Lg < lines, (L - kc) * ps.Q + kc, -1)
    u, c = np.divmod(np.arange(ps.points), ps.C)
    a = np.where(off[c] < 0, -1, off[c] + u * ps.M)
    return row[c], a, kc


def _kernel_twiddle(ps, lv, kc, u, j):
    """The table index K5 uses for input j of the output at point u of a
    line of column kc at level lv of pass ps (j = 1 of the first output
    of a pair at radix 2; the second output takes its negation)."""
    r, ml, nl, stride = ps.levels[lv]
    kk = u % (r * ml) % ml
    if r == 2:
        return (kk * ps.M + kc) * stride
    kf = (u % (r * ml)) * ps.M + kc        # (kk + jo m') M + k'
    e = 0
    for _ in range(j):
        e += kf
        if e >= nl:
            e -= nl
    return e * stride


@pytest.mark.parametrize("n", sorted(REAL))
def test_pass_geometry_at_real_sizes(n):
    """K5's passes at the real domains and the provers' batch, integer
    arithmetic only: two or three passes at the domain's tile (256
    points up to 2^17, else 512), the radixes of a pass
    multiplying to its Q and those of all passes to n, every point loaded
    exactly once per pass by the kernel's index formula, and the kernel's
    twiddle index of sampled outputs equal to (stride j k) mod n in Python
    ints, k the output's place in its group of n_l by its address."""
    field_name, _, batch = REAL[n]
    factors = EvaluationDomain(FIELDS[field_name][1]().Fr, n).factors
    ps_all = passes(n, plan(factors))
    tile, npass = REAL_PASSES[n]
    assert len(ps_all) == npass
    assert np.prod([r for ps in ps_all for r, *_ in ps.levels]) == n
    rng = random.Random(n)
    M = 1
    for ps in ps_all:
        assert ps.M == M and np.prod([r for r, *_ in ps.levels]) == ps.Q
        assert ps.points <= tile and ps.C == tile // ps.Q
        M *= ps.Q
        blocks = -(-(n // ps.Q * batch) // ps.C)
        seen = np.zeros(batch * n, dtype=np.int64)
        for b in range(blocks):
            row, a, _ = _lines(ps, n, batch, b)
            ok = a >= 0
            np.add.at(seen, row[ok] * n + a[ok], 1)
        assert (seen == 1).all()
        for b in rng.sample(range(blocks), 20):
            row, a, kc = _lines(ps, n, batch, b)
            for p in rng.sample(range(ps.points), 10):
                if a[p] < 0:
                    continue
                u, c = divmod(p, ps.C)
                for lv, (r, ml, nl, stride) in enumerate(ps.levels):
                    assert stride * nl == n and nl == r * ml * ps.M
                    k = int(a[p]) % nl
                    if r == 2:
                        idx = _kernel_twiddle(ps, lv, int(kc[c]), u, 1)
                        half = k >= nl // 2
                        assert idx + half * n // 2 == stride * k % n
                        continue
                    for j in range(1, r):
                        idx = _kernel_twiddle(ps, lv, int(kc[c]), u, j)
                        assert idx == stride * j * k % n < n


@pytest.mark.parametrize("field_name", ["mnt4_r", "mnt6_r"])
def test_ntt_tile_by_domain_size(field_name):
    """K5's tile on each side of NTT_SMALL_N: the smallest domain of the
    field at or above 2^17 points and the largest below it; each pass's
    lines fit the tile and the passes cover the domain."""
    F = FIELDS[field_name][1]().Fr
    above = EvaluationDomain.new(F, NTT_SMALL_N + 1).n
    below = max(d for d in (EvaluationDomain.new(F, k).n
                            for k in range(NTT_SMALL_N // 2, NTT_SMALL_N,
                                           NTT_SMALL_N // 64))
                if d <= NTT_SMALL_N)
    for n, tile in ((below, NTT_TILE_SMALL), (above, NTT_TILE)):
        ps_all = passes(n, plan(EvaluationDomain(F, n).factors))
        assert all(ps.points <= tile and ps.C == tile // ps.Q
                   for ps in ps_all), n
        assert np.prod([ps.Q for ps in ps_all]) == n


def _emulate_pass(f, x, tbl, perm, ps, n):
    """One K5 pass on x (batch, n) canonical ints, block by block: the
    tile gathered by the kernel's index formulas (through perm in the
    first pass), each level run on it as the kernel runs it (a radix-2
    pair x0 +- T x1, r > 2 the r-point sum of a set written back in
    place) with the plain products, the tile scattered back."""
    p = f.p
    batch = len(x)
    out = [[None] * n for _ in range(batch)]
    for b in range(-(-(n // ps.Q * batch) // ps.C)):
        row, a, kc = _lines(ps, n, batch, b)
        tile = [x[row[q]][int(perm[a[q]]) if perm is not None else a[q]]
                if a[q] >= 0 else 0 for q in range(ps.points)]
        for lv, (r, ml, nl, stride) in enumerate(ps.levels):
            for c in range(ps.C):
                for g in range(ps.Q // (r * ml)):
                    for kk in range(ml):
                        u = [g * r * ml + kk + j * ml for j in range(r)]
                        v = [tile[q * ps.C + c] for q in u]
                        if r == 2:
                            t = v[1] * tbl[_kernel_twiddle(
                                ps, lv, int(kc[c]), u[0], 1)] % p
                            res = [(v[0] + t) % p, (v[0] - t) % p]
                        else:
                            res = [(v[0] + sum(
                                v[j] * tbl[_kernel_twiddle(
                                    ps, lv, int(kc[c]), u[jo], j)]
                                for j in range(1, r))) % p
                                for jo in range(r)]
                        for q, w in zip(u, res):
                            tile[q * ps.C + c] = w
        for q in range(ps.points):
            if a[q] >= 0:
                out[row[q]][a[q]] = tile[q]
    return out


@pytest.mark.parametrize("field_name,n,tile", SMALL)
def test_tiled_emulation_matches_plain(field_name, n, tile):
    """A tiled emulation of K5 (_emulate_pass) with a tile forced small,
    two passes or more and two blocks a pass or more, on a batch of two:
    equal to the untiled plain transform and to pcd_tpu's FFTTensorCtx
    on JAX-CPU, forward and inverse table."""
    RF, TF = (fl().Fr for fl in FIELDS[field_name])
    ctx = fft_ctx(TF, n, CPU)
    ps_all = passes(n, ctx.levels, tile)
    assert len(ps_all) >= 2
    assert all(-(-(n // ps.Q * 2) // ps.C) >= 2 for ps in ps_all)
    rng = random.Random(n)
    rows = [[rng.randrange(TF.MODULUS) for _ in range(n)] for _ in range(2)]
    a = torch.stack([ctx.encode(r) for r in rows])
    ref = ref_fft_ctx(RF, n)
    perm = ctx.perm.numpy()
    for tname, fn in (("tbl_fwd", "fft"), ("tbl_inv", None)):
        tbl = ctx.decode(getattr(ctx, tname))
        x = rows
        for i, ps in enumerate(ps_all):
            x = _emulate_pass(ctx.f, x, tbl, perm if i == 0 else None, ps, n)
        plain = ctx._transform(a, getattr(ctx, tname))
        assert [ctx.decode(plain[i]) for i in range(2)] == x, tname
        if fn:
            want = ref.decode(jax.jit(ref.fft)(jnp.asarray(
                np.stack([ref.encode(r) for r in rows]))))
            assert [v for r in x for v in r] == want


def _evals(F, n, seed, sat_rows):
    rng = random.Random(seed)
    p = F.MODULUS
    a = [rng.randrange(p) for _ in range(n)]
    b = [rng.randrange(p) for _ in range(n)]
    c = [x * y % p if i < sat_rows else rng.randrange(p)
         for i, (x, y) in enumerate(zip(a, b))]
    return a, b, c


@pytest.mark.parametrize("field_name,n", [("mnt4_r", 252), ("mnt6_r", 210)])
def test_hpoly_matches_native(field_name, n):
    """hpoly against the C++ native.hpoly on random evaluations over a
    real 298-bit field: the Groth16 form, the squaring form (b is a), and
    check_rows: satisfied rows pass, one row further raises."""
    F = FIELDS[field_name][1]().Fr
    p = F.MODULUS
    dom = EvaluationDomain(F, n)
    zh_inv = pow(dom.vanishing_poly_at(dom.coset_shift), -1, p)
    a, b, c = _evals(F, n, n, sat_rows=n // 3)
    ctx = fft_ctx(F, n, CPU)
    A, B, C = (ctx.f.to_mont(upload_limbs(native.ints_to_limbs(v), CPU))
               for v in (a, b, c))
    want = native.hpoly(p, dom.omega, dom.coset_shift, zh_inv, a, b, c,
                        check_rows=n // 3)
    got = hpoly(ctx, A, B, C, zh_inv, check_rows=n // 3)
    assert np.array_equal(limbs_host(got), want)
    al = native.ints_to_limbs(a)
    want_sq = native.hpoly(p, dom.omega, dom.coset_shift, zh_inv, al, al,
                           c)
    assert np.array_equal(limbs_host(hpoly(ctx, A, A, C, zh_inv)), want_sq)
    with pytest.raises(ValueError, match="unsatisfied"):
        native.hpoly(p, dom.omega, dom.coset_shift, zh_inv, a, b, c,
                     check_rows=n // 3 + 1)
    with pytest.raises(ValueError, match="unsatisfied"):
        hpoly(ctx, A, B, C, zh_inv, check_rows=n // 3 + 1)
