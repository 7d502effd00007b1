"""The port's mixed-radix NTT and device quotient (pcd_tpu_torch/ops/
fft_tensor.py) on the CPU, where every level of K5 and every K7 step runs
its plain version: the transforms against pcd_tpu's FFTTensorCtx on
JAX-CPU at the reference test's sizes (tests/test_ops_device.py:144) and
against the port's host EvaluationDomain on domains with the factors 3, 5
and 7; K5's plan, digit reversal, passes and twiddle indices at the real
domains' sizes without running a transform; a tiled emulation of K5's
passes (each block's tile gathered and scattered by the kernel's index
formulas, its levels run as the kernel runs them, with each prologue and
epilogue of K5) against the untiled plain transform and pcd_tpu's; the
operands K5 refuses; `hpoly` (three transforms, its pointwise steps in
K5's prologue and epilogue) against the C++ tier's `native.hpoly`, the
unfused composition on the plain ops and pcd_tpu's composition on
JAX-CPU over the 298-bit fields.  Values are compared as canonical field
elements; the tolerance is exact equality.
"""

import random
from functools import lru_cache

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
                                          NTT_TILE_SMALL, FFTTensorCtx,
                                          fft_ctx, hpoly, input_permutation,
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


def _ctx_at_tile(TF, n, tile):
    """A context of its own whose transforms run K5's passes at `tile`
    points (two passes or more), so a prologue and an epilogue fall on
    different passes."""
    ctx = FFTTensorCtx(TF, n, CPU)
    ctx.passes = passes(n, ctx.levels, tile)
    assert len(ctx.passes) >= 2
    return ctx


@pytest.mark.parametrize("field_name,size_hint",
                         [("toy_r", 24), ("mnt4_r", 32), ("mnt6_r", 70)])
def test_fft_matches_reference(field_name, size_hint):
    """All four directions, as values, against pcd_tpu's FFTTensorCtx; each
    one K5 pass, with coset_fft's table as its prologue and ifft's and
    coset_ifft's scalings as its epilogue."""
    RF, TF = (f().Fr for f in FIELDS[field_name])
    dom = EvaluationDomain.new(TF, size_hint)
    rng = random.Random(size_hint)
    coeffs = [rng.randrange(TF.MODULUS) for _ in range(dom.n)]
    ref = ref_fft_ctx(RF, dom.n)
    a_ref = jnp.asarray(ref.encode(coeffs))[None]
    ctx = fft_ctx(TF, dom.n, CPU)
    assert len(ctx.passes) == 1
    a = ctx.encode(coeffs)[None]
    for fn in DIRECTIONS:
        want = ref.decode(jax.jit(getattr(ref, fn))(a_ref))
        assert ctx.decode(getattr(ctx, fn)(a)) == want, fn


HOST_DOMAINS = [("mnt6_r", 210, None), ("mnt4_r", 252, None),
                ("mnt6_r", 3 * 5 * 7 * 4, None), ("mnt6_r", 210, 32),
                ("mnt4_r", 252, 32)]


@pytest.mark.parametrize("field_name,n,tile", HOST_DOMAINS, ids=[
    f"{f}-{n}" + (f"-tile{t}" if t else "") for f, n, t in HOST_DOMAINS])
def test_fft_matches_host_domain(field_name, n, tile):
    """Domains whose factors include 3, 5 and 7, a batch of two, against
    the port's host EvaluationDomain; K5's plain version once per pass
    and transform, in one pass at the domain's tile and in two at a
    forced small one (coset_fft's table in the first pass's loads,
    ifft's and coset_ifft's scalings in the last pass's stores)."""
    F = FIELDS[field_name][1]().Fr
    dom = EvaluationDomain(F, n)
    rng = random.Random(n)
    rows = [[rng.randrange(F.MODULUS) for _ in range(n)] for _ in range(2)]
    ctx = fft_ctx(F, n, CPU) if tile is None else _ctx_at_tile(F, n, tile)
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


def _emulate_pass(f, x, tbl, perm, ps, n, pre=None, abc=None, post=None):
    """One K5 pass on x (rows, n) canonical ints, block by block: the
    tile gathered by the kernel's index formulas (through perm in the
    first pass; a prologue on the loaded point, `pre` a list of 1 or n
    values, `abc` the element s on rows A, B, C or A, C), each level run
    on it as the kernel runs it (a radix-2 pair x0 +- T x1, r > 2 the
    r-point sum of a set written back in place) with the plain products,
    the tile scattered back (`post` a list of 1 or n values on the stored
    point)."""
    p = f.p
    batch = 1 if abc is not None else len(x)

    def load(row, a):
        a = int(perm[a]) if perm is not None else int(a)
        if abc is not None:
            A, C = x[0][a], x[-1][a]
            return (A * (x[1][a] if len(x) == 3 else A) - C) * abc % p
        return x[row][a] if pre is None else x[row][a] * pre[a % len(pre)] % p

    out = [[None] * n for _ in range(batch)]
    for b in range(-(-(n // ps.Q * batch) // ps.C)):
        row, a, kc = _lines(ps, n, batch, b)
        tile = [load(row[q], a[q]) if a[q] >= 0 else 0
                for q in range(ps.points)]
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
                i = int(a[q])
                out[row[q]][i] = (tile[q] if post is None
                                  else tile[q] * post[i % len(post)] % p)
    return out


# K5's prologue and epilogue in the tiled emulation: mode -> (root table,
# pre, abc rows, post) with the tables by FFTTensorCtx attribute; "none"
# runs both root tables, the rest the one their transform runs on
EMU_MODES = {"none": (None, None, None, None),
             "pre-table": ("tbl_fwd", "coset_tbl", None, None),
             "pre-scalar": ("tbl_fwd", "n_inv", None, None),
             "abc3": ("tbl_inv", None, 3, None),
             "abc2": ("tbl_inv", None, 2, None),
             "post-table": ("tbl_inv", None, None, "ninv_coset_inv_tbl"),
             "post-scalar": ("tbl_inv", None, None, "n_inv"),
             "abc3-post-plain": ("tbl_inv", None, 3, "ninv_coset_inv_plain")}
EMU_CASES = [d + ("none",) for d in SMALL] + [
    SMALL[2 + i % 2] + (m,) for i, m in enumerate(list(EMU_MODES)[1:])]


@pytest.mark.parametrize("field_name,n,tile,mode", EMU_CASES, ids=[
    f"{f}-{n}-{t}" + ("" if m == "none" else f"-{m}")
    for f, n, t, m in EMU_CASES])
def test_tiled_emulation_matches_plain(field_name, n, tile, mode):
    """A tiled emulation of K5 (_emulate_pass) with a tile forced small,
    two passes or more and two blocks a pass or more, on a batch of two
    (three or two rows into one with the ABC prologue): equal to the
    untiled plain transform and, without a prologue or an epilogue, to
    pcd_tpu's FFTTensorCtx on JAX-CPU, forward and inverse table.  The
    prologue rides on the first pass, the epilogue on the last; a table
    of plain residues (not times R) is decoded as the kernel multiplies
    it, so its product leaves the output canonical."""
    RF, TF = (fl().Fr for fl in FIELDS[field_name])
    ctx = fft_ctx(TF, n, CPU)
    ps_all = passes(n, ctx.levels, tile)
    assert len(ps_all) >= 2
    tname, pre, rows_abc, post = EMU_MODES[mode]
    rows_in, rows_out = (rows_abc, 1) if rows_abc else (2, 2)
    assert all(-(-(n // ps.Q * rows_out) // ps.C) >= 2 for ps in ps_all)
    rng = random.Random(n)
    rows = [[rng.randrange(TF.MODULUS) for _ in range(n)]
            for _ in range(rows_in)]
    a = torch.stack([ctx.encode(r) for r in rows])
    ref = ref_fft_ctx(RF, n)
    perm = ctx.perm.numpy()
    s = 7 * n + 1
    ends = {"pre": pre and getattr(ctx, pre),
            "abc": ctx.f.mont(s, CPU) if rows_abc else None,
            "post": post and getattr(ctx, post)}
    vals = {k: ctx.decode(v) if k != "abc" else s
            for k, v in ends.items() if v is not None}
    todo = (("tbl_fwd", "fft"), ("tbl_inv", None)) if tname is None else (
        (tname, None),)
    for tn, fn in todo:
        tbl = ctx.decode(getattr(ctx, tn))
        x = rows
        for i, ps in enumerate(ps_all):
            x = _emulate_pass(
                ctx.f, x, tbl, perm if i == 0 else None, ps, n,
                vals.get("pre") if i == 0 else None,
                vals.get("abc") if i == 0 else None,
                vals.get("post") if i == len(ps_all) - 1 else None)
        plain = ctx._transform(a, getattr(ctx, tn), **ends)
        assert [ctx.decode(plain[i]) for i in range(len(x))] == x, tn
        if fn:
            want = ref.decode(jax.jit(ref.fft)(jnp.asarray(
                np.stack([ref.encode(r) for r in rows]))))
            assert [v for r in x for v in r] == want


BAD_PASS = ["pre-and-abc", "pre-length", "post-length", "pre-past-first",
            "abc-past-first", "abc-one-row", "abc-table"]


@pytest.mark.parametrize("case", BAD_PASS)
def test_ntt_pass_refuses_bad_operands(case):
    """ntt_pass raises on what K5 does not take: two prologues, a table
    of neither 1 nor n rows, a prologue past the first pass (M > 1), the
    ABC prologue on a source without two or three rows or with more
    than one element s; the CPU checks are the C entry's (csrc/ntt.cu),
    which the card tests hold too."""
    n, tile = 2 ** 4 * 3 * 7, 32
    ctx = fft_ctx(FIELDS["mnt4_r"][1]().Fr, n, CPU)
    ps0, ps1 = passes(n, ctx.levels, tile)[:2]
    x3 = torch.zeros((3, n, 10), dtype=torch.int32)
    s = ctx.n_inv
    args = {"pre-and-abc": (x3, ps0, dict(pre=ctx.coset_tbl, abc=s)),
            "pre-length": (x3, ps0, dict(pre=ctx.coset_tbl[:2])),
            "post-length": (x3, ps1, dict(post=ctx.coset_tbl[:n - 1])),
            "pre-past-first": (x3, ps1, dict(pre=ctx.coset_tbl)),
            "abc-past-first": (x3, ps1, dict(abc=s)),
            "abc-one-row": (x3[:1], ps0, dict(abc=s)),
            "abc-table": (x3, ps0, dict(abc=ctx.coset_tbl))}[case]
    src, ps, kw = args
    with pytest.raises(ValueError):
        ctx.ntt_pass(src, ctx.tbl_fwd, None, ps, **kw)


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


def _hpoly_unfused(ctx, x, zh, sq):
    """The unfused quotient on the plain ops: from_mont(coset_ifft(abc(
    coset_fft(ifft(x))))), each scaling a product of its own."""
    f = ctx.f
    ev = f.vmul(ctx._transform(x, ctx.tbl_inv), ctx.n_inv)
    ev = ctx._transform(f.vmul(ev, ctx.coset_tbl), ctx.tbl_fwd)
    h = f.abc(ev[0], ev[0] if sq else ev[1], ev[-1], zh)
    inv = f.vmul(ctx._transform(h, ctx.tbl_inv), ctx.n_inv)
    coset_inv = ctx._pow_table(ctx.domain.coset_shift_inv)
    return f.from_mont(f.vmul(inv, coset_inv))


@lru_cache(maxsize=None)
def _ref_quotient(field_name, n):
    """pcd_tpu's device quotient steps (pcd_tpu/snark/groth16/native.py:
    502-513) on JAX-CPU, jitted once: evaluations (3, n) Montgomery ->
    canonical h."""
    ref = ref_fft_ctx(FIELDS[field_name][0]().Fr, n)
    fp = ref.fp

    def q(evs, zh):
        ap = ref.coset_fft(ref.ifft(evs))
        prod = fp.sub(fp.mont_mul(ap[0], ap[1]), ap[2])
        return ref.coset_ifft(fp.mont_mul(prod, jnp.broadcast_to(
            zh, prod.shape)))
    return ref, jax.jit(q)


HPOLY_FUSED = [("mnt4_r", 2 ** 4 * 3 * 7, 32), ("mnt6_r", 2 * 3 * 5 * 7, 32)]


@pytest.mark.parametrize("sq", [False, True], ids=["groth16", "squaring"])
@pytest.mark.parametrize("field_name,n,tile", HPOLY_FUSED,
                         ids=[f"{f}-{n}" for f, n, _ in HPOLY_FUSED])
def test_hpoly_fused_matches_unfused_and_reference(field_name, n, tile, sq):
    """hpoly in three transforms (its pointwise steps in K5's prologue and
    epilogue, here on different passes at a forced small tile) against
    the unfused composition on the plain ops, the C++ native.hpoly and
    pcd_tpu's composition on JAX-CPU, the squaring case (b is a) too:
    the same canonical h, and K5's plain version 3 times a pass with no
    K7 step."""
    F = FIELDS[field_name][1]().Fr
    p = F.MODULUS
    ctx = _ctx_at_tile(F, n, tile)
    dom = ctx.domain
    zh_inv = pow(dom.vanishing_poly_at(dom.coset_shift), -1, p)
    a, b, c = _evals(F, n, n + sq, sat_rows=0)
    if sq:
        b = a
    A, B, C = (ctx.f.to_mont(upload_limbs(native.ints_to_limbs(v), CPU))
               for v in (a, b, c))
    if sq:
        B = A
    tec.reset_launch_counts()
    got = hpoly(ctx, A, B, C, zh_inv)
    assert tec.plain_counts() == {("ntt_pass", F.NAME): 3 * len(ctx.passes)}
    x = torch.stack((A, C) if sq else (A, B, C))
    zh = ctx.f.mont(zh_inv, CPU)
    assert torch.equal(got, _hpoly_unfused(ctx, x, zh, sq))
    al = native.ints_to_limbs(a)
    want = native.hpoly(p, dom.omega, dom.coset_shift, zh_inv, al,
                        al if sq else native.ints_to_limbs(b),
                        native.ints_to_limbs(c))
    assert np.array_equal(limbs_host(got), want)
    ref, q = _ref_quotient(field_name, n)
    evs = jnp.asarray(np.stack([ref.encode(v) for v in (a, b, c)]))
    zh_ref = jnp.asarray(ref.fp.to_mont_host(zh_inv))
    assert ref.decode(q(evs, zh_ref)) == [int(v) for v in
                                          native.limbs_to_ints(want)]
