"""The port's mixed-radix NTT and device quotient (pcd_tpu_torch/ops/
fft_tensor.py) on the CPU, where every level of K5 and every K7 step runs
its plain version: the transforms against pcd_tpu's FFTTensorCtx on
JAX-CPU at the reference test's sizes (tests/test_ops_device.py:144) and
against the port's host EvaluationDomain on domains with the factors 3, 5
and 7; K5's plan, digit reversal and twiddle indices at the real domains'
sizes without running a transform; `hpoly` against the C++ tier's
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
from pcd_tpu_torch.ops.fft_tensor import (fft_ctx, hpoly,  # noqa: E402
                                          input_permutation, level_twiddles,
                                          plan)
from pcd_tpu_torch.ops.field import limbs_host, upload_limbs  # noqa: E402
from pcd_tpu_torch.poly.domain import EvaluationDomain  # noqa: E402

from _torch_support import two_torch_threads  # noqa: E402,F401

CPU = torch.device("cpu")
FIELDS = {"toy_r": (RM.toy_mnt4, TM.toy_mnt4),
          "mnt4_r": (RM.mnt4_298, lambda: TM.mnt_cycle().main),
          "mnt6_r": (RM.mnt6_298, lambda: TM.mnt_cycle().help)}
DIRECTIONS = ("fft", "ifft", "coset_fft", "coset_ifft")
# the real domains: Groth16 main and help, GM17 main and help
REAL = {225_792: ("mnt4_r", (2,) * 9 + (3, 3, 7, 7)),
        31_360: ("mnt6_r", (2,) * 7 + (5, 7, 7)),
        688_128: ("mnt4_r", (2,) * 15 + (3, 7)),
        107_520: ("mnt6_r", (2,) * 10 + (3, 5, 7))}


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
    assert tec.plain_counts()[("ntt_level", F.NAME)] == 4 * len(ctx.levels)
    assert tec.launch_counts() == {}


@pytest.mark.parametrize("n", sorted(REAL))
def test_plan_and_twiddle_indices_at_real_sizes(n):
    """K5's integer arithmetic at the real domains, without a transform:
    the plan's radixes, the digit reversal (mixed radix, not a bit
    reversal), and every level's stepped twiddle index against (stride j
    k) mod n in Python ints; every index stays below n and every step
    below 2^31."""
    field_name, want = REAL[n]
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
