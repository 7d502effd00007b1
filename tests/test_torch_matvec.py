"""The port's sparse matvec (pcd_tpu_torch/ops/matvec_tensor.py) on the CPU,
where K6 runs its plain version (the products, then each row's run summed
pairwise): against pcd_tpu's SparseMatVec on JAX-CPU on the reference
test's random 37 x 23 rows (tests/test_ops_device.py:233), and against the
C++ tier's CSR SpMatrices over MNT4-298's Fr with empty rows and one long
row; K6's row binning (`bin_rows`, unit entries first) in an emulation of
the kernel's warp and thread rows against the plain version, on a toy
circuit's matrices and on a matrix of rows of 0 to 1,000 entries.  Values
are compared as canonical field elements; the tolerance is exact
equality.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu.curves import models as RM  # noqa: E402
from pcd_tpu.ops.matvec_tensor import (  # noqa: E402
    eval_rows_device as ref_eval_rows, matrices_to_device as ref_matrices)
from pcd_tpu_torch import native  # noqa: E402
from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops import ec as tec  # noqa: E402
from pcd_tpu_torch.ops.field import limbs_host, upload_limbs  # noqa: E402
from pcd_tpu_torch.ops.matvec_tensor import (  # noqa: E402
    WARP_MIN, device_matrices, eval_rows_device, matrices_to_device)

from _torch_support import two_torch_threads  # noqa: E402,F401

CPU = torch.device("cpu")


def _rows(rng, p, n_rows, n_cols, most=4):
    def mk():
        return {rng.randrange(n_cols): rng.randrange(p)
                for _ in range(rng.randrange(most))}
    return [(mk(), mk(), mk()) for _ in range(n_rows)]


def test_matvec_matches_reference():
    """The reference test's 37 x 23 random rows on the toy field."""
    RF, TF = RM.toy_mnt4().Fr, TM.toy_mnt4().Fr
    p = TF.MODULUS
    rng = random.Random(233)
    rows = _rows(rng, p, 37, 23)
    z = [rng.randrange(p) for _ in range(23)]
    want = ref_eval_rows(ref_matrices(RF, rows, 37, 23), z, RF)
    tec.reset_launch_counts()
    got = eval_rows_device(matrices_to_device(TF, rows, 37, 23, CPU), z, TF,
                           CPU)
    assert got == [list(w) for w in want]
    assert tec.plain_counts()[("spmv_rows", TF.NAME)] == 3
    assert tec.launch_counts() == {}


def test_matvec_matches_native_csr():
    """MNT4-298 Fr: empty rows, single entries, one row over every column
    and rows padded past the constraints, as the Groth16 prover pads them
    to the domain; into an output view of one (3, n, 10) tensor."""
    F = TM.mnt_cycle().main.Fr
    p = F.MODULUS
    rng = random.Random(11)
    n_cols, n_rows, pad = 300, 90, 38
    rows = _rows(rng, p, n_rows, n_cols, most=3)
    rows[5] = ({}, {}, {})
    rows[40] = ({c: rng.randrange(p) for c in range(n_cols)}, {7: 1}, {})
    z = [rng.randrange(p) for _ in range(n_cols)]
    want = native.SpMatrices(p, rows, n_rows + pad).apply_all_limbs(z)

    class PK:
        pass

    pk = PK()
    mats = device_matrices(pk, F, rows, n_rows + pad, n_cols, CPU)
    assert device_matrices(pk, F, rows, n_rows + pad, n_cols, CPU) is mats
    assert [m.max_row for m in mats] == [n_cols, 2, 2]
    f = mats[0].f
    zm = f.to_mont(upload_limbs(native.ints_to_limbs(z), CPU))
    evs = torch.empty((3, n_rows + pad, 10), dtype=torch.int32)
    for k, m in enumerate(mats):
        m.apply(zm, out=evs[k])
    for k in range(3):
        assert np.array_equal(limbs_host(f.from_mont(evs[k])), want[k]), k
    with pytest.raises(ValueError, match="spmv_rows"):
        mats[0].apply(zm[:n_cols - 1])


def _emulate_k6(m, z):
    """K6 (csrc/spmv.cu) on canonical ints: the n_warp rows of `order`
    first, 32 lanes striding each row's unit entries and then its
    products, the lanes' sums folded by shfl_down (lane + off past 31
    reads its own); the rest one thread a row.  Returns the row sums."""
    f = m.f
    p = f.p
    rowptr = m.rowptr.tolist()
    units = m.units.tolist()
    cols = m.cols.tolist()
    vals = f.decode_ints(m.vals.numpy()) if m.nnz else []
    out = [0] * m.n_rows

    def terms(row, lanes, lane):
        e0, e1 = rowptr[row], rowptr[row + 1]
        eu = e0 + units[row]
        acc = 0
        for e in range(e0 + lane, eu, lanes):
            assert vals[e] == 1
            acc += z[cols[e]]
        for e in range(eu + lane, e1, lanes):
            assert vals[e] != 1
            acc += vals[e] * z[cols[e]]
        return acc % p

    for i, row in enumerate(m.order.tolist()):
        if i < m.n_warp:
            acc = [terms(row, 32, lane) for lane in range(32)]
            for off in (16, 8, 4, 2, 1):
                acc = [(a + (acc[ln + off] if ln + off < 32 else a)) % p
                       for ln, a in enumerate(acc)]
            out[row] = acc[0]
        else:
            out[row] = terms(row, 1, 0)
    return out


def _long_rows(p, rng, n_cols=1200):
    """Rows of 0, 1, 2, 31, 32, 33, 299 and 1,000 entries (twice, and
    some short ones), two in five values one."""
    rows = []
    for L in (0, 1, 2, 31, 32, 33, 299, 1000, 3, 7) * 2:
        rows.append(tuple(
            {c: 1 if rng.random() < 0.4 else rng.randrange(2, p)
             for c in rng.sample(range(n_cols), L)} for _ in range(3)))
    return rows, n_cols


def _toy_rows(p, rng):
    """The R1CS rows of the toy_groth16 PCD's main circuit (the verifier
    gadget and the chains' predicate), as its setup synthesizes it."""
    from pcd_tpu_torch import configs
    from pcd_tpu_torch.pcd.api import FpPredicate
    from pcd_tpu_torch.pcd.ec_cycle import MainCircuit
    from pcd_tpu_torch.utils.rng import ChaChaRng
    from _torch_support import predicate

    ic = configs.toy_groth16("cpu").ic
    circ = MainCircuit(ic, predicate(FpPredicate, ic.main_field),
                       ic.crh.setup(ChaChaRng(b"binned rows")))
    csys = ic.main_snark._synthesize(circ)
    return (ic.main_snark._matrix_rows(csys),
            csys.num_instance + csys.num_witness)


@pytest.mark.parametrize("which", ["toy_circuit", "long_rows"])
def test_binned_rows_match_plain(which):
    """K6's layout: every row once in `order`, the rows of more than
    WARP_MIN entries (and only they) in the warp bin, longest first, each
    row's unit entries first; the kernel's emulation equal to
    apply_plain."""
    cyc = TM.toy_mnt4() if which == "toy_circuit" else TM.mnt_cycle().main
    F = cyc.Fr
    p = F.MODULUS
    rng = random.Random(7)
    rows, n_cols = (_toy_rows if which == "toy_circuit" else _long_rows)(
        p, rng)
    n_rows = len(rows) + 3
    z = [rng.randrange(p) for _ in range(n_cols)]
    mats = matrices_to_device(F, rows, n_rows, n_cols, CPU)
    f = mats[0].f
    zm = f.to_mont(upload_limbs(native.ints_to_limbs(z), CPU))
    for m in mats:
        lens = np.diff(m.rowptr.numpy())
        order = m.order.numpy()
        assert sorted(order.tolist()) == list(range(n_rows))
        warp = order[:m.n_warp]
        assert set(warp.tolist()) == set(np.flatnonzero(lens > WARP_MIN))
        assert (np.diff(lens[warp]) <= 0).all()
        if which == "long_rows":
            assert sorted(lens[warp].tolist()) == [33, 33, 299, 299, 1000,
                                                   1000]
        assert m.n_units == int(m.units.sum())
        got = _emulate_k6(m, z)
        assert got == f.decode_ints(m.apply_plain(zm).numpy())
