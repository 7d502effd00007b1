"""The port's sparse matvec (pcd_tpu_torch/ops/matvec_tensor.py) on the CPU,
where K6 runs its plain version (the products, then each row's run summed
pairwise): against pcd_tpu's SparseMatVec on JAX-CPU on the reference
test's random 37 x 23 rows (tests/test_ops_device.py:233), and against the
C++ tier's CSR SpMatrices over MNT4-298's Fr with empty rows and one long
row.  Values are compared as canonical field elements; the tolerance is
exact equality.
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
    device_matrices, eval_rows_device, matrices_to_device)

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
