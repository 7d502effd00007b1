"""Sparse matrix-vector products over prime fields on the device: the
counterpart of `pcd_tpu/ops/matvec_tensor.py` (SparseMatVec,
matrices_to_device, eval_rows_device), the A z, B z and C z row
evaluations that feed the QAP and SAP quotients.

A matrix lives on the device in CSR: int32 row pointers and columns and
(nnz, 10) int32 Montgomery values (ops/field.py), each row's unit entries
(value one) first.  On a card the product is K6 `spmv_rows`
(csrc/spmv.cu): `bin_rows` orders the rows once per matrix, those of more
than WARP_MIN entries one warp each, the rest one thread each.  On the CPU
it is
the reference's product-then-segmented-sum in torch: every entry's
val * z[col], then each row's run of terms summed pairwise, level by
level.  The reference splits the entries into chunks of MAX_CHUNK to
bound a TPU working set; neither version here needs that.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native
from .field import _LAUNCHES, _PLAIN, NLIMB, FieldCtx, upload_limbs

# K6 gives a row of more entries than this one warp (csrc/spmv.cu)
WARP_MIN = 32


def bin_rows(counts, units):
    """K6's row order: (order (n_rows,) int32, n_warp).  The n_warp rows
    of more than WARP_MIN entries come first, longest first, one warp
    each; then the others, one thread each, by products (entries that
    are not units) and then units, most first, so that a warp's rows cost
    alike.  counts, units: entries and unit entries per row."""
    counts = np.asarray(counts, dtype=np.int64)
    units = np.asarray(units, dtype=np.int64)
    long_ = counts > WARP_MIN
    warp = np.flatnonzero(long_)
    warp = warp[np.argsort(-counts[warp], kind="stable")]
    rest = np.flatnonzero(~long_)
    rest = rest[np.lexsort((-units[rest], -(counts - units)[rest]))]
    return np.concatenate([warp, rest]).astype(np.int32), int(warp.size)


class SparseMatVec:
    """One sparse matrix (rows x cols) over Fp in CSR on `device`."""

    def __init__(self, F, rows_idx, cols_idx, vals, n_rows: int, n_cols: int,
                 device):
        """rows_idx sorted ascending; vals ints mod p."""
        self.f = f = FieldCtx(F.MODULUS, name=F.NAME)
        self.n_rows, self.n_cols = n_rows, n_cols
        dev = torch.device(device)
        rows = np.asarray(rows_idx, dtype=np.int64)
        counts = np.bincount(rows, minlength=n_rows)[:n_rows]
        self.nnz = int(rows.shape[0])
        self.max_row = int(counts.max()) if n_rows else 0
        canon = native.ints_to_limbs(vals)        # (nnz, 5) u64
        unit = (canon[:, 0] == 1) & ~canon[:, 1:].any(axis=1)
        # each row's unit entries first (rows_idx stays sorted)
        ent = np.lexsort((~unit, rows))
        cols = np.asarray(cols_idx, dtype=np.int32)[ent]
        canon, unit = canon[ent], unit[ent]
        units = np.bincount(rows[unit], minlength=n_rows)[:n_rows]
        self.n_units = int(unit.sum())
        order, self.n_warp = bin_rows(counts, units)
        self.rowptr = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int32)).to(dev)
        self.units = torch.from_numpy(units.astype(np.int32)).to(dev)
        self.order = torch.from_numpy(order).to(dev)
        self.rows = torch.from_numpy(rows).to(dev)
        self.cols = torch.from_numpy(cols).to(dev)
        canon = upload_limbs(canon, dev)
        self.vals = f.to_mont(canon) if self.nnz else canon
        self.device = self.vals.device        # "cuda" -> "cuda:0"

    def apply(self, z_mont, out=None):
        """K6.  z_mont (n_cols, 10) Montgomery -> (n_rows, 10) row sums in
        Montgomery form (rows without entries = 0), into `out` when
        given (a contiguous (n_rows, 10) int32 view)."""
        dev = z_mont.device
        if z_mont.dim() != 2 or z_mont.shape[0] < self.n_cols \
                or dev != self.device:
            raise ValueError(f"spmv_rows: z (>= {self.n_cols}, 10) on "
                             f"{self.device} expected")
        key = ("spmv_rows", self.f.name)
        if dev.type == "cpu":
            _PLAIN[key] += 1
            res = self.apply_plain(z_mont)
            if out is None:
                return res
            out.copy_(res)
            return out
        if out is None:
            out = torch.empty((self.n_rows, NLIMB), dtype=torch.int32,
                              device=dev)
        for t in (z_mont, out):
            if t.dtype != torch.int32 or not t.is_contiguous() \
                    or t.data_ptr() % 8 or t.device != dev:
                raise ValueError(f"spmv_rows: contiguous int32 on {dev} "
                                 f"expected")
        if tuple(out.shape) != (self.n_rows, NLIMB):
            raise ValueError("spmv_rows: out must be (n_rows, 10)")
        from .kernels import lib

        rc = lib("spmv").pcd_spmv_rows(
            self.rowptr.data_ptr(), self.units.data_ptr(),
            self.cols.data_ptr(), self.vals.data_ptr(),
            self.order.data_ptr(), z_mont.data_ptr(), out.data_ptr(),
            self.n_rows, self.n_warp,
            self.f.kconsts.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"spmv_rows launch failed: CUDA error {rc}")
        _LAUNCHES[key] += 1
        return out

    def apply_plain(self, z_mont):
        """The plain version of K6: the terms val * z[col], then each
        row's run summed pairwise until one term per row is left."""
        f = self.f
        out = torch.zeros((self.n_rows, NLIMB), dtype=torch.int32,
                          device=z_mont.device)
        if not self.nnz:
            return out
        V = f.mul(f.to_plain(self.vals),
                  f.to_plain(z_mont[self.cols.long()]))   # (nd, nnz)
        rows = self.rows
        while True:
            nxt = rows[1:] == rows[:-1]             # entry i + 1 in i's row
            if not bool(nxt.any()):
                break
            N = rows.shape[0]
            ar = torch.arange(N, device=rows.device)
            first = torch.ones(N, dtype=torch.bool, device=rows.device)
            first[1:] = ~nxt
            start = torch.cummax(torch.where(first, ar, 0), 0).values
            keep = ((ar - start) % 2 == 0).nonzero().squeeze(1)
            pair = torch.zeros(N, dtype=torch.bool, device=rows.device)
            pair[:-1] = nxt
            mate = torch.clamp(keep + 1, max=N - 1)
            other = torch.where(pair[keep], V[:, mate], torch.zeros_like(
                V[:, mate]))
            V = f.add(V[:, keep], other)
            rows = rows[keep]
        out[rows] = f.from_plain(V)
        return out


def matrices_to_device(F, rows, n_rows: int, n_cols: int, device):
    """rows: list of (a_lc, b_lc, c_lc) dicts in column space -> three
    SparseMatVec objects (CSR, row-major) on `device`."""
    out = []
    for k in range(3):
        ri, ci, vi = [], [], []
        for r, row in enumerate(rows):
            for c, v in sorted(row[k].items()):
                if v % F.MODULUS:
                    ri.append(r)
                    ci.append(c)
                    vi.append(v % F.MODULUS)
        out.append(SparseMatVec(F, ri, ci, vi, n_rows, n_cols, device))
    return tuple(out)


def device_matrices(pk, F, rows, n_rows: int, n_cols: int, device):
    """matrices_to_device, uploaded once per pk and device and cached on
    the pk (`pk._dev_mats`, as the reference caches its own)."""
    cache = getattr(pk, "_dev_mats", None)
    if cache is None:
        cache = {}
        pk._dev_mats = cache
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = matrices_to_device(F, rows, n_rows, n_cols, device)
    return cache[key]


def eval_rows_device(mats, z_ints, F, device):
    """Az, Bz, Cz as int lists (length n_rows) via the device matvecs."""
    f = mats[0].f
    z = f.to_mont(upload_limbs(native.ints_to_limbs(
        [int(v) % F.MODULUS for v in z_ints]), device))
    return [f.decode_ints(m.apply(z).cpu().numpy()) for m in mats]
