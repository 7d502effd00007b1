"""One large transform sharded over the ranks of a Mesh by the 4-step
(Bailey) decomposition: the counterpart of DistributedFFT
(`pcd_tpu/parallel/fft.py`), and the stages that the sharded quotient
(parallel/dist.py) runs forwards and backwards.

N = n1 n2, the input x viewed as A[n1, n2] (row-major, A[i, j] =
x[i n2 + j]); rank r holds the natural block, columns [r m2, (r + 1) m2),
m2 = n2 / size:
  1. length-n1 transforms along the columns: one batched K5 call
     (ops/fft_tensor.py) on a contiguous transposed copy of the block;
  2. the twiddles w^(k1 j): K7, a product by this rank's table block;
  3. Mesh.all_to_all: k1 becomes the sharded axis, rank r then holds
     rows [r m1, (r + 1) m1), m1 = n1 / size, of all n2 columns;
  4. length-n2 transforms along the rows: K5.
The result is the sigma block: position (k1, k2) holds X[k2 n1 + k1].
`to_natural` runs the stages backwards (row transforms, the inverse
all_to_all, twiddles, column transforms), so to_natural(to_sigma(x,
inverse)) gives x back and nothing ever builds a global reorder.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fft_tensor import fft_ctx
from ..ops.field import NLIMB, ints_to_limbs
from ..poly.domain import EvaluationDomain
from .mesh import Mesh


def geom_rows(p: int, base: int, firsts, ratios, ncols: int,
              scale: int = 1) -> list:
    """Rows of powers of `base`: row i is base^(firsts[i] + ratios[i] j)
    times `scale`, j < ncols, by geometric accumulation (one product an
    entry), flat."""
    out = []
    for a, b in zip(firsts, ratios):
        cur = pow(base, a, p) * scale % p
        step = pow(base, b, p)
        for _ in range(ncols):
            out.append(cur)
            cur = cur * step % p
    return out


class FourStep:
    """The 4-step stages of an N = n1 n2 point domain of F on one rank."""

    def __init__(self, F, n1: int, n2: int, mesh: Mesh):
        D = mesh.size
        if n1 % D or n2 % D:
            raise ValueError(f"4-step: {n1} x {n2} does not split over {D} "
                             f"ranks")
        self.F, self.mesh = F, mesh
        self.n1, self.n2, self.N = n1, n2, n1 * n2
        self.m1, self.m2 = n1 // D, n2 // D
        dev = mesh.device
        self.ctx1 = fft_ctx(F, n1, dev)
        self.ctx2 = fft_ctx(F, n2, dev)
        self.f = self.ctx1.f
        self.domain = EvaluationDomain(F, self.N)

    # -- tables (host, once) ---------------------------------------------
    def upload(self, vals) -> torch.Tensor:
        """Ints as they are -> (n, 10) int32 limbs on the rank's device."""
        return torch.from_numpy(ints_to_limbs(vals).view(np.int32)).to(
            self.mesh.device)

    def table_stage(self, base: int) -> torch.Tensor:
        """The natural block's twiddles base^(i j), i < n1, j this rank's
        columns, Montgomery, (n1 m2, 10)."""
        c0 = self.mesh.rank * self.m2
        f = self.f
        return self.upload(geom_rows(f.p, base, [i * c0 for i in range(
            self.n1)], range(self.n1), self.m2, f.r))

    def table_sigma(self, base: int, scale: int) -> torch.Tensor:
        """The sigma block's powers base^(k2 n1 + k1) times `scale` (R
        for Montgomery form, 1 for plain residues), k1 this rank's rows,
        (m1 n2, 10)."""
        r0 = self.mesh.rank * self.m1
        return self.upload(geom_rows(self.f.p, base, range(
            r0, r0 + self.m1), [self.n1] * self.m1, self.n2, scale))

    def sigma_index(self) -> np.ndarray:
        """(m1 n2,) the natural index k2 n1 + k1 of each sigma-block
        position."""
        k1 = np.arange(self.mesh.rank * self.m1,
                       (self.mesh.rank + 1) * self.m1, dtype=np.int64)
        return (np.arange(self.n2, dtype=np.int64)[None, :] * self.n1
                + k1[:, None]).reshape(-1)

    def natural_index(self) -> np.ndarray:
        """(n1 m2,) the natural index i n2 + j of each natural-block
        position."""
        j = np.arange(self.mesh.rank * self.m2,
                      (self.mesh.rank + 1) * self.m2, dtype=np.int64)
        return (np.arange(self.n1, dtype=np.int64)[:, None] * self.n2
                + j[None, :]).reshape(-1)

    # -- stages -------------------------------------------------------------
    def _cols(self, x, inverse: bool):
        """(B, n1, m2, 10) -> the same with every column transformed."""
        B, n1, m2 = x.shape[0], self.n1, self.m2
        # K5 reads contiguous lines: a copy, also where reshape could view
        t = x.transpose(1, 2).contiguous().reshape(B * m2, n1, NLIMB)
        t = self.ctx1.ifft(t) if inverse else self.ctx1.fft(t)
        return t.reshape(B, m2, n1, NLIMB).transpose(1, 2).contiguous()

    def _rows(self, x, inverse: bool):
        """(B, m1, n2, 10) -> the same with every row transformed."""
        t = x.contiguous().reshape(-1, self.n2, NLIMB)
        t = self.ctx2.ifft(t) if inverse else self.ctx2.fft(t)
        return t.reshape(x.shape)

    def _twiddle(self, x, tbl):
        B = x.shape[0]
        return self.f.vmul(x.reshape(B, -1, NLIMB), tbl).reshape(x.shape)

    def to_sigma(self, x, tw, inverse: bool = False):
        """Natural blocks (B, n1, m2, 10) -> sigma blocks (B, m1, n2, 10):
        the forward (or inverse, with the inverse root's twiddles `tw`)
        transform, its 1/N split between the two inverse transforms."""
        a = self._twiddle(self._cols(x, inverse), tw)
        return self._rows(self.mesh.all_to_all(a, 1, 2), inverse)

    def to_natural(self, c, tw):
        """Sigma blocks (B, m1, n2, 10) -> natural blocks (B, n1, m2, 10):
        to_sigma(., inverse=True)'s stages undone in reverse order, the
        forward transform of sigma-ordered coefficients."""
        a = self.mesh.all_to_all(self._rows(c, False), 2, 1)
        return self._cols(self._twiddle(a, tw), False)

    def gather_natural(self, blk) -> torch.Tensor:
        """This rank's sigma block (m1 n2, 10) -> all N values in natural
        order on every rank, (N, 10)."""
        g = self.mesh.all_gather(blk.reshape(self.m1, self.n2, NLIMB))
        return g.reshape(self.n1, self.n2, NLIMB).transpose(0, 1).reshape(
            self.N, NLIMB)


class DistributedFFT:
    """The forward transform of one N = n1 n2 point domain, sharded."""

    def __init__(self, F, n1: int, n2: int, mesh: Mesh):
        self.fs = FourStep(F, n1, n2, mesh)
        self.F, self.n1, self.n2, self.N = F, n1, n2, n1 * n2
        self.mesh = mesh
        self.twiddle = self.fs.table_stage(self.fs.domain.omega)

    def encode_input(self, coeffs) -> torch.Tensor:
        """Coefficients (at most N, all of them on every rank) -> this
        rank's natural block (n1, m2, 10), Montgomery."""
        fs, f = self.fs, self.fs.f
        vals = list(coeffs) + [0] * (self.N - len(coeffs))
        idx = fs.natural_index()
        return fs.upload([int(vals[i]) * f.r % f.p for i in idx]).reshape(
            self.n1, fs.m2, NLIMB)

    def run(self, block) -> torch.Tensor:
        """This rank's natural block (n1, m2, 10) -> its sigma block of
        evaluations (m1, n2, 10)."""
        return self.fs.to_sigma(block[None], self.twiddle)[0]

    def fft(self, coeffs) -> list:
        """Full pipeline; returns the evaluations in natural order (host
        list, on every rank)."""
        out = self.run(self.encode_input(coeffs))
        return self.fs.f.decode_ints(
            self.fs.gather_natural(out).cpu().numpy())
