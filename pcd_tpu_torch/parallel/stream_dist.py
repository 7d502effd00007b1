"""The stream MSM sharded over the ranks of a Mesh: the counterpart of
ShardedStreamMSM (`pcd_tpu/parallel/stream_dist.py`).

DP over points.  An MSM is linear in its point set, so each rank holds a
shard of the table and schedules only its own scalars (under
msm_dispatch.SCHEDULER, by default on the device of the rank's table:
P1 and P2 on a card, the C++ schedule on the CPU); it runs K1 and K4 once
on its shard, exactly the single-card pipeline (ops/msm_stream.py), and its
(nwin, 3, d, 10) window sums are all-gathered.  A device schedule covers
only its active windows, which differ between ranks, so each rank pads
its sums to all nwin windows with identity rows before the gather; a
window no rank covers comes out as the identity.  Every rank then sums
the gathered rows per window in the host Horner tail and holds the same
point.

The reference adds the gathered sums with complete adds on every chip
inside its program and keeps the bucket finish on every shard.  The port
keeps the per-shard finish (on separate cards the finishes run side by
side, one finish of wall time) and moves the combine into the Horner
tail it runs anyway.

Shards are contiguous: rank r holds rows [r m, (r + 1) m) of an n-row
table, m = ceil(n / size), the last padded with infinity-flagged rows
whose scalars are zero, as the reference's `encode_table` pads.  A table
may also be given by explicit rows (`table_at`): the prover's h-query
shard follows the sharded quotient's layout (parallel/dist.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..curves.jacobian import jacobian
from ..ops.msm_stream import StreamMSMCtx, stream_ctx
from .mesh import Mesh


class ShardFuture(NamedTuple):
    """One rank's enqueued window sums: the schedule's active windows,
    the sums on the device and the CUDA event after them (None on the
    CPU)."""
    act: tuple
    ws: torch.Tensor
    ev: object


class ShardedStreamMSM:
    """Point-sharded stream MSM over a Mesh.

    Usage (on every rank):
        smsm = ShardedStreamMSM(curve, scalar_bits, mesh, c=12, lanes=8192)
        table, inf = smsm.encode_table(points)    # this rank's shard
        out = smsm.msm_limbs(table, limbs)         # the host point
    """

    def __init__(self, curve, scalar_bits: int, mesh: Mesh, c: int = 12,
                 lanes: int = 8192):
        self.mesh = mesh
        self.ndev = mesh.size
        self.sctx: StreamMSMCtx = stream_ctx(curve, scalar_bits, c, lanes)

    # -- shards -----------------------------------------------------------
    def _pad_n(self, n: int) -> int:
        return -(-n // self.ndev) * self.ndev

    def shard_rows(self, n: int) -> np.ndarray:
        """This rank's rows of an n-row vector, -1 where the shard runs
        past the end."""
        m = self._pad_n(n) // self.ndev
        idx = np.arange(self.mesh.rank * m, (self.mesh.rank + 1) * m,
                        dtype=np.int64)
        idx[idx >= n] = -1
        return idx

    def shard_scalars(self, limbs):
        """This rank's rows of the scalars of all n rows: (n, NL) u64 limbs
        on the host or (n, 10) int32 limbs on the device, padded with
        zero rows as the table is with infinities."""
        n = limbs.shape[0]
        m = self._pad_n(n) // self.ndev
        lo = min(self.mesh.rank * m, n)
        part = limbs[lo:lo + m]
        if part.shape[0] == m:
            return part
        if isinstance(part, torch.Tensor):
            pad = part.new_zeros((m - part.shape[0],) + tuple(part.shape[1:]))
            return torch.cat([part, pad])
        return np.concatenate([part, np.zeros(
            (m - part.shape[0],) + part.shape[1:], dtype=part.dtype)])

    def encode_table(self, points, device=None):
        """Point list (all n) -> (this rank's (m, 2, d, 10) table on
        `device`, its infinity mask)."""
        from ..native import _points_to_arrays

        xs, ys, inf = _points_to_arrays(points, self.sctx.ec.d)
        return self.table_from_limbs(xs, ys, inf, device)

    def table_from_limbs(self, xs, ys, inf, device=None):
        """Canonical u64 limb coordinates of all n rows (the C++ tier's
        EncodedPoints layout) -> this rank's contiguous shard."""
        return self.table_at(xs, ys, inf, self.shard_rows(xs.shape[0]),
                             device)

    def table_at(self, xs, ys, inf, rows, device=None):
        """The table of the given rows of all n (-1: an infinity row) on
        `device` (the mesh's by default), and its infinity mask."""
        rows = np.asarray(rows, dtype=np.int64)
        ok = rows >= 0
        sel = np.where(ok, rows, 0)
        inf_l = ~ok | np.asarray(inf, dtype=bool)[sel]
        dev = self.mesh.device if device is None else device
        return self.sctx.table_from_limbs(xs[sel], ys[sel], inf_l,
                                          dev), inf_l

    # -- the rank's pipeline -------------------------------------------------
    def window_sums_async(self, table, limbs, sched_stream=None,
                          sched_cache=None) -> ShardFuture:
        """Schedule this rank's scalars (as many rows as its table, host
        u64 or device int32 limbs) under msm_dispatch.SCHEDULER (by
        default on the table's device when it is a card, else on the
        host) and enqueue K1 and K4 on the current stream, without
        waiting.
        sched_cache: a dict shared by the MSMs of one scalar vector (the
        prover's a/b1/b2/l), keyed by the vector's digest."""
        from ..snark.msm_dispatch import schedule, schedule_key

        if limbs.shape[0] != table.shape[0]:
            raise ValueError(f"sharded MSM: {limbs.shape[0]} scalars for a "
                             f"shard of {table.shape[0]} points")
        sctx = self.sctx
        key = None if sched_cache is None else schedule_key(sctx, limbs)
        sched = None if key is None else sched_cache.get(key)
        if sched is None:
            sched = schedule(sctx, limbs, table.device, sched_stream)
            if key is not None:
                sched_cache[key] = sched
        ws, ev = sctx.window_sums_async(table, sched)
        return ShardFuture(tuple(sched.act), ws, ev)

    def collect(self, fut: ShardFuture):
        """Wait for this rank's sums, pad them to every window, all-gather
        them and run the Horner tail: the MSM over all ranks' points,
        the same host point on every rank."""
        sctx = self.sctx
        act, ws, ev = fut
        if ev is not None:
            ev.synchronize()
        full = sctx.ec.identity((sctx.nwin,), ws.device)
        if act:
            full[torch.tensor(act, device=ws.device)] = ws
        return self.horner(self.mesh.all_gather(full).cpu().numpy())

    def horner(self, g: np.ndarray):
        """sum_w 2^(c w) sum_r g[r, w] over the gathered (size, nwin, 3,
        d, 10) window sums."""
        sctx = self.sctx
        pts = sctx.ec.decode_jacobian(g.reshape((-1,) + g.shape[2:]))
        nwin = sctx.nwin
        return jacobian(sctx.curve).horner(sctx.c, (
            pts[w::nwin] for w in reversed(range(nwin))))

    # -- entry points ---------------------------------------------------------
    def msm_limbs(self, table, limbs):
        """This rank's table + the scalars of all n rows ((n, NL) u64 or
        (n, 10) int32 device limbs) -> the host point."""
        return self.collect(self.window_sums_async(
            table, self.shard_scalars(limbs)))

    def msm(self, points, scalars):
        """Host convenience API: point list + int scalars -> host point
        (every rank passes all of them)."""
        assert len(points) == len(scalars) and points
        table, _ = self.encode_table(points)
        nbytes = (self.sctx.scalar_bits + 63) // 64 * 8
        return self.msm_limbs(table, self.sctx.limb_rows(scalars, nbytes))
