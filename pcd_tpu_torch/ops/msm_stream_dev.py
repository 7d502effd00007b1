"""Device-scheduled stream MSM of the port: the counterpart of DevSchedMSM
(`pcd_tpu/ops/msm_stream_dev.py`).  Only the scalar limbs cross to the
device; the digits, the sort, the histogram and the placement run there,
and the schedule they give feeds the same K1 -> K4 -> Horner pipeline as
the C++ schedule (ops/msm_stream.py):

  card  P1: sched_digits (csrc/sched_digits.cu, one launch) recodes the
        scalars' u32 words to signed c-bit digits, window-major; a stable
        sort per window orders each window's scalars by digit magnitude,
        and a search of the sorted keys gives the (nwin, B + 2) histogram,
        its last column the overflow bin (a top-window digit above B);
  host  the histogram is fetched (the one device-to-host sync of a
        schedule) and `_pick_shapes` takes the active windows, one shared
        round count T and maxrun from it, as the reference does;
  card  P2's placement over the active windows only, torch ops: the
        C++ and numpy schedules' placement law (each bucket ceil(count/T)
        lanes, its k-th point on lane start + k % lanes, round k // lanes)
        computed arithmetically from the sorted ranks, into the (perm,
        loads, bidx, runrem) int32 tensors K1 and K4 take.

The reference computes its gather indices inside one fused program and
gathers table rows in chunks carried by `init`; K1 gathers by perm
itself and folds every active window in one launch, so the perm tensor
is the counterpart and neither the chunks nor `init` exist here.  Its
P1 masks infinite rows to digit 0 when a table cannot flag them: the
port's tables always flag infinity in-row (ops/ec.py), so there is no
mask, and a schedule serves any table of the same length.

On the CPU every step runs its plain torch version; on a CUDA device
sched_digits launches (or raises) and nothing falls back to the host
schedule.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .ec import _LAUNCHES, _PLAIN
from .msm_stream import StreamMSMCtx, stream_ctx


class DevSchedule:
    """A schedule computed on the device: the windows with a nonzero
    digit (`act`, ascending), the shared round count T, maxrun (the pow2
    bound of a bucket's lanes), and on `device` the (perm (nact, T, L),
    loads (nact, L), bidx (nact, B), runrem (nact, L)) int32 tensors of
    those windows: StreamSchedule's layout with the windows renumbered
    0..nact-1 (bidx's global lanes and sentinel nact * L)."""

    __slots__ = ("act", "T", "maxrun", "device", "tensors")

    def __init__(self, act, T, maxrun, device, tensors):
        self.act = tuple(act)
        self.T = T
        self.maxrun = maxrun
        self.device = device
        self.tensors = tensors

    def on(self, device):
        d = torch.device(device)
        if d.type != self.device.type or d.index not in (
                None, self.device.index):
            raise ValueError(f"device schedule lives on {self.device}, "
                             f"asked on {device}")
        return self.tensors


class DevSchedMSM:
    """Device-scheduled pipeline over a StreamMSMCtx's curve and kernels."""

    def __init__(self, sctx: StreamMSMCtx):
        self.sctx = sctx
        self.form = f"{sctx.scalar_bits}-bit c={sctx.c}"

    # -- upload ------------------------------------------------------------
    @staticmethod
    def limbs_u32(limbs: np.ndarray) -> np.ndarray:
        """(n, NL) u64 canonical limb rows -> (n, 2 NL) int32 words, the
        same little-endian bytes (u32 words as torch holds them)."""
        n = limbs.shape[0]
        return np.ascontiguousarray(limbs, dtype="<u8").view(
            "<i4").reshape(n, -1)

    def upload(self, limbs: np.ndarray, device) -> torch.Tensor:
        """Host limb rows -> (n, 2 NL) int32 words on `device`."""
        W = self.limbs_u32(limbs)
        if not W.flags.writeable:             # torch wants a writable view
            W = W.copy()
        return torch.from_numpy(W).to(device)

    # -- P1: digits, sort, histogram ----------------------------------------
    def digits_plain(self, W: torch.Tensor):
        """Plain version of sched_digits: (n, nwords) int32 words ->
        (mags (nwin, n) int32 in [0, B + 1], signs (nwin, n) int8), the
        carry chain of DevSchedMSM._p1 window by window, widened to int64
        on W's device (torch has no unsigned 32-bit shifts)."""
        s = self.sctx
        c, base, B = s.c, s.base_windows, s.B
        n, nw = W.shape
        need = (base * c + 31) // 32 + 1
        Wl = W.to(torch.int64) & 0xFFFFFFFF
        if nw < need:
            Wl = torch.cat([Wl, Wl.new_zeros((n, need - nw))], dim=1)
        mask, half, full = (1 << c) - 1, 1 << (c - 1), 1 << c
        mags = torch.zeros((s.nwin, n), dtype=torch.int32, device=W.device)
        signs = torch.zeros((s.nwin, n), dtype=torch.int8, device=W.device)
        carry = torch.zeros(n, dtype=torch.int64, device=W.device)
        for w in range(base):
            w0, sh = divmod(w * c, 32)
            v = Wl[:, w0] >> sh
            if sh + c > 32:
                v = v | (Wl[:, w0 + 1] << (32 - sh))
            d = (v & mask) + carry
            if w == base - 1 and not s.carry_win:
                mags[w] = torch.clamp(d, max=B + 1).to(torch.int32)
                return mags, signs
            carry = (d >= half).to(torch.int64)
            d = d - carry * full
            mags[w] = d.abs().to(torch.int32)
            signs[w] = (d < 0).to(torch.int8)
        mags[base] = carry.to(torch.int32)
        return mags, signs

    def digits(self, W: torch.Tensor):
        """sched_digits: the kernel for a CUDA tensor, its plain version
        for a CPU one (see digits_plain)."""
        dev = W.device
        key = ("sched_digits", self.form)
        if dev.type == "cpu":
            _PLAIN[key] += 1
            return self.digits_plain(W)
        if dev.type != "cuda":
            raise ValueError(f"sched_digits: unsupported device {dev}")
        if W.dtype != torch.int32 or W.dim() != 2 or not W.is_contiguous():
            raise ValueError("sched_digits: contiguous (n, nwords) int32 "
                             "expected")
        from .kernels import lib

        s = self.sctx
        n, nw = W.shape
        mags = torch.empty((s.nwin, n), dtype=torch.int32, device=dev)
        signs = torch.empty((s.nwin, n), dtype=torch.int8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib("sched_digits").pcd_sched_digits(
            W.data_ptr(), n, nw, s.c, s.base_windows, int(s.carry_win), s.B,
            mags.data_ptr(), signs.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"sched_digits launch failed: CUDA error {rc}")
        _LAUNCHES[key] += 1
        return mags, signs

    def p1(self, W: torch.Tensor):
        """(n, nwords) int32 words -> (order (nwin, n) int64, each window's
        scalars stably sorted by digit magnitude; signs (nwin, n) int8;
        counts (nwin, B + 2) int32, counts[w, b] the scalars of digit
        magnitude b in window w, column B + 1 the overflow bin)."""
        B = self.sctx.B
        mags, signs = self.digits(W)
        skeys, order = torch.sort(mags, dim=1, stable=True)
        qs = torch.arange(B + 3, dtype=torch.int32, device=W.device)
        bounds = torch.searchsorted(
            skeys, qs.expand(mags.shape[0], -1).contiguous())
        counts = (bounds[:, 1:] - bounds[:, :-1]).to(torch.int32)
        return order, signs, counts

    # -- host: shapes from the fetched histogram ---------------------------
    def _pick_shapes(self, counts: np.ndarray):
        """counts (nwin, >= B + 1) -> (active windows, shared round count T,
        maxrun pow2): the reference's choice, one T for every active window
        (the largest per-window fit, a multiple of 8)."""
        s = self.sctx
        act = []
        T = 8
        mr = 1
        for w in range(s.nwin):
            cnz = counts[w, 1:s.B + 1]
            m = int(cnz.sum())
            if m == 0:
                continue
            act.append(w)
            T = max(T, -(-s._fit_T(cnz, m) // 8) * 8)
        for w in act:
            mr = max(mr, int((-(-counts[w, 1:s.B + 1] // T)).max()))
        maxrun = 1
        while maxrun < mr:
            maxrun *= 2
        return act, T, maxrun

    # -- P2's placement ------------------------------------------------------
    def place(self, order, signs, counts, act, T):
        """The placement law over the active windows `act`, on the device
        of `order`: (perm (nact, T, L) int32, row index with the digit sign
        in bit 31, 0 past a lane's load; loads (nact, L); bidx (nact, B),
        each bucket's first lane as a global lane over the nact windows,
        sentinel nact * L; runrem (nact, L), lanes left in the lane's run,
        0 on an unused lane)."""
        s = self.sctx
        L, B = s.L, s.B
        dev = order.device
        nact = len(act)
        aidx = torch.tensor(act, dtype=torch.int64, device=dev)
        cnt = counts.index_select(0, aidx)[:, :B + 1].to(torch.int64)
        cnz = cnt[:, 1:]                                  # (nact, B)
        lanes_b = (cnz + (T - 1)) // T
        starts = torch.cumsum(lanes_b, 1) - lanes_b       # exclusive
        used = starts[:, -1] + lanes_b[:, -1]
        off_b = cnt[:, :1] + torch.cumsum(cnz, 1) - cnz   # sorted rank
        lane = torch.arange(L, dtype=torch.int64, device=dev)
        b_l = torch.searchsorted(starts, lane.expand(nact, L).contiguous(),
                                 right=True) - 1
        b_l = b_l.clamp(0, B - 1)                         # lane's bucket
        st_l = starts.gather(1, b_l)
        lbr_l = lanes_b.gather(1, b_l)
        lb_l = lbr_l.clamp(min=1)
        j_l = lane - st_l                                 # lane in bucket
        valid = lane < used[:, None]
        loads = torch.where(
            valid, (cnz.gather(1, b_l) - j_l + lb_l - 1) // lb_l, 0)
        runrem = torch.where(valid, st_l + lbr_l - lane, 0)
        glob = torch.arange(nact, dtype=torch.int64, device=dev)[:, None] * L
        bidx = torch.where(cnz > 0, starts + glob, nact * L)
        # round t of lane j of bucket b folds the scalar of sorted rank
        # off_b + t * lanes_b + j
        t = torch.arange(T, dtype=torch.int64, device=dev).view(1, T, 1)
        live = (t < loads[:, None, :]).view(nact, T * L)
        k = (off_b.gather(1, b_l)[:, None, :] + t * lb_l[:, None, :]
             + j_l[:, None, :]).view(nact, T * L)
        pidx = order.index_select(0, aidx).gather(1, torch.where(live, k, 0))
        neg = signs.index_select(0, aidx).gather(1, pidx).to(torch.int64)
        perm = torch.where(live, pidx - (neg << 31), 0)   # sign in bit 31
        return tuple(x.to(torch.int32).contiguous() for x in (
            perm.view(nact, T, L), loads, bidx, runrem))

    def schedule(self, W: torch.Tensor) -> DevSchedule:
        """Device (n, nwords) int32 scalar words -> DevSchedule on W's
        device.  Enqueued on the current stream; the histogram fetch waits
        for that stream.  Raises when a scalar is wider than scalar_bits."""
        order, signs, counts = self.p1(W)
        counts_h = counts.cpu().numpy()
        if counts_h[:, -1].any():
            raise ValueError("scalar exceeds declared scalar_bits")
        act, T, maxrun = self._pick_shapes(counts_h)
        tensors = self.place(order, signs, counts, act, T) if act else None
        return DevSchedule(act, T, maxrun, W.device, tensors)

    # -- entry points --------------------------------------------------------
    def window_sums(self, table, W: torch.Tensor):
        """Device table + device scalar words -> (active windows, their
        (nact, 3, d, 10) window sums on the device): K1 and K4 once each
        when any window is active, nothing otherwise."""
        sched = self.schedule(W)
        return sched.act, self.sctx.window_sums(table, sched)

    def horner_host(self, act, wsn):
        """Horner tail over the active windows' sums (host rows, row i the
        sum of window act[i]); the empty windows only pay their
        doublings."""
        return self.sctx.horner_host(wsn, act)

    def msm_limbs(self, table, limbs: np.ndarray):
        """Device table + host (n, NL) u64 limb rows -> host point."""
        act, ws = self.window_sums(table, self.upload(limbs, table.device))
        return self.horner_host(act, ws.cpu().numpy())

    def msm(self, points, scalars, device=None):
        """Host points and int scalars -> host point, the table and the
        scalars uploaded to `device` (None: the card)."""
        from .. import native
        from ..device import resolve_device

        dev = resolve_device(device)
        s = self.sctx
        xs, ys, inf = native._points_to_arrays(points, s.ec.d)
        table = s.table_from_limbs(xs, ys, inf.astype(bool), dev)
        nbytes = (s.scalar_bits + 63) // 64 * 8
        return self.msm_limbs(table, s.limb_rows(scalars, nbytes))


@lru_cache(maxsize=None)
def devsched_ctx(curve, scalar_bits: int, c: int = 12,
                 lanes: int = 8192) -> DevSchedMSM:
    return DevSchedMSM(stream_ctx(curve, scalar_bits, c, lanes))
