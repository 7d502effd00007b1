"""Device-scheduled stream MSM of the port: the counterpart of DevSchedMSM
(`pcd_tpu/ops/msm_stream_dev.py`).  Only the scalar limbs cross to the
device; the digits, the sort, the histogram and the placement run there,
and the schedule they give feeds the same K1 -> K4 -> Horner pipeline as
the C++ schedule (ops/msm_stream.py):

  card  P1 (csrc/sched_digits.cu, four launches): p1_digits recodes the
        scalars' u32 words to signed c-bit digits, window-major; p1_hist
        counts each tile's magnitudes, p1_scan turns the tiles' counts
        into the (nwin, B + 2) histogram, its last column the overflow
        bin (a top-window digit above B), and each tile's offset in each
        bin; p1_scatter writes each window's scalar indices stably sorted
        by digit magnitude (a counting sort: the magnitudes are 12-bit
        keys at c = 12), each with its digit's sign in bit 31;
  host  the histogram is fetched (the one device-to-host sync of a
        schedule) and `_pick_shapes` takes the active windows, one shared
        round count T and maxrun from it, as the reference does;
  card  P2's placement over the active windows only (csrc/sched_place.cu,
        one launch, p2_place): the C++ and numpy schedules' placement law
        (each bucket ceil(count/T) lanes, its k-th point on lane start +
        k % lanes, round k // lanes) computed from the sorted ranks.  Each
        block scans its window's buckets in shared memory, gives each of
        its lanes its bucket, load, run remainder, round-0 rank and
        stride, and writes every round's signed row (order's entry as it
        is), with its share of bidx: the (perm, loads, bidx, runrem)
        int32 tensors K1 and K4 take; `place_plain` keeps the torch-ops
        law as its yardstick.

The reference computes its gather indices inside one fused program and
gathers table rows in chunks carried by `init`; K1 gathers by perm
itself and folds every active window in one launch, so the perm tensor
is the counterpart and neither the chunks nor `init` exist here.  Its
P1 masks infinite rows to digit 0 when a table cannot flag them: the
port's tables always flag infinity in-row (ops/ec.py), so there is no
mask, and a schedule serves any table of the same length.

On the CPU every step runs its plain torch version (P1: the digits, a
stable torch.sort and a searchsorted, the reference's three steps; P2:
the kernel's plain version); on a CUDA device the P1 and P2 kernels
launch (or raise) and nothing falls back to torch ops or to the host
schedule.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..utils.profiling import count, span
from .ec import _LAUNCHES, _PLAIN
from .msm_stream import StreamMSMCtx, stream_ctx

# the P1 kernels (csrc/sched_digits.cu), each launched once a schedule
P1_KERNELS = ("p1_digits", "p1_hist", "p1_scan", "p1_scatter")
# scalars a tile of p1_hist and p1_scatter, and the warps that split it:
# csrc/sched_digits.cu's constants (pcd_p1_tile, pcd_p1_warps), checked
# against the library once (_p1_lib)
P1_TILE = 8192
P1_WARPS = 8
# the P2 kernel (csrc/sched_place.cu), launched once a schedule with an
# active window
P2_KERNELS = ("p2_place",)
SCHED_KERNELS = P1_KERNELS + P2_KERNELS


@lru_cache(maxsize=None)
def _p1_lib():
    """csrc/sched_digits.cu's library, its tile and warps checked once
    against P1_TILE and P1_WARPS (hist's shape and the plain versions'
    warp segments)."""
    from .kernels import lib

    so = lib("sched_digits")
    if (so.pcd_p1_tile(), so.pcd_p1_warps()) != (P1_TILE, P1_WARPS):
        raise RuntimeError("csrc/sched_digits.cu's P1_TILE and P1_WARPS "
                           "are not msm_stream_dev's")
    return so


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
        """Host limb rows -> (n, 2 NL) int32 words on `device` (counter
        h2d_bytes: their bytes)."""
        W = self.limbs_u32(limbs)
        if not W.flags.writeable:             # torch wants a writable view
            W = W.copy()
        count("h2d_bytes", W.nbytes)
        return torch.from_numpy(W).to(device)

    # -- P1: digits, sort, histogram ----------------------------------------
    def digits_plain(self, W: torch.Tensor):
        """Plain version of the digits: (n, nwords) int32 words -> (mags
        (nwin, n) int32 in [0, B + 1], signs (nwin, n) int8), the carry
        chain of DevSchedMSM._p1 window by window, widened to int64 on W's
        device (torch has no unsigned 32-bit shifts)."""
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

    def p1_plain(self, W: torch.Tensor):
        """Plain version of P1: the digits, a stable sort of each window's
        magnitudes and a search of the sorted keys for the histogram (the
        reference's three steps), each index with its digit's sign in bit
        31; returns what p1 returns."""
        B = self.sctx.B
        mags, signs = self.digits_plain(W)
        skeys, order = torch.sort(mags, dim=1, stable=True)
        qs = torch.arange(B + 3, dtype=torch.int32, device=W.device)
        bounds = torch.searchsorted(
            skeys, qs.expand(mags.shape[0], -1).contiguous())
        counts = (bounds[:, 1:] - bounds[:, :-1]).to(torch.int32)
        return _signed(order, signs), signs, counts

    def p1(self, W: torch.Tensor):
        """(n, nwords) int32 words -> (order (nwin, n) int32, each window's
        scalars stably sorted by digit magnitude, the digit's sign in bit
        31 (the perm entry P2 places); signs (nwin, n) int8;
        counts (nwin, B + 2) int32, counts[w, b] the scalars of digit
        magnitude b in window w, column B + 1 the overflow bin).  On a CUDA
        tensor the four P1 kernels (p1_tiles); on a CPU one p1_plain."""
        dev = W.device
        if dev.type == "cpu":
            for k in P1_KERNELS:
                _PLAIN[(k, self.form)] += 1
            return self.p1_plain(W)
        if dev.type != "cuda":
            raise ValueError(f"P1: unsupported device {dev}")
        return self.p1_tiles(W)

    def p1_tiles(self, W: torch.Tensor):
        """P1 as its kernels compute it, tiles of P1_TILE scalars: digits,
        the tiles' histograms, their scan and the stable scatter.  On a CPU
        tensor each step is its plain version, so this is the kernels'
        tiled emulation."""
        mags, signs = self.digits(W)
        starts, counts = self.tile_scan(self.tile_hist(mags))
        return self.scatter(mags, signs, starts, counts), signs, counts

    def _launch(self, kernel, entry, *args):
        """The C entry `entry` of csrc/sched_digits.cu (a P1 kernel) or
        csrc/sched_place.cu (P2) on the current stream; counts the launch
        of `kernel`, or raises."""
        from .kernels import lib

        so = _p1_lib() if kernel in P1_KERNELS else lib("sched_place")
        rc = getattr(so, entry)(*args,
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
        _LAUNCHES[(kernel, self.form)] += 1

    def _on_card(self, kernel, t: torch.Tensor) -> bool:
        """False for a CPU tensor (the plain version runs and is counted),
        True for a CUDA one (the kernel launches); anything else raises."""
        if t.device.type == "cpu":
            _PLAIN[(kernel, self.form)] += 1
            return False
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{kernel}: a contiguous CPU or CUDA tensor "
                             f"expected, not {t.device}")
        return True

    def digits(self, W: torch.Tensor):
        """p1_digits: (n, nwords) int32 words -> (mags (nwin, n) int16 in
        [0, B + 1], signs (nwin, n) int8)."""
        if W.dtype != torch.int32 or W.dim() != 2:
            raise ValueError("p1_digits: (n, nwords) int32 expected")
        if not self._on_card("p1_digits", W):
            mags, signs = self.digits_plain(W)
            return mags.to(torch.int16), signs
        s = self.sctx
        n, nw = W.shape
        mags = torch.empty((s.nwin, n), dtype=torch.int16, device=W.device)
        signs = torch.empty((s.nwin, n), dtype=torch.int8, device=W.device)
        self._launch("p1_digits", "pcd_p1_digits",
                     W.data_ptr(), n, nw, s.c, s.base_windows,
                     int(s.carry_win), s.B, mags.data_ptr(),
                     signs.data_ptr())
        return mags, signs

    def tile_hist(self, mags: torch.Tensor):
        """p1_hist: mags (nwin, n) int16 -> (nwin, ceil(n / P1_TILE),
        B + 2) int32, each tile's count of each magnitude."""
        nwin, n = mags.shape
        K, nt = self.sctx.B + 2, -(-n // P1_TILE)
        if not self._on_card("p1_hist", mags):
            return self.hist_plain(mags)
        hist = torch.empty((nwin, nt, K), dtype=torch.int32,
                           device=mags.device)
        self._launch("p1_hist", "pcd_p1_hist",
                     mags.data_ptr(), nwin, n, K, hist.data_ptr())
        return hist

    def tile_scan(self, hist: torch.Tensor):
        """p1_scan: hist (nwin, ntiles, K) -> (starts, counts): starts[w,
        t, b] the keys of magnitude b in window w's tiles before t, counts
        (nwin, K) the bin totals.  The kernel writes starts over hist."""
        nwin, nt, K = hist.shape
        if not self._on_card("p1_scan", hist):
            return self.scan_plain(hist)
        counts = torch.empty((nwin, K), dtype=torch.int32,
                             device=hist.device)
        self._launch("p1_scan", "pcd_p1_scan",
                     hist.data_ptr(), nwin, nt, K, counts.data_ptr())
        return hist, counts

    def scatter(self, mags: torch.Tensor, signs: torch.Tensor,
                starts: torch.Tensor, counts: torch.Tensor):
        """p1_scatter: mags and signs (nwin, n), tile_scan's starts and
        counts -> order (nwin, n) int32, each index with its digit's sign
        in bit 31.  Each tile is P1_WARPS contiguous warp segments; a key's
        slot is the window's keys of lower magnitude, plus its magnitude's
        keys in the earlier tiles, in the earlier segments of its tile and
        before it in its own segment."""
        nwin, n = mags.shape
        if not self._on_card("p1_scatter", mags):
            return self.scatter_plain(mags, signs, starts, counts)
        if signs.shape != mags.shape or signs.dtype != torch.int8 \
                or signs.device != mags.device or not signs.is_contiguous():
            raise ValueError("p1_scatter: signs (nwin, n) int8 beside mags "
                             "expected")
        order = torch.empty((nwin, n), dtype=torch.int32, device=mags.device)
        self._launch("p1_scatter", "pcd_p1_scatter",
                     mags.data_ptr(), signs.data_ptr(), nwin, n,
                     self.sctx.B + 2, starts.data_ptr(), counts.data_ptr(),
                     order.data_ptr())
        return order

    # the plain versions of p1_hist, p1_scan and p1_scatter, on any device;
    # a tile other than P1_TILE (a multiple of 32 * P1_WARPS) emulates the
    # kernels' geometry at a small size
    def hist_plain(self, mags: torch.Tensor, tile: int = P1_TILE):
        nwin, n = mags.shape
        K, nt = self.sctx.B + 2, -(-n // tile)
        dev = mags.device
        t = torch.arange(n, device=dev) // tile
        key = ((torch.arange(nwin, device=dev)[:, None] * nt + t) * K
               + mags.to(torch.int64))
        return torch.bincount(key.view(-1), minlength=nwin * nt * K).view(
            nwin, nt, K).to(torch.int32)

    @staticmethod
    def scan_plain(hist: torch.Tensor):
        h = hist.to(torch.int64)
        starts = torch.cumsum(h, 1) - h
        return starts.to(torch.int32), h.sum(1).to(torch.int32)

    def scatter_plain(self, mags: torch.Tensor, signs: torch.Tensor,
                      starts: torch.Tensor, counts: torch.Tensor,
                      tile: int = P1_TILE):
        nwin, n = mags.shape
        K, nt = self.sctx.B + 2, -(-n // tile)
        seg, ns = tile // P1_WARPS, nt * P1_WARPS
        dev = mags.device
        j = torch.arange(n, device=dev)
        t = j // tile
        g = t * P1_WARPS + (j % tile) // seg          # the warp segment
        key = mags.to(torch.int64)
        gk = g * K + key                              # (nwin, n)
        cnt = torch.bincount((torch.arange(nwin, device=dev)[:, None]
                              * (ns * K) + gk).view(-1),
                             minlength=nwin * ns * K).view(nwin, nt,
                                                           P1_WARPS, K)
        earlier = (torch.cumsum(cnt, 2) - cnt).view(nwin, ns * K)
        first = (torch.cumsum(cnt.view(nwin, -1), 1)
                 - cnt.view(nwin, -1))                # of (segment, key)
        srt, idx = torch.sort(gk, dim=1, stable=True)
        rank = torch.arange(n, device=dev) - first.gather(1, srt)
        tk = t.expand(nwin, n).gather(1, idx) * K + key.gather(1, idx)
        cnt64 = counts.to(torch.int64)
        base = torch.cumsum(cnt64, 1) - cnt64         # lower magnitudes
        slot = (base.gather(1, key.gather(1, idx))
                + starts.view(nwin, nt * K).to(torch.int64).gather(1, tk)
                + earlier.gather(1, srt) + rank)
        order = torch.empty((nwin, n), dtype=torch.int64, device=dev)
        order.scatter_(1, slot, idx)
        return _signed(order, signs)

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
    def place(self, order, counts, act, T):
        """The placement law over the active windows `act` (ascending), on
        the device of P1's (order, counts): (perm (nact, T, L) int32, row
        index with the digit sign in bit 31 (order's entry), 0 past a
        lane's load; loads (nact, L); bidx (nact, B), each bucket's first
        lane as a global lane over the nact windows, sentinel nact * L;
        runrem (nact, L), lanes left in the lane's run, 0 on an unused
        lane).  On a CUDA device the P2 kernel, on the CPU its plain
        version; T at least the fit of every active window."""
        s = self.sctx
        nwin = s.nwin
        if not (order.dtype == torch.int32 and counts.dtype == torch.int32
                and order.dim() == 2 and order.shape[0] == nwin
                and tuple(counts.shape) == (nwin, s.B + 2)):
            raise ValueError("P2: P1's order (nwin, n) int32 and counts "
                             "(nwin, B + 2) int32 expected")
        if order.device != counts.device or not (
                order.is_contiguous() and counts.is_contiguous()):
            raise ValueError("P2: order and counts contiguous, on one "
                             "device")
        if not act or list(act) != sorted(set(act)) or act[0] < 0 \
                or act[-1] >= nwin or T < 1:
            raise ValueError(f"P2: active windows {act} or T = {T} refused")
        if not self._on_card("p2_place", order):
            return self.p2_place_plain(order, counts, act, T)
        nact, L, B = len(act), s.L, s.B
        new = lambda *shape: torch.empty(shape, dtype=torch.int32,  # noqa
                                         device=order.device)
        perm, loads, bidx, runrem = (new(nact, T, L), new(nact, L),
                                     new(nact, B), new(nact, L))
        self._launch("p2_place", "pcd_p2_place", order.data_ptr(),
                     counts.data_ptr(), nwin, order.shape[1], B + 2,
                     _wins(act), nact, B, T, L, perm.data_ptr(),
                     loads.data_ptr(), bidx.data_ptr(), runrem.data_ptr())
        return perm, loads, bidx, runrem

    def p2_place_plain(self, order, counts, act, T):
        """Plain version of p2_place, on any device: the kernel's formulas
        (each window's scans of lanes and counts, a lane's bucket the last
        one starting at or before it, its load, run remainder, round-0
        rank and stride, then order's entry of each round's rank)."""
        s = self.sctx
        L, B = s.L, s.B
        dev = counts.device
        nact = len(act)
        aidx = torch.tensor(act, dtype=torch.int64, device=dev)
        cnt = counts.index_select(0, aidx)[:, :B + 1].to(torch.int64)
        cnz = cnt[:, 1:]
        zero = cnt.new_zeros((nact, 1))
        starts = torch.cat([zero, torch.cumsum((cnz + (T - 1)) // T, 1)], 1)
        off = cnt[:, :1] + torch.cat([zero, torch.cumsum(cnz, 1)], 1)
        glob = torch.arange(nact, dtype=torch.int64, device=dev)[:, None] * L
        bidx = torch.where(starts[:, 1:] > starts[:, :B], starts[:, :B] + glob,
                           nact * L)
        lane = torch.arange(L, dtype=torch.int64, device=dev).expand(nact, L)
        b = torch.searchsorted(starts[:, :B].contiguous(), lane.contiguous(),
                               right=True) - 1
        st = starts.gather(1, b)
        lb = starts.gather(1, b + 1) - st
        of = off.gather(1, b)
        cz = off.gather(1, b + 1) - of
        j = lane - st
        valid = lane < starts[:, B:]
        lb1 = torch.where(valid, lb, 1)
        loads = torch.where(valid, (cz - j + lb1 - 1) // lb1, 0)
        runrem = torch.where(valid, lb - j, 0)
        t = torch.arange(T, dtype=torch.int64, device=dev).view(1, T, 1)
        live = t < loads[:, None, :]
        k = (torch.where(valid, of + j, 0)[:, None, :]
             + t * torch.where(valid, lb, 0)[:, None, :])
        perm = torch.where(live.view(nact, T * L), order.index_select(
            0, aidx).gather(1, torch.where(live, k, 0).view(nact, T * L)), 0)
        return tuple(x.to(torch.int32).contiguous() for x in (
            perm.view(nact, T, L), loads, bidx, runrem))

    def place_plain(self, order, counts, act, T):
        """The placement law as torch ops (what place returns), the
        yardstick of the P2 kernel in the tests and chip_smoke.py; the
        sign in perm's bit 31 is order's.  No path calls it."""
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
        ent = order.index_select(0, aidx).gather(
            1, torch.where(live, k, 0)).to(torch.int64)
        pidx, neg = ent & 0x7FFFFFFF, (ent < 0).to(torch.int64)
        perm = torch.where(live, pidx - (neg << 31), 0)   # sign in bit 31
        return tuple(x.to(torch.int32).contiguous() for x in (
            perm.view(nact, T, L), loads, bidx, runrem))

    def schedule(self, W: torch.Tensor) -> DevSchedule:
        """Device (n, nwords) int32 scalar words -> DevSchedule on W's
        device.  Enqueued on the current stream; the histogram fetch waits
        for that stream.  Raises when a scalar is wider than scalar_bits."""
        order, _, counts = self.p1(W)
        with span("sched_fetch"):
            counts_h = counts.cpu().numpy()
        if counts_h[:, -1].any():
            raise ValueError("scalar exceeds declared scalar_bits")
        act, T, maxrun = self._pick_shapes(counts_h)
        with span("sched_place"):
            tensors = self.place(order, counts, act, T) if act else None
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
        return self.msm_limbs(*self.sctx.operands(points, scalars, device))


def _wins(act):
    """The active windows as the P2 entry's int array."""
    return (ctypes.c_int * len(act))(*act)


def _signed(order, signs):
    """order (nwin, n) int64 indices -> int32 with each index's digit sign
    (signs at the index, in its window) in bit 31."""
    neg = signs.gather(1, order).to(torch.int64) != 0
    return (order - (neg.to(torch.int64) << 31)).to(torch.int32)


@lru_cache(maxsize=None)
def devsched_ctx(curve, scalar_bits: int, c: int = 12,
                 lanes: int = 8192) -> DevSchedMSM:
    return DevSchedMSM(stream_ctx(curve, scalar_bits, c, lanes))
