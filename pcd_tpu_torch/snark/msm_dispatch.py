"""MSM helpers shared by the port's Groth16, GM17 and KZG10 provers: the
counterpart of `pcd_tpu/snark/msm_dispatch.py`, keeping its host-table
marshalling, the host halves of `fb_mul` and `msm_any`, `subrange` and
its stream half (lines 142-286 there), and `fb_mul`'s device branch
(lines 36-61 there).  `stream_launch`, `zpad_query` and `side_stream`
hold the dispatch that the reference's Groth16 and GM17 provers each
write inline.  The device-resident legacy tier (DevicePointVec, the scan
MSM) is not ported.

KEYGEN picks who computes the setups' fixed-base products [s_i] G
(`fb_mul`, the Groth16, GM17 and KZG10 setups): "host", the C++ tier's
windowed fixed-base, or "device", K8 (ops/fixed_base.py) on the card the
setup's SNARK was built for, from 64 scalars up.  Either gives the same
points, so the same keys.

SCHEDULER picks who schedules a stream MSM: "host", the C++ tier's
threaded msm_schedule, or "device", DevSchedMSM (ops/msm_stream_dev.py),
where only the scalar limbs cross and the digits, sort and placement run
on the device.  Both schedules feed the same K1 -> K4 -> Horner pipeline;
it replaces the reference's PCD_TPU_DEVSCHED environment variable.  The
default, "auto", follows the device the MSM runs on: "device" on a CUDA
device, "host" anywhere else.  On the card the C++ schedule kept the
H100 idle about 80% of gm17_msm's batch, while P1 and P2 take well under
a millisecond and only the scalars cross (PERF.md section 6); on the CPU
the device schedule would run its plain torch versions, slower than the
C++ tier.  "host" and "device" force either path; schedule() counts the
schedules each path makes (counters sched_host and sched_device of
utils/profiling).

QUOTIENT picks who computes the Groth16 and GM17 provers' quotient h =
(A B - C)/Z_H: "host", the C++ tier's CSR matvec and fused `hpoly`, or
"device", the reference's device tier (its `_use_device` branch): z goes
to the device once and the matvec (ops/matvec_tensor.py), the transforms
and the pointwise steps (ops/fft_tensor.py) run there, so h stays on the
device for the h-query MSM.

The stream tier runs on the device the prover was built for: on a CUDA
device the kernels of ops/ec.py, on the CPU their plain versions.  K1 and
K4 are enqueued on the caller's current stream (the prover's side
stream); each future carries the CUDA event recorded after it, and
`stream_collect` waits on that event before it reads the window sums.
The schedule reads the scalars on the prover's schedule stream
(`side_stream` yields it), which waits only for the scalars' producer:
the quotient's stream for h, nothing for z, which it uploads itself.  So
the device schedule's P1 and its histogram fetch, or the host
scheduler's fetch of h, do not queue behind the side stream's K1 and K4
of the earlier MSMs; the side stream waits for the placement through an
event.
"""

from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import torch

from ..device import on_card
from ..utils.profiling import (count, open_request, request,
                               request_id, span)

# Stream-MSM window bits and accumulator lanes: the reference's values
# (pcd_tpu/ops/msm_stream.py:117), kept as the starting point to measure
# again on the card (PERF.md).  The per-window sums do not depend on L.
WINDOW_BITS = 12
LANES = 8192
# Who schedules the stream MSMs: "auto" follows the MSM's device (the
# device schedule on a card, the C++ one elsewhere), "host" and "device"
# force either (see the module docstring).  "auto" since the gm17_msm
# benchmark, where the schedule is the batch's critical path and the C++
# schedule left the H100 idle about 80% of the time (PERF.md section 6).
SCHEDULER = "auto"
# Who computes the provers' quotient, "host" or "device" (see the module
# docstring).  "device" by the rule in PERF.md (PR 6): on the H100 the
# Groth16 warm step under the device quotient was shorter in every pair,
# its median by far more than the host steps' interquartile distance.
QUOTIENT = "device"
# Who computes the setups' fixed-base products, "host" or "device" (see
# the module docstring).  "device" by the rule in PERF.md section 6: on
# the H100 chip_smoke.py phase 11's fb_mul under "device" was shorter in
# every pair of turns on all four forms (the reference chose the host on
# a TPU, groth16/native.py:106-110; that number does not carry over).
KEYGEN = "device"
# the fewest scalars a device fixed-base takes (the reference's host
# threshold of its C++ fixed-base, msm_dispatch.py:50)
KEYGEN_MIN = 64


def quotient_tier() -> str:
    """QUOTIENT, checked: an unknown value raises."""
    if QUOTIENT in ("host", "device"):
        return QUOTIENT
    raise ValueError(f"msm_dispatch.QUOTIENT: 'host' or 'device', not "
                     f"{QUOTIENT!r}")


def scheduler_tier(device) -> str:
    """The scheduler SCHEDULER picks for an MSM on `device`: "device" or
    "host"; "auto" is "device" on a card.  An unknown value raises."""
    if SCHEDULER == "auto":
        return "device" if on_card(device) else "host"
    if SCHEDULER in ("host", "device"):
        return SCHEDULER
    raise ValueError(f"msm_dispatch.SCHEDULER: 'auto', 'host' or 'device', "
                     f"not {SCHEDULER!r}")


def keygen_tier() -> str:
    """KEYGEN, checked: an unknown value raises."""
    if KEYGEN in ("host", "device"):
        return KEYGEN
    raise ValueError(f"msm_dispatch.KEYGEN: 'host' or 'device', not "
                     f"{KEYGEN!r}")


def host_query(owner, name: str):
    """owner.<name> is a FIXED host point list consumed by repeated MSMs
    (a pk query table).  Returns a pre-marshalled EncodedPoints cached on
    the owner — the Python-side marshalling of a production-size table
    costs more than the native MSM itself.  A table that is already an
    EncodedPoints (say `EncodedPoints.from_affine_words` of the keygen
    kernel's output) is returned as it is."""
    q = getattr(owner, name)
    if not isinstance(q, list):
        return q
    cache = getattr(owner, "_host_enc", None)
    if cache is None:
        cache = {}
        owner._host_enc = cache
    enc = cache.get(name)
    if enc is None:
        from ..msm.host import encode_query

        enc = encode_query(q)
        cache[name] = enc
    return enc


def fb_mul(cfg, which: str, scalars, scalar_bits: int, device=None):
    """[s_i] G for G = cfg's G1 ("g1") or G2 ("g2") generator, as host
    points.  Under KEYGEN "device", from KEYGEN_MIN scalars up on a card
    `device`: K8 (ops/fixed_base.py; a failed build or launch raises).
    Else on the host: the C++ windowed fixed-base from 64 scalars up where
    it takes the curve, else a FixedBaseTable cached on cfg (the
    reference's fb_mul, msm_dispatch.py:36-61)."""
    from ..msm.host import (FixedBaseTable, _native, _native_curve_ok,
                            fixed_base_many)

    curve = cfg.g1 if which == "g1" else cfg.g2
    base = cfg.g1_gen if which == "g1" else cfg.g2_gen
    if keygen_tier() == "device" and len(scalars) >= KEYGEN_MIN \
            and on_card(device):
        from ..ops.fixed_base import fixed_base_device

        with span("fb_mul_device"):
            return fixed_base_device(curve, base, scalar_bits).mul_many(
                scalars, device)
    if len(scalars) >= 64 and _native_curve_ok(curve) \
            and _native() is not None:
        return fixed_base_many(base, scalars, scalar_bits)
    key = ("_fbt_" + which, scalar_bits)
    tbl = getattr(cfg, "_fb_cache", None)
    if tbl is None:
        tbl = {}
        object.__setattr__(cfg, "_fb_cache", tbl)
    if key not in tbl:
        tbl[key] = FixedBaseTable(base, scalar_bits, window=8)
    return [tbl[key].mul(int(s)) for s in scalars]


def subrange(query, start: int, stop=None):
    """Rows [start, stop) of a host point list or an EncodedPoints table
    (a zero-copy view)."""
    from ..native import EncodedPoints

    if isinstance(query, EncodedPoints):
        return query.slice(start, len(query) if stop is None else stop)
    return query[start:stop]


def msm_any(query, scalars):
    """MSM on the host tier over a host point list or a pre-marshalled
    EncodedPoints table; returns a host point."""
    from ..msm.host import msm as host_msm
    from ..native import EncodedPoints

    if isinstance(query, EncodedPoints):
        # pre-marshalled fixed table: no host-side zero filter (the C++
        # bucket loop skips zero digits); zip-truncate like the list path
        n = min(len(query), len(scalars))
        return host_msm(query.slice(0, n) if len(query) != n else query,
                        scalars[:n] if len(scalars) != n else scalars)
    if isinstance(scalars, np.ndarray):
        # limb scalars meeting a small plain-list query (tables under the
        # native encode threshold stay lists)
        from ..native import limbs_to_ints

        scalars = limbs_to_ints(scalars)
    nz = [(pt, s) for pt, s in zip(query, scalars) if s]
    if not nz:
        return query[0].curve.infinity()
    return host_msm([a for a, _ in nz], [b for _, b in nz])


def _owned_stream(owner, attr: str, device):
    """owner.<attr>, a CUDA stream on `device` made on first use."""
    st = getattr(owner, attr, None)
    if st is None:
        st = torch.cuda.Stream(device)
        setattr(owner, attr, st)
    return st


@contextlib.contextmanager
def side_stream(owner, device, reads=()):
    """Context manager placing work on `owner`'s MSM side stream, made on
    first use; it yields `owner`'s schedule stream, where `schedule` reads
    the scalars (a no-op yielding None on the CPU).  `reads`: scalars
    that the caller's current stream computed (the device quotient's h);
    the schedule stream first waits for the caller's stream, and their
    memory stays reserved until the schedule stream's work is done.  The
    schedule stream waits for nothing else, so a schedule does not queue
    behind the side stream's earlier K1 and K4."""
    if device.type != "cuda":
        yield None
        return
    side = _owned_stream(owner, "_msm_stream", device)
    sched = _owned_stream(owner, "_sched_stream", device)
    if reads:
        sched.wait_stream(torch.cuda.current_stream(device))
        for t in reads:
            t.record_stream(sched)
    with torch.cuda.stream(side):
        yield sched


def zpad_query(pk, nm: str, n_inst: int, curve) -> str:
    """Name of pk's query `nm` realigned to the full z vector.  A query
    over the witness columns only (z[n_inst:]) gets n_inst
    flagged-infinity rows in front, cached on the pk as `<nm>_zpad`, so
    it shares the schedule of the queries over all of z.  A host point
    list gets host points at infinity; an EncodedPoints table, encoded
    rows flagged at infinity."""
    from ..native import EncodedPoints

    if not n_inst:
        return nm
    pad = nm + "_zpad"
    if not hasattr(pk, pad):
        q = getattr(pk, nm)
        setattr(pk, pad, q.pad_front(n_inst) if isinstance(q, EncodedPoints)
                else [curve.infinity()] * n_inst + list(q))
    return pad


def stream_launch(pk, queries, h_curve, scalar_bits: int, z_limbs, device,
                  sched_stream=None):
    """Build the stream tables of `queries` ((name, curve) pairs) and of
    h_query, then enqueue the queries' MSMs against z_limbs, one shared
    schedule (on `sched_stream`, see `schedule`) and one digest of
    z_limbs, without waiting.
    Opens a profiling request unless one is held (utils/profiling.py): the
    futures, and the h MSM dispatched after, carry it.  Returns {name:
    future}."""
    open_request()
    for nm, curve in tuple(queries) + (("h_query", h_curve),):
        stream_table(pk, nm, curve, scalar_bits, device)
    futs = {}
    sched_cache, digests = {}, {}
    with span("stream_dispatch"):
        for nm, curve in queries:
            futs[nm] = stream_msm_async(pk, nm, curve, scalar_bits, z_limbs,
                                        device, sched_cache=sched_cache,
                                        sched_stream=sched_stream,
                                        digests=digests)
    return futs


def stream_table(pk, nm: str, curve, scalar_bits: int, device):
    """(stream ctx, device table, inf mask) for a pk query table, cached
    on the pk per device.  Raises when the table cannot go to the stream
    tier: nothing drops to the host quietly."""
    from ..native import EncodedPoints
    from ..ops.msm_stream import stream_ctx, stream_ok

    if not stream_ok(curve):
        raise ValueError(f"stream MSM: unsupported coordinate field of "
                         f"{curve.name}")
    sctx = stream_ctx(curve, scalar_bits, WINDOW_BITS, LANES)
    tables = getattr(pk, "_stream_tables", None)
    if tables is None:
        tables = {}
        pk._stream_tables = tables
    key = (nm, str(device))
    hit = tables.get(key)
    if hit is None:
        enc = host_query(pk, nm)
        if not isinstance(enc, EncodedPoints):
            raise RuntimeError(f"stream MSM: {nm} has no native encoding "
                               f"(the C++ tier is required)")
        inf = np.asarray(enc.inf, dtype=bool)
        hit = (sctx.table_from_limbs(enc.xs, enc.ys, inf, device), inf)
        tables[key] = hit
    return (sctx,) + hit


def stream_msm_async(pk, nm: str, curve, scalar_bits: int, scal_limbs,
                     device, sched_cache=None, offset=None,
                     sched_stream=None, digests=None):
    """Enqueue one query MSM on the stream tier without waiting; returns
    a future for stream_collect.  scal_limbs: (n, NL) u64 canonical limbs
    (truncated to the table length; fewer scalars than points raises),
    or (n, 10) int32 canonical limbs on the device (the device quotient's
    h), which the device scheduler reads in place and the host scheduler
    fetches.

    offset: an MSM over the rows [offset, offset + n) of the table only,
    n the number of scalars (KZG's commits and opens over a prefix or a
    degree-bound shift of the SRS powers).  The rows are a contiguous
    view of the device table, which K1 gathers from by index, and only
    the n scalars are scheduled.

    sched_cache: optional per-prove dict.  The tables flag their
    infinities in-row, so a schedule depends only on the scalars, and the
    a/b1/b2 (+ padded l) MSMs — one z vector against four tables — share
    one schedule and one upload.  The key identifies the scalar vector by
    a digest of its limbs (the reference keys on (c, L, qn) alone, which is
    right only while every caller passes the same z).

    digests: optional dict beside sched_cache that keeps each digest by
    the vector's id, so a vector is digested once; the caller holds every
    vector it passes, unchanged, for the dict's life.

    sched_stream: the stream `schedule` reads the scalars on (None: the
    current one).

    The future carries the thread's profiling request, which
    `stream_collect` resumes; counter msm_rows.<curve name> counts the
    MSM's rows."""
    sctx, table, _ = stream_table(pk, nm, curve, scalar_bits, device)
    qn = len(getattr(pk, nm))
    on_dev = isinstance(scal_limbs, torch.Tensor)
    if offset is None:
        sl = scal_limbs[:qn] if on_dev else np.ascontiguousarray(
            scal_limbs[:qn])
        if sl.shape[0] != qn:
            raise ValueError(f"stream MSM {nm}: {sl.shape[0]} scalars for "
                             f"{qn} points")
    else:
        sl = scal_limbs if on_dev else np.ascontiguousarray(scal_limbs)
        qn = sl.shape[0]
        if offset < 0 or offset + qn > table.shape[0]:
            raise ValueError(f"stream MSM {nm}: rows [{offset}, "
                             f"{offset + qn}) outside its "
                             f"{table.shape[0]} points")
        table = table[offset:offset + qn]
    count("msm_rows." + curve.name, qn)
    sched = key = None
    if sched_cache is not None:
        seen = (id(scal_limbs), offset, qn, sctx.c, sctx.L)
        key = None if digests is None else digests.get(seen)
        if key is None:
            with span("sched_digest"):
                key = schedule_key(sctx, sl)
            if digests is not None:
                digests[seen] = key
    if key is not None:
        sched = sched_cache.get(key)
    if sched is None:
        sched = schedule(sctx, sl, device, sched_stream)
        if key is not None:
            sched_cache[key] = sched
    return (sctx, sched.act) + sctx.window_sums_async(table, sched) + (
        request_id(),)


def schedule_key(sctx, scal_limbs):
    """The sched_cache key of host limb scalars: (c, L, n, a digest of
    the limbs); None for device limbs, whose schedules are not shared."""
    if isinstance(scal_limbs, torch.Tensor):
        return None
    return (sctx.c, sctx.L, scal_limbs.shape[0], hashlib.blake2b(
        np.ascontiguousarray(scal_limbs).tobytes(), digest_size=16).digest())


def schedule(sctx, scal_limbs, device, stream=None):
    """The schedule of (n, NL) u64 limb scalars (or (n, 10) int32 limbs on
    the device) by `scheduler_tier(device)`: the C++ tier's StreamSchedule,
    or a DevSchedule computed on `device`; counter sched_host or
    sched_device counts it.  The scalars are read on `stream` (None: the
    current stream): on the host path the fetch of device limbs, on the
    device path the upload, P1, its one histogram fetch and the
    placement; the current stream then waits for the placement through an
    event, and the placement's tensors stay reserved for it.  Either
    raises on failure; neither falls back."""
    from ..ops.field import limbs_host

    on_dev = isinstance(scal_limbs, torch.Tensor)
    tier = scheduler_tier(device)
    count("sched_" + tier, 1)
    if tier == "host":
        with span("schedule_host"):
            if on_dev:
                with torch.cuda.stream(stream), span("sched_fetch"):
                    scal_limbs = limbs_host(scal_limbs)
            return sctx.schedule_native(scal_limbs)
    from ..ops.msm_stream_dev import devsched_ctx

    dm = devsched_ctx(sctx.curve, sctx.scalar_bits, sctx.c, sctx.L)
    with span("schedule_device"):
        with torch.cuda.stream(stream):
            if on_dev:
                W = scal_limbs.to(device).contiguous()
            else:
                with span("sched_upload"):
                    W = dm.upload(scal_limbs, device)
            sched = dm.schedule(W)
        if stream is not None:
            cur = torch.cuda.current_stream(device)
            cur.wait_stream(stream)
            for t in sched.tensors or ():
                t.record_stream(cur)
        return sched


def stream_collect(fut):
    """Wait for a dispatched stream MSM and Horner-combine on the host
    over the windows its schedule covers, in the request of its
    dispatch."""
    sctx, act, ws, ev, rid = fut
    with request(rid), span("stream_collect"):
        wsn = sctx.collect(ws, ev)
        with span("horner"):
            return sctx.horner_host(wsn, act)

