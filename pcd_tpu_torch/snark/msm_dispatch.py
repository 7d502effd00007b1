"""MSM helpers shared by the port's Groth16, GM17 and KZG10 provers: the
counterpart of `pcd_tpu/snark/msm_dispatch.py`, keeping its host-table
marshalling, the host halves of `fb_mul` and `msm_any`, `subrange` and
its stream half (lines 142-286 there).  `stream_launch`, `zpad_query`
and `side_stream` hold the dispatch that the reference's Groth16 and
GM17 provers each write inline.  The device-resident legacy tier
(DevicePointVec, the scan MSM, device fixed-base) is not ported.

SCHEDULER picks who schedules a stream MSM: "host", the C++ tier's
threaded msm_schedule, or "device", DevSchedMSM (ops/msm_stream_dev.py),
where only the scalar limbs cross and the digits, sort and placement run
on the device.  Both schedules feed the same K1 -> K4 -> Horner pipeline;
it replaces the reference's PCD_TPU_DEVSCHED environment variable.

The stream tier runs on the device the prover was built for: on a CUDA
device the kernels of ops/ec.py, on the CPU their plain versions.  Work is
enqueued on the caller's current stream (the prover's side stream); each
future carries the CUDA event recorded after it, and `stream_collect`
waits on that event before it reads the window sums.
"""

from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import torch

from ..utils.profiling import span

# Stream-MSM window bits and accumulator lanes: the reference's values
# (pcd_tpu/ops/msm_stream.py:117), kept as the starting point to measure
# again on the card (PERF.md).  The per-window sums do not depend on L.
WINDOW_BITS = 12
LANES = 8192
# Who schedules the stream MSMs, "host" or "device" (see the module
# docstring).  "host" from the H100 measurements in PERF.md: the device
# schedule cut the schedule spans tenfold, but the warm step's gain stayed
# inside its spread between steps.
SCHEDULER = "host"


def host_query(owner, name: str):
    """owner.<name> is a FIXED host point list consumed by repeated MSMs
    (a pk query table).  Returns a pre-marshalled EncodedPoints cached on
    the owner — the Python-side marshalling of a production-size table
    costs more than the native MSM itself."""
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


def fb_mul(cfg, which: str, scalars, scalar_bits: int):
    """[s_i] G for G = cfg's G1 ("g1") or G2 ("g2") generator on the host:
    the C++ windowed fixed-base from 64 scalars up where it takes the
    curve, else a FixedBaseTable cached on cfg (the host half of the
    reference's fb_mul, msm_dispatch.py:36-61)."""
    from ..msm.host import (FixedBaseTable, _native, _native_curve_ok,
                            fixed_base_many)

    curve = cfg.g1 if which == "g1" else cfg.g2
    base = cfg.g1_gen if which == "g1" else cfg.g2_gen
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


def side_stream(owner, device):
    """Context manager placing work on `owner`'s MSM side stream, made on
    first use (a no-op on the CPU)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    if getattr(owner, "_msm_stream", None) is None:
        owner._msm_stream = torch.cuda.Stream(device)
    return torch.cuda.stream(owner._msm_stream)


def zpad_query(pk, nm: str, n_inst: int, curve) -> str:
    """Name of pk's query `nm` realigned to the full z vector.  A query
    over the witness columns only (z[n_inst:]) gets n_inst
    flagged-infinity rows in front, cached on the pk as `<nm>_zpad`, so
    it shares the schedule of the queries over all of z."""
    if not n_inst:
        return nm
    pad = nm + "_zpad"
    if not hasattr(pk, pad):
        setattr(pk, pad, [curve.infinity()] * n_inst + list(getattr(pk, nm)))
    return pad


def stream_launch(pk, queries, h_curve, scalar_bits: int, z_limbs, device):
    """Build the stream tables of `queries` ((name, curve) pairs) and of
    h_query, then enqueue the queries' MSMs against z_limbs, one shared
    schedule, without waiting.  Returns {name: future}."""
    for nm, curve in tuple(queries) + (("h_query", h_curve),):
        stream_table(pk, nm, curve, scalar_bits, device)
    futs = {}
    sched_cache = {}
    with span("stream_dispatch"):
        for nm, curve in queries:
            futs[nm] = stream_msm_async(pk, nm, curve, scalar_bits, z_limbs,
                                        device, sched_cache=sched_cache)
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
                     device, sched_cache=None, offset=None):
    """Enqueue one query MSM on the stream tier without waiting; returns
    a future for stream_collect.  scal_limbs: (n, NL) u64 canonical limbs
    (truncated to the table length; fewer scalars than points raises).

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
    right only while every caller passes the same z)."""
    sctx, table, _ = stream_table(pk, nm, curve, scalar_bits, device)
    qn = len(getattr(pk, nm))
    if offset is None:
        sl = np.ascontiguousarray(scal_limbs[:qn])
        if sl.shape[0] != qn:
            raise ValueError(f"stream MSM {nm}: {sl.shape[0]} scalars for "
                             f"{qn} points")
    else:
        sl = np.ascontiguousarray(scal_limbs)
        qn = sl.shape[0]
        if offset < 0 or offset + qn > table.shape[0]:
            raise ValueError(f"stream MSM {nm}: rows [{offset}, "
                             f"{offset + qn}) outside its "
                             f"{table.shape[0]} points")
        table = table[offset:offset + qn]
    sched = None
    key = None
    if sched_cache is not None:
        key = (sctx.c, sctx.L, qn, hashlib.blake2b(sl.tobytes(),
                                                   digest_size=16).digest())
        sched = sched_cache.get(key)
    if sched is None:
        sched = schedule(sctx, sl, device)
        if key is not None:
            sched_cache[key] = sched
    return (sctx, sched.act) + sctx.window_sums_async(table, sched)


def schedule(sctx, scal_limbs, device):
    """The schedule of (n, NL) u64 limb scalars by SCHEDULER: the C++
    tier's StreamSchedule, or a DevSchedule computed on `device` (its one
    histogram fetch waits on the caller's current stream, the prover's MSM
    side stream).  Either raises on failure; neither falls back."""
    if SCHEDULER == "host":
        with span("schedule_host"):
            return sctx.schedule_native(scal_limbs)
    if SCHEDULER == "device":
        from ..ops.msm_stream_dev import devsched_ctx

        dm = devsched_ctx(sctx.curve, sctx.scalar_bits, sctx.c, sctx.L)
        with span("schedule_device"):
            return dm.schedule(dm.upload(scal_limbs, device))
    raise ValueError(f"msm_dispatch.SCHEDULER: 'host' or 'device', not "
                     f"{SCHEDULER!r}")


def stream_collect(fut):
    """Wait for a dispatched stream MSM and Horner-combine on the host
    over the windows its schedule covers."""
    sctx, act, ws, ev = fut
    return sctx.horner_host(sctx.collect(ws, ev), act)

