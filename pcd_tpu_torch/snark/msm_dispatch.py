"""MSM helpers shared by the port's Groth16 and GM17 provers: the
counterpart of `pcd_tpu/snark/msm_dispatch.py`, keeping its host-table
marshalling, the host half of `msm_any` and its stream half (lines
142-286 there).  `stream_launch`, `zpad_query` and `side_stream` hold
the dispatch that the reference's two provers each write inline.  The
device-resident legacy tier (DevicePointVec, the scan MSM, device
fixed-base) and the device-side scheduler are not ported.

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
                     device, sched_cache=None):
    """Enqueue one query MSM on the stream tier without waiting; returns
    a future for stream_collect.  scal_limbs: (n, NL) u64 canonical limbs
    (truncated to the table length; fewer scalars than points raises).

    sched_cache: optional per-prove dict.  The tables flag their
    infinities in-row, so a schedule depends only on the scalars, and the
    a/b1/b2 (+ padded l) MSMs — one z vector against four tables — share
    one schedule and one upload.  The key identifies the scalar vector by
    a digest of its limbs (the reference keys on (c, L, qn) alone, which is
    right only while every caller passes the same z)."""
    sctx, table, _ = stream_table(pk, nm, curve, scalar_bits, device)
    qn = len(getattr(pk, nm))
    sl = np.ascontiguousarray(scal_limbs[:qn])
    if sl.shape[0] != qn:
        raise ValueError(f"stream MSM {nm}: {sl.shape[0]} scalars for "
                         f"{qn} points")
    sched = None
    key = None
    if sched_cache is not None:
        key = (sctx.c, sctx.L, qn, hashlib.blake2b(sl.tobytes(),
                                                   digest_size=16).digest())
        sched = sched_cache.get(key)
    if sched is None:
        sched = sctx.schedule_native(sl)
        if key is not None:
            sched_cache[key] = sched
    return (sctx,) + sctx.window_sums_async(table, sched)


def stream_collect(fut):
    """Wait for a dispatched stream MSM and Horner-combine on the host."""
    sctx, ws, ev = fut
    return sctx.horner_host(sctx.collect(ws, ev))

