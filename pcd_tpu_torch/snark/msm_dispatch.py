"""MSM helpers shared by the port's provers: the counterpart of
`pcd_tpu/snark/msm_dispatch.py`, keeping its host-table marshalling and
its stream half (lines 142-286 there).  The device-resident legacy tier
(DevicePointVec, the scan MSM, device fixed-base) and the device-side
scheduler are not ported in this slice.

The stream tier runs on the device the prover was built for: on a CUDA
device the kernels of ops/ec.py, on the CPU their plain versions.  Work is
enqueued on the caller's current stream; each future carries the CUDA
event recorded after it, and `stream_collect` waits on that event before
it reads the window sums.
"""

from __future__ import annotations

import hashlib

import numpy as np

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

