"""The port's span records, requests, counters and shared clock
(pcd_tpu_torch/utils/profiling.py), and the spans of the stream MSM's
schedule, upload and collect on a toy stream MSM on the CPU: records
nest with their parents and requests, totals keep their "/"-joined
names, nothing is kept with recording off, the cap counts what it drops,
threads keep their own parents, one request runs from `stream_launch`
through the h dispatch to every collect, the counter h2d_bytes is the
schedule arrays' bytes and msm_rows.<curve> the MSMs' rows, the leaf
spans tile the dispatch, and the anchor maps the records onto a
torch.profiler trace's annotations."""

import json
import statistics
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu_torch.curves import models as TM  # noqa: E402
from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch as md  # noqa: E402
from pcd_tpu_torch.utils import profiling  # noqa: E402
from pcd_tpu_torch.utils.profiling import span  # noqa: E402

CPU = torch.device("cpu")
DISPATCH_LEAVES = {"sched_digest", "sched_upload", "launch"}
SCHEDULE_LEAVES = {"sched_fetch", "sched_fit", "sched_alloc", "sched_place",
                   "sched_finish"}


@pytest.fixture
def rec():
    """Recording on, from a reset; off and reset afterwards."""
    profiling.enable()
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def _tree():
    with span("a"):
        with span("b"):
            with span("c"):
                pass
        with span("b"):
            pass
    with span("d"):
        pass


def test_records_nest_with_parents(rec):
    _tree()
    rs = rec.records()
    assert [r.name for r in rs] == ["a", "b", "c", "b", "d"]
    assert [r.parent for r in rs] == [None, 0, 1, 0, None]
    assert all(r.start_ns <= r.end_ns for r in rs)
    for r in rs:
        if r.parent is not None:
            up = rs[r.parent]
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
    assert len({r.thread for r in rs}) == 1
    assert rec.dropped() == 0


def test_totals_keep_joined_names(rec):
    _tree()
    tot = rec.totals()
    assert set(tot) == {"a", "a/b", "a/b/c", "d"}
    assert tot["a/b"][1] == 2 and tot["a"][1] == 1
    assert tot["a"][0] >= tot["a/b"][0] >= tot["a/b/c"][0] >= 0


@pytest.mark.parametrize("what", ["span", "count"])
def test_off_keeps_nothing(what):
    profiling.enable(False)
    profiling.reset()
    if what == "span":
        _tree()
    else:
        profiling.count("h2d_bytes", 123)
    assert profiling.records() == [] and profiling.totals() == {}
    assert profiling.counters() == {} and profiling.anchor() is None


def test_reset_clears_records_counters_and_anchor(rec, tmp_path):
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        _tree()
        rec.count("h2d_bytes", 7)
        first = rec.anchor()
        assert first is not None and rec.counters() == {"h2d_bytes": 7}
        rec.reset()
        assert rec.records() == [] and rec.counters() == {}
        assert rec.totals() == {} and rec.anchor() is None
        _tree()
        assert rec.anchor() is not None and rec.anchor() > first


def test_cap_counts_drops(rec, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    _tree()
    assert [r.name for r in rec.records()] == ["a", "b", "c"]
    assert rec.dropped() == 2
    assert rec.totals()["d"][1] == 1          # totals keep every span


def test_threads_keep_their_own_parents(rec):
    go = threading.Barrier(2)

    def work(tag):
        with span("outer_" + tag):
            go.wait(timeout=10)
            with span("inner_" + tag):
                go.wait(timeout=10)

    ts = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    rs = rec.records()
    assert len(rs) == 4
    for r in rs:
        if r.name.startswith("inner_"):
            up = rs[r.parent]
            assert up.name == "outer_" + r.name[-1]
            assert up.thread == r.thread
    assert len({r.thread for r in rs}) == 2


def test_requests_held_opened_and_carried(rec):
    out = {}

    @profiling.request()
    def step():
        out["step"] = profiling.request_id()
        assert profiling.open_request() == out["step"]     # held: kept
        t = threading.Thread(target=profiling.in_request(
            lambda: out.setdefault("thread", profiling.request_id())))
        t.start()
        t.join(timeout=10)

    step()
    first = out["step"]
    step()
    assert out["step"] != first and out["thread"] == first
    a = profiling.open_request()
    assert profiling.request_id() == a and profiling.open_request() != a
    with profiling.request(a):
        with span("s"):
            pass
    assert rec.records()[-1].request == a


# -- the stream MSM on the CPU ---------------------------------------------
def _batch(pk, g1, bits, z, h):
    """One batch as the benchmark's msm_batch drives it: the z queries'
    launch, the h dispatch, then every collect."""
    futs = md.stream_launch(pk, (("a_query", g1),), g1, bits, z, CPU)
    with span("stream_dispatch_h"):
        futs["h_query"] = md.stream_msm_async(pk, "h_query", g1, bits, h,
                                              CPU)
    return futs, {k: md.stream_collect(f) for k, f in futs.items()}


@pytest.fixture(scope="module")
def toy_msm():
    """Two batches of a toy a/h stream MSM (c = 6 on 128 lanes), recorded:
    {"records", "counters", "futs", "got", "want", "sched_bytes"}."""
    cyc = TM.toy_cycle().main
    g1, bits, r = cyc.g1, cyc.Fr.BITS, cyc.Fr.MODULUS
    pts, cur = [], cyc.g1_gen
    for _ in range(96):
        pts.append(cur)
        cur = cur + cyc.g1_gen
    pk = SimpleNamespace(a_query=list(pts), h_query=list(pts[:64]))
    rng = np.random.default_rng(17)
    zs = [int(x) % r for x in rng.integers(0, 1 << 62, size=96)]
    hs = [int(x) % r for x in rng.integers(0, 1 << 62, size=64)]
    z = StreamMSMCtx.limb_rows(zs, 40)
    h = torch.from_numpy(StreamMSMCtx.limb_rows(hs, 40).view(np.int32)
                         .copy())
    saved = md.WINDOW_BITS, md.LANES
    md.WINDOW_BITS, md.LANES = 6, 128
    profiling.enable()
    profiling.reset()
    try:
        runs = [_batch(pk, g1, bits, z, h) for _ in range(2)]
        out = {"records": profiling.records(),
               "counters": profiling.counters()}
        sctx = md.stream_table(pk, "a_query", g1, bits, CPU)[0]
        out["sched_bytes"] = sum(
            sum(np.asarray(a).nbytes for a in (s.perm, s.loads, s.bidx,
                                               s.runrem))
            for s in (sctx.schedule_native(z),
                      sctx.schedule_native(h.numpy().view("<u8"))))
    finally:
        profiling.enable(False)
        profiling.reset()
        md.WINDOW_BITS, md.LANES = saved
    out["futs"] = [f for f, _ in runs]
    out["got"] = [g for _, g in runs]
    out["want"] = {
        "a_query": sum((p * s for p, s in zip(pts, zs)), g1.infinity()),
        "h_query": sum((p * s for p, s in zip(pts, hs)), g1.infinity())}
    return out


def test_toy_msm_results(toy_msm):
    assert all(g == toy_msm["want"] for g in toy_msm["got"])


def test_request_runs_from_launch_to_collect(toy_msm):
    rs = toy_msm["records"]
    roots = [r for r in rs if r.parent is None]
    assert [r.name for r in roots] == (
        ["stream_dispatch", "stream_dispatch_h"] + ["stream_collect"] * 2) * 2
    ids = [r.request for r in roots]
    assert ids[:4] == [ids[0]] * 4 and ids[4:] == [ids[4]] * 4
    assert ids[0] is not None and ids[0] != ids[4]
    assert all(r.request == rs[r.parent].request for r in rs
               if r.parent is not None)
    for futs, rid in zip(toy_msm["futs"], (ids[0], ids[4])):
        assert {f[-1] for f in futs.values()} == {rid}


def test_h2d_bytes_is_the_schedules_bytes(toy_msm):
    # a batch uploads z's shared schedule once and h's once, both made by
    # the C++ tier (the default scheduler of a CPU table): two batches,
    # four schedules; and the MSMs' rows, 96 of a and 64 of h a batch
    rows = "msm_rows." + TM.toy_cycle().main.g1.name
    assert toy_msm["counters"] == {"h2d_bytes": 2 * toy_msm["sched_bytes"],
                                   "sched_host": 4, rows: 2 * (96 + 64)}


def _leaves(rs, i):
    """Indices of the leaf records below record i."""
    kids = [j for j, r in enumerate(rs) if r.parent == i]
    return [i] if not kids else [x for j in kids for x in _leaves(rs, j)]


@pytest.mark.parametrize("root, leaves, share", [
    ("stream_dispatch", DISPATCH_LEAVES | SCHEDULE_LEAVES - {"sched_fetch"},
     0.95),
    ("stream_dispatch_h", {"sched_upload", "launch"} | SCHEDULE_LEAVES, 0.95),
    # a toy collect takes about half a millisecond, in which the spans'
    # own few microseconds weigh: its share is measured on the card
    ("stream_collect", {"collect_wait", "collect_fetch", "horner"}, 0.0),
])
def test_leaf_spans_tile_their_root(toy_msm, root, leaves, share):
    """Below each root the leaves are the named spans, one after another,
    covering `share` of the root's time or more; schedule_host's children
    come in the schedule's order."""
    rs = toy_msm["records"]
    for i, r in enumerate(rs):
        if r.name != root:
            continue
        below = [rs[j] for j in _leaves(rs, i)]
        assert {x.name for x in below} == leaves
        for a, b in zip(below, below[1:]):
            assert a.end_ns <= b.start_ns
        assert sum(x.end_ns - x.start_ns for x in below) >= share * (
            r.end_ns - r.start_ns)
        for j, k in enumerate(rs):
            if k.name == "schedule_host" and k.parent == i:
                assert [x.name for x in rs if x.parent == j] == [
                    n for n in ("sched_fetch", "sched_fit", "sched_alloc",
                                "sched_place", "sched_finish")
                    if n in leaves]


# -- the shared clock ------------------------------------------------------
def _annotations(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_anchor_none_without_profiler(rec):
    _tree()
    assert rec.anchor() is None and len(rec.records()) == 5


def test_anchor_one_marker_a_reset(rec, tmp_path):
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        _tree()
        _tree()
        rec.reset()
        _tree()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    marks = [e for e in _annotations(tmp_path / "t.json")
             if e["name"] == profiling.ANCHOR]
    assert len(marks) == 2


def test_records_map_onto_their_profiler_twins(rec, tmp_path):
    """100 spans, each with a record_function twin of its name (as the
    benchmark's annotations open them): mapped through the anchor, the
    records' starts land a median under 100 us from their twins'."""
    rf = torch.profiler.record_function
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(100):
            with span(f"s{i}"), rf(f"s{i}"):
                sum(range(2000))
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    ev = _annotations(tmp_path / "t.json")
    mark = [e["ts"] for e in ev if e["name"] == profiling.ANCHOR]
    twin = {e["name"]: e["ts"] for e in ev}
    assert len(mark) == 1
    rs = rec.records()
    assert len(rs) == 100
    off = [abs(mark[0] + (r.start_ns - rec.anchor()) / 1e3 - twin[r.name])
           for r in rs]
    assert statistics.median(off) < 100.0
