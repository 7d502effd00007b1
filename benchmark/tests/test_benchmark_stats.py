"""The window's arithmetic: its length, the spread of runs, and the
program's nested span totals, each second counted once."""

import os
import statistics
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchlib import registry, stats, trace  # noqa: E402


def test_window_spans_first_start_to_last_end():
    recs = [(10.0, 10.3), (10.3, 10.7), (10.7, 11.5)]
    assert stats.window(recs) == pytest.approx(1.5)


def test_spread_is_iqr_over_median():
    vals = [1.0, 1.1, 0.9, 1.05, 0.95, 1.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


# span totals as the program's profiling.totals() gives them: the full
# name of each span joins its enclosing spans' names with "/"
G16 = {"pcd/main_prove/groth16/witness": (0.5, 1),
       "pcd/main_prove/groth16/h_poly": (0.125, 1),
       "pcd/main_prove/groth16/msm": (0.75, 1),
       "pcd/main_prove/groth16/msm/stream_dispatch_h": (0.25, 1),
       "pcd/help_prove/groth16/msm": (0.0625, 1),
       "stream_dispatch": (0.375, 1)}
GM17 = {"pcd/main_prove/gm17/h_poly": (1.0, 1),
        "pcd/main_prove/gm17/h_poly/hpoly": (0.125, 1),
        "pcd/main_prove/gm17/h_poly/stream_dispatch_h": (0.5, 1),
        "pcd/main_prove/gm17/msm": (0.25, 1)}


@pytest.mark.parametrize("totals, leaves, less, want", [
    # groth16: the h dispatch lies inside */msm and is not counted again
    (G16, ("groth16/msm", "gm17/msm", "stream_dispatch_h"), (), 0.8125),
    (G16, ("groth16/h_poly", "gm17/h_poly"), ("stream_dispatch_h",), 0.125),
    # gm17: the h dispatch lies inside */h_poly: the MSM metric takes it,
    # the quotient's gives it up
    (GM17, ("groth16/msm", "gm17/msm", "stream_dispatch_h"), (), 0.75),
    (GM17, ("groth16/h_poly", "gm17/h_poly"), ("stream_dispatch_h",), 0.5),
    # a leaf nested in another counted leaf counts once
    ({"a": (1.0, 1), "a/b": (0.5, 1), "a/b/b": (0.25, 1)}, ("a", "b"), (),
     1.0),
    # a name that only ends in a leaf's letters is not that leaf
    ({"x/hmsm": (1.0, 1), "x/msm": (0.5, 1)}, ("msm",), (), 0.5),
])
def test_span_sum_counts_each_second_once(totals, leaves, less, want):
    assert trace.span_sum(totals, leaves, less) == pytest.approx(want)


def test_span_readers_partition_the_step():
    """The quotient's and the MSMs' readers share no second, in either
    prover."""
    for totals in (G16, GM17):
        run = types.SimpleNamespace(spans=totals, records=[(0, 1)])
        msm = registry.metric("msm_wait_s").read(run)
        hp = registry.metric("h_poly_s").read(run)
        both = sum(v[0] for k, v in totals.items()
                   if k.endswith(("/msm", "/h_poly")))
        assert msm + hp == pytest.approx(both)


def test_dotted_metric_without_a_file_reads_its_first_part():
    run = types.SimpleNamespace(events={"device": [("k", 0.0, 5e5)]},
                                window_s=2.0)
    assert registry.metric("device_idle.msm").read(run) == pytest.approx(75)
