"""The window's arithmetic: its length and the spread of runs."""

from __future__ import annotations

import statistics


def window(records) -> float:
    """Seconds from the first request's start to the last one's end."""
    return records[-1][1] - records[0][0]


def spread(values) -> float:
    """The distance between the first and third quartile, as a share of
    the median (statistics.quantiles' default method); 0 where the median
    is 0."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else 0.0
