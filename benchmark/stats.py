"""The arithmetic of the end-to-end metrics and of their spread."""

from __future__ import annotations

import statistics


def rate(units: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return units / seconds


def p95(times: list[float]) -> float:
    """95th percentile of all the times, linear between the two nearest
    ranks (`statistics.quantiles`, inclusive method)."""
    if len(times) < 2:
        raise ValueError(f"a tail needs at least two times, got {len(times)}")
    return statistics.quantiles(times, n=100, method="inclusive")[94]


def spread(values: list[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (`statistics.quantiles(values, n=4)`, its default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def trimmed_spread(values: list[float]) -> float:
    """`spread` with the value farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread(values[:far] + values[far + 1:])
