"""The benchmark's statistics of a window: each frame's time, the mean
frame time and the 95th percentile."""

from __future__ import annotations

import statistics


def frame_times(t0: float, ends: list[float]) -> list[float]:
    """Each frame's time: from the end of the frame before (the window's
    start for the first) to its own end."""
    out, prev = [], t0
    for t in ends:
        out.append(t - prev)
        prev = t
    return out


def mean_frame(t0: float, ends: list[float]) -> float:
    """The whole window over the frames completed in it."""
    return (ends[-1] - t0) / len(ends)


def p95(values: list[float]) -> float:
    """The 95th percentile of every value, interpolated between the two
    nearest ranks (``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]
