"""The frame statistics on a synthetic window with one stall."""

import pytest

from benchmark import stats


def test_stall_moves_mean_and_p95():
    t0 = 10.0
    steady = [t0 + 0.05 * (k + 1) for k in range(20)]
    times = stats.frame_times(t0, steady)
    assert times == pytest.approx([0.05] * 20)
    assert stats.mean_frame(t0, steady) == pytest.approx(0.05)
    assert stats.p95(times) == pytest.approx(0.05)
    # Frame 11 of 20 stalls for 0.5 s; every later frame ends later.
    stalled = steady[:10] + [t + 0.5 for t in steady[10:]]
    times = stats.frame_times(t0, stalled)
    assert max(times) == pytest.approx(0.55)
    assert stats.mean_frame(t0, stalled) == pytest.approx(1.5 / 20)
    # Sorted, the 95th percentile lies 0.05 of the way from the 19th
    # time (0.05) to the 20th (the stall, 0.55).
    assert stats.p95(times) == pytest.approx(0.05 + 0.05 * 0.5)


def test_p95_interpolates():
    values = [float(v) for v in range(1, 21)]
    assert stats.p95(values) == pytest.approx(19.05)
    assert stats.p95([3.0]) == 3.0
