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


def test_tail_cells_mean_leaves_out_the_traced_slice():
    """``frame_ms.tail``: untraced, the whole window; traced, the frames
    after the first one past the slice, whose time holds the slice's
    reading."""
    import types

    from benchmark import harness, spec

    read = spec.metric_reader("frame_ms.tail")
    t0, n, slice_frames = 10.0, 30, 6
    ends = [t0 + 0.02 * (k + 1) for k in range(n)]
    cell = types.SimpleNamespace(traffic={"trace_frames": slice_frames})
    run = types.SimpleNamespace(cell=cell, t0=t0, ends=ends, trace=None)
    assert read(run) == pytest.approx(20.0)
    # Traced: the slice's frames take 0.1 s each and the first frame after
    # it 3 s more (the reading); the mean leaves all of that out.
    first = harness.SLICE_START + slice_frames
    traced, t = [], t0
    for k in range(n):
        t += 0.1 if harness.SLICE_START <= k < first else 0.02
        t += 3.0 if k == first else 0.0
        traced.append(t)
    run = types.SimpleNamespace(cell=cell, t0=t0, ends=traced, trace=object())
    assert read(run) == pytest.approx(20.0)
    assert stats.mean_frame(t0, traced) > 0.1
    run.ends = traced[:first + 1]
    assert read(run) is None
