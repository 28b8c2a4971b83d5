"""The 95th percentile of every frame's time in the window, ms."""

from benchmark import stats


def read(run):
    return 1e3 * stats.p95(stats.frame_times(run.t0, run.ends))
