"""The whole window over the frames completed in it, ms."""

from benchmark import stats


def read(run):
    return 1e3 * stats.mean_frame(run.t0, run.ends)
