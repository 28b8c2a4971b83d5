"""The 95th percentile over every edit submitted in the window of the
time to the end of the first frame rendered from a scene holding it."""

from benchmark import stats


def read(run):
    if not run.edit_latencies_s:
        return None
    return 1e3 * stats.p95(run.edit_latencies_s)
