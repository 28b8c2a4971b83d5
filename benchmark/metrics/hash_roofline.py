"""The frame's spatial-hash least time (``benchmark.hashwork``: the
probe's and the insert's bytes at 3.35 TB/s) over its kernels' device
time, %."""

from benchmark import hashwork


def read(run):
    t = run.trace
    s = None if t is None else hashwork.device_s(t)
    if not s:
        return None
    return 100.0 * hashwork.least_time_s(run.cell.config) / (s / t.frames)
