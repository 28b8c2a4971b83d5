"""The frame's HDDA launches' least time (``benchmark.work``: bytes at
3.35 TB/s or operations at 67 TFLOP/s, the larger per launch) over their
device time, %."""


def read(run):
    t = run.trace
    if t is None or t.hdda_s <= 0.0 or run.hdda_least_s is None:
        return None
    return 100.0 * run.hdda_least_s / (t.hdda_s / t.frames)
