"""The window's mean frame time outside the traced slice, ms: from the
end of the first frame after the slice (its time holds the slice's
reading) to the window's end, over the frames in between; untraced, the
whole window. Per layer in the cells whose end-to-end frame time is its
95th percentile alone."""

from benchmark import harness, stats


def read(run):
    ends = run.ends
    if run.trace is None:
        return 1e3 * stats.mean_frame(run.t0, ends)
    first = harness.SLICE_START + run.cell.traffic["trace_frames"]
    if len(ends) < first + 2:
        return None
    return 1e3 * (ends[-1] - ends[first]) / (len(ends) - 1 - first)
