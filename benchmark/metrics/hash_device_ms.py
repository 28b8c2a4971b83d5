"""Device ms per frame of the spatial hash's kernels
(``csrc/spatial_hash.cu``), matched by ``spatial_hash_`` in their names
in the trace."""

from benchmark import hashwork


def read(run):
    t = run.trace
    s = None if t is None else hashwork.device_s(t)
    return None if s is None else 1e3 * s / t.frames
