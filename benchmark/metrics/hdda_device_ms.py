"""Device ms per frame of the HDDA kernels (``csrc/hdda.cu``), matched
by name in the trace."""


def read(run):
    t = run.trace
    if t is None or t.hdda_kernels == 0:
        return None
    return 1e3 * t.hdda_s / t.frames
