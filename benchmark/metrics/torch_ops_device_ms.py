"""Device ms per frame of every kernel that is not an HDDA kernel."""


def read(run):
    t = run.trace
    if t is None or t.kernels == t.hdda_kernels:
        return None
    return 1e3 * (t.kernel_s - t.hdda_s) / t.frames
