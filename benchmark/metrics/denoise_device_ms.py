"""Device ms per frame of the denoiser's kernels (``csrc/denoise.cu``:
the temporal step and the à-trous passes), matched by ``denoise_`` in
their names in the trace; None where none ran."""

KERNEL_MARK = "denoise_"


def read(run):
    t = run.trace
    if t is None:
        return None
    times = [s for name, s in t.device_ops.items() if KERNEL_MARK in name]
    return 1e3 * sum(times) / t.frames if times else None
