"""Runtime calls that hold the host until the device has caught up, per
frame of the traced slice, less the harness's own present (one device
synchronisation a frame)."""


def read(run):
    t = run.trace
    return None if t is None else (t.host_syncs - t.frames) / t.frames
