"""HDDA launches per frame of the traced slice, from the port's own
counter (``ops.hdda.LAUNCHES``)."""


def read(run):
    t = run.trace
    return None if t is None else run.hdda_launches / t.frames
