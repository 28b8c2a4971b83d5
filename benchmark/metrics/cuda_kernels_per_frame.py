"""Kernels the card ran per frame of the traced slice."""


def read(run):
    t = run.trace
    return None if t is None else t.kernels / t.frames
