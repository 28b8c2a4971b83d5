"""The share of the traced slice's wall time in which no kernel or copy
ran on the card, %."""


def read(run):
    t = run.trace
    if t is None or t.wall_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
