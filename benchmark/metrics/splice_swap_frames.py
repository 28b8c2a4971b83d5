"""Mean frames from a new-leaf edit's submission to its swap."""


def read(run):
    if not run.splice_swaps:
        return None
    return sum(run.splice_swaps) / len(run.splice_swaps)
