"""Host ms per window frame inside the harness's calls into the scene
editor (``set_voxels``, ``refit``, ``refit_async``, ``poll_refit``)."""


def read(run):
    if run.cell.traffic["edits"] is None:
        return None
    return 1e3 * run.edit_call_s / run.frames
