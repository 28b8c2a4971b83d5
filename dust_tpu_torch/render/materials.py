"""Per-instance material dispatch (port of
:func:`dust_tpu.render.materials.apply_materials`, palette case).

With every instance on the palette material (type 0) the dispatch is the
identity: ``resolve_hits`` already computed the palette shading. Other
material types are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["apply_materials"]


def apply_materials(g: dict, ids: tuple):
    """Returns ``(g, emissive)``; identity with zero emission when every
    instance uses the palette material."""
    if any(t != 0 for t in ids):
        raise NotImplementedError(
            "non-palette materials are not ported yet (ROADMAP.md Queue 1, "
            "'Materials registry')")
    hit = g["hit"]
    return g, torch.zeros((hit.shape[0], 3), device=hit.device)
