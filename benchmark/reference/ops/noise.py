"""The frame's blue-noise fetches: a layer of a (64, 128, 128, C) table,
shifted by a per-frame hash and tiled over the image or the surfel pool
(``bn_fetch`` / ``bn_fetch_pool``). The frame takes all of its noise
from these tables; it has no random generator.
"""

from __future__ import annotations

import torch

__all__ = ["bn_fetch", "bn_fetch_pool"]


def _rolled_page(table, layer: int, offset, rand: int):
    th, tw = table.shape[1], table.shape[2]
    sy = (offset[1] + rand) % th
    sx = (offset[0] + rand) % tw
    return torch.roll(table[layer], shifts=(-sy, -sx), dims=(0, 1))


def bn_fetch(table, layer: int, offset, rand: int, height: int,
             width: int) -> torch.Tensor:
    """(H, W, C) image of ``table[layer, (py+oy+rand)%S, (px+ox+rand)%S]``:
    the layer, shifted and tiled periodically."""
    page = _rolled_page(table, layer, offset, rand)
    th, tw = page.shape[:2]
    reps_y, reps_x = -(-height // th), -(-width // tw)
    return page.repeat(reps_y, reps_x, 1)[:height, :width]


def bn_fetch_pool(table, layer: int, offset, rand: int, p: int):
    """(p, C) noise per pool slot; slot i reads texel (i % W, i // W % H)
    of the shifted layer."""
    page = _rolled_page(table, layer, offset, rand)
    th, tw = page.shape[:2]
    flat = page.reshape(th * tw, -1)
    reps = -(-p // (th * tw))
    return flat.repeat(reps, 1)[:p]
