"""Spatio-temporal blue noise tables and the frame's noise fetch.

Port of :mod:`dust_tpu.ops.noise` (the tables are built by the same
numpy code from the port's copies of the same assets; the per-texel
fetch ``BlueNoise.sample``; the host-side ``octant_sort_regions``) plus
the frame's roll-and-tile fetches (``bn_fetch`` / ``bn_fetch_pool`` in
:func:`dust_tpu.render.pipeline.render_frame`). The frame takes all of its noise from these tables; the
port has no random generator.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["BlueNoise", "load_blue_noise", "octant_sort_regions", "bn_fetch",
           "bn_fetch_pool"]

SIZE = 128
LAYERS = 64
_PHI1 = 0.6180339887498949
_PHI2 = (0.7548776662466927, 0.5698402909980532)
_ASSETS = Path(__file__).resolve().parents[1] / "assets"


class BlueNoise:
    """Per-variant (LAYERS, SIZE, SIZE, C) float32 tables in [0,1)."""

    def __init__(self, scalar, vec2, vec3, unitvec2, unitvec3,
                 unitvec3_cosine):
        self.scalar = scalar
        self.vec2 = vec2
        self.vec3 = vec3
        self.unitvec2 = unitvec2
        self.unitvec3 = unitvec3
        self.unitvec3_cosine = unitvec3_cosine

    def sample(self, table: torch.Tensor, pix_xy: torch.Tensor, frame_index,
               offset=(0, 0), rand=0) -> torch.Tensor:
        """texelFetch(blue_noise[v], (pix + offset + rand) % 128, layer).

        ``pix_xy``: (..., 2) integer pixel coords; ``rand`` is the
        per-frame scrambling like push_constants.rand."""
        layer = frame_index % LAYERS
        x = (pix_xy[..., 0] + offset[0] + rand) % SIZE
        y = (pix_xy[..., 1] + offset[1] + rand) % SIZE
        return table[layer, y, x]


def octant_sort_regions(table, rows: int = 8, cols: int = 128) -> torch.Tensor:
    """Reorder each (rows × cols) region of every layer of an encoded
    unit-vector table so its texels are grouped by direction octant
    (a stable lexsort by (sign x, sign y, z)), once, on the host.

    Regions match the HDDA kernel's 8×128-pixel ray tiles, so a tile's
    cosine rays share an octant run. The per-region multiset of values
    is unchanged; the per-pixel temporal sequence is no longer STBN.
    Returns a tensor on ``table``'s device."""
    t = table.cpu().numpy()
    L, H, W, C = t.shape
    out = t.copy()
    for li in range(L):
        for y0 in range(0, H, rows):
            for x0 in range(0, W, cols):
                reg = out[li, y0:y0 + rows, x0:x0 + cols].reshape(-1, C)
                v = reg * 2.0 - 1.0
                key = (v[:, 0] >= 0) * 2 + (v[:, 1] >= 0)
                order = np.lexsort((v[:, 2], key))
                out[li, y0:y0 + rows, x0:x0 + cols] = (
                    reg[order].reshape(rows, cols, C))
    return torch.as_tensor(out, device=table.device)


def _layers(u: np.ndarray, step: float) -> np.ndarray:
    shifts = (np.arange(LAYERS)[:, None, None] * step) % 1.0
    return ((u[None] + shifts) % 1.0).astype(np.float32)


def _stbn_channels():
    path = _ASSETS / "stbn128x64.npy"
    if not path.exists():
        return None
    rank = np.load(path)
    if rank.shape != (LAYERS, SIZE, SIZE):
        return None
    u = (rank.astype(np.float64) + 0.5) / (SIZE * SIZE)
    return [
        u.astype(np.float32),
        np.roll(u, (17, 37, 73), axis=(0, 1, 2)).astype(np.float32),
        np.roll(u, (43, 91, 23), axis=(0, 1, 2)).swapaxes(1, 2)
        .astype(np.float32),
    ]


def load_blue_noise(device) -> BlueNoise:
    stbn = _stbn_channels()
    if stbn is not None:
        u0, u1, u2 = stbn
    else:
        rank = np.load(_ASSETS / "bluenoise128.npy").astype(np.float64)
        base = (rank + 0.5) / rank.size
        chan = [base, np.roll(base, (37, 73), axis=(0, 1)),
                np.roll(base, (91, 23), axis=(0, 1)).T]
        u0 = _layers(chan[0], _PHI1)
        u1 = _layers(chan[1], _PHI2[0])
        u2 = _layers(chan[2], _PHI2[1])

    scalar = u0[..., None]
    vec2 = np.stack([u0, u1], axis=-1)
    vec3 = np.stack([u0, u1, u2], axis=-1)
    theta = 2.0 * np.pi * u1
    unitvec2 = np.stack([np.cos(theta), np.sin(theta)], axis=-1) * 0.5 + 0.5
    z = 2.0 * u0 - 1.0
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    unitvec3 = np.stack([r * np.cos(theta), r * np.sin(theta), z],
                        axis=-1) * 0.5 + 0.5
    cz = np.sqrt(np.maximum(1.0 - u0, 0.0))
    cr = np.sqrt(u0)
    unitvec3_cos = np.stack([cr * np.cos(theta), cr * np.sin(theta), cz],
                            axis=-1) * 0.5 + 0.5

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return BlueNoise(scalar=t(scalar), vec2=t(vec2), vec3=t(vec3),
                     unitvec2=t(unitvec2), unitvec3=t(unitvec3),
                     unitvec3_cosine=t(unitvec3_cos))


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
