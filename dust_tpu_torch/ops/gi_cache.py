"""Dense GI radiance cache (port of :mod:`dust_tpu.ops.gi_cache`, dense part).

One row per (instance, leaf_row, world face) cell, face-major (``row =
face * cells + cell``), three 32-bit words per row:

    w0 = f16(radiance r) | f16(radiance g) << 16      (ACEScg)
    w1 = f16(radiance b) | sample_count(u16) << 16     (count <= 404)
    w2 = leaf average albedo (R10G10B10A2)

Reads are one row gather; the insert is elementwise because the dense
surfel pass enumerates the rows in order. The table is an int32 tensor
holding the same bits as the reference's. The spatial-hash frame packs
its per-frame working set (one hash probe per cell) into the same rows,
so its ray-side reads are the same gather.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dust_tpu_torch.ops.fp import as_i32, as_u32, bits_f16, f16_bits, fma
from dust_tpu_torch.render.scene import pad_rows_past_dead_zone

__all__ = ["DenseGICache", "make_dense_gi_cache", "dense_rows", "dense_cells",
           "cell_layout", "padded_cells", "dense_index", "dense_get",
           "dense_update", "dense_update_slice", "dense_update_rows",
           "pack_working_set", "albedo_words",
           "pack_working_set_rows", "refresh_dense_albedo",
           "MAX_SAMPLE_COUNT"]

MAX_SAMPLE_COUNT = 404
CELL_PAD = 512


def padded_cells(n: int) -> int:
    """Smallest CELL_PAD multiple strictly above ``n`` (the last row of
    the table is never a real cell)."""
    return (n // CELL_PAD + 1) * CELL_PAD


class DenseGICache(NamedTuple):
    table: torch.Tensor  # (R, 3) int32

    @property
    def radiance(self) -> torch.Tensor:
        w = self.table
        return torch.stack([bits_f16(w[:, 0]), bits_f16(as_u32(w[:, 0]) >> 16),
                            bits_f16(w[:, 1])], dim=-1)

    @property
    def count(self) -> torch.Tensor:
        return (as_u32(self.table[:, 1]) >> 16).float()


def cell_layout(scene) -> tuple[tuple, tuple, int]:
    """Per-instance (cell_base, cell_cap) of the key space and the total."""
    caps = tuple(scene.gi_cell_cap[m] for m in scene.inst_model)
    bases = []
    b = 0
    for c in caps:
        bases.append(b)
        b += c
    return tuple(bases), caps, b


def dense_cells(scene) -> int:
    """Table length in cells (rows / 6), padded as the reference pads it."""
    _, _, total = cell_layout(scene)
    c = padded_cells(total)
    while True:
        c2 = -(-pad_rows_past_dead_zone(c * 6) // 6)
        if c2 == c:
            return c
        c = padded_cells(c2 - 1)


def dense_rows(scene) -> int:
    return dense_cells(scene) * 6


def albedo_words(scene) -> torch.Tensor:
    """(rows,) albedo word per row: the leaf's average albedo for each of
    its 6 faces, zero in the padding."""
    _, caps, _ = cell_layout(scene)
    parts = [scene.avg_albedo[m, :caps[i]]
             for i, m in enumerate(scene.inst_model)]
    alb = torch.cat(parts) if parts else scene.avg_albedo.new_zeros(0)
    pad = dense_cells(scene) - alb.shape[0]
    alb = torch.cat([alb, alb.new_zeros(pad)])
    return alb.repeat(6)


def make_dense_gi_cache(scene) -> DenseGICache:
    alb6 = albedo_words(scene)
    zeros = torch.zeros_like(alb6)
    return DenseGICache(table=torch.stack([zeros, zeros, alb6], dim=-1))


def refresh_dense_albedo(cache: DenseGICache, scene,
                         rows: slice = slice(None)) -> DenseGICache:
    """Every row's albedo word rebuilt from a (refitted) scene, the
    accumulated radiance kept. An edit reorders the edited model's leaf
    rows, so their radiance is keyed to the old order until the running
    mean re-converges, as the reference's spatial hash goes stale on
    edits. ``rows``: the rows of the scene's table that ``cache`` holds
    (a rank's chunk under a mesh)."""
    return DenseGICache(table=torch.stack(
        [cache.table[:, 0], cache.table[:, 1], albedo_words(scene)[rows]],
        dim=-1))


def pack_working_set_rows(radiance, count, albedo_col) -> torch.Tensor:
    """(S, 3) int32 cache rows of probed ``radiance`` (S, 3) and ``count``
    (S,), carrying the (S, 1) int32 albedo column through."""
    cnt = torch.clamp(count, 0, MAX_SAMPLE_COUNT).long()
    w0 = f16_bits(radiance[:, 0]) | (f16_bits(radiance[:, 1]) << 16)
    w1 = f16_bits(radiance[:, 2]) | (cnt << 16)
    return torch.cat([as_i32(w0)[:, None], as_i32(w1)[:, None], albedo_col],
                     dim=-1)


def pack_working_set(radiance, count, scene) -> DenseGICache:
    """The hash frame's working set: one probed radiance and count per
    (instance, leaf, face) row, with the rows' albedo words."""
    return DenseGICache(table=pack_working_set_rows(
        radiance, count, albedo_words(scene)[:, None]))


def dense_index(scene, inst, row, face) -> torch.Tensor:
    """Cache row of a hit. Miss lanes clamp into valid rows (callers gate
    with ``valid``); leaf rows past the instance's cell cap read the zero
    padding tail."""
    bases, caps, _ = cell_layout(scene)
    dev = inst.device
    i = torch.clamp(inst, min=0).long()
    base = torch.tensor(bases, dtype=torch.long, device=dev)[i]
    cap = torch.tensor(caps, dtype=torch.long, device=dev)[i]
    r = torch.clamp(row, min=0).long()
    f = torch.clamp(face, 0, 5).long()
    cells = dense_cells(scene)
    idx = f * cells + base + torch.minimum(r, cap - 1)
    return torch.where(r < cap, idx, cells * 6 - 1)


def dense_get(cache: DenseGICache, idx, valid):
    """Returns (found, radiance_acescg, sample_count, albedo_u32)."""
    rows = as_u32(cache.table[idx])
    count = (rows[..., 1] >> 16).float()
    found = valid & (count > 0)
    radiance = torch.stack([bits_f16(rows[..., 0]), bits_f16(rows[..., 0] >> 16),
                            bits_f16(rows[..., 1])], dim=-1)
    radiance = torch.where(found[..., None], radiance, 0.0)
    return found, radiance, torch.where(found, count, 0.0), rows[..., 2]


def dense_update(cache: DenseGICache, value, valid) -> DenseGICache:
    """Running-mean insert, one value per row (the 404-sample cap of the
    reference's spatial hash); the albedo word is kept."""
    count = cache.count
    c0 = torch.clamp(count, max=float(MAX_SAMPLE_COUNT - 1))
    new_rad = fma(cache.radiance, c0[:, None], value) / (c0 + 1.0)[:, None]
    new_cnt = torch.clamp(count + 1.0, max=float(MAX_SAMPLE_COUNT)).long()
    w0 = f16_bits(new_rad[:, 0]) | (f16_bits(new_rad[:, 1]) << 16)
    w1 = f16_bits(new_rad[:, 2]) | (new_cnt << 16)
    old = cache.table
    new = torch.stack([as_i32(w0), as_i32(w1), old[:, 2]], dim=-1)
    return DenseGICache(table=torch.where(valid[:, None], new, old))


def dense_update_slice(cache: DenseGICache, start: int, value,
                       valid) -> DenseGICache:
    """:func:`dense_update` over the row window ``[start, start+len)``
    (the start clamps so the window fits, like a dynamic slice)."""
    n = value.shape[0]
    start = max(0, min(int(start), cache.table.shape[0] - n))
    sub = dense_update(DenseGICache(table=cache.table[start:start + n]),
                       value, valid)
    table = cache.table.clone()
    table[start:start + n] = sub.table
    return DenseGICache(table=table)


def dense_update_rows(cache: DenseGICache, row0: int, start: int, value,
                      valid) -> DenseGICache:
    """:func:`dense_update_slice` on a chunk of the table: ``cache`` holds
    the global rows [row0, row0 + len), and of the window [start, start +
    len(value)) it updates the rows it holds (the sharded frame's
    budgeted refresh, where the window crosses the ranks' chunks)."""
    rows = cache.table.shape[0]
    a, b = max(start, row0), min(start + value.shape[0], row0 + rows)
    if a >= b:
        return cache
    sub = dense_update(DenseGICache(table=cache.table[a - row0:b - row0]),
                       value[a - start:b - start], valid[a - start:b - start])
    table = cache.table.clone()
    table[a - row0:b - row0] = sub.table
    return DenseGICache(table=table)
