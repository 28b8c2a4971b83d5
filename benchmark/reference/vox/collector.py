"""Per-leaf material compaction (vectorised ModelIndexCollector).

Reference: ``crates/vox/src/collector.rs`` — a dense 256³ u8 grid of
one-based palette indices plus per-4³-block counts; ``into_iter`` turns the
counts into an exclusive prefix sum (each leaf's ``material_ptr``) and
yields the non-zero palette indices in block-linear/bit order.

Block linear order is ``bx + by*64 + bz*64*64`` (collector.rs:33-40) and
the within-block order is the leaf bit index ``(x&3)<<4 | (y&3)<<2 | (z&3)``
— the same order the shader's popcount offset walks
(``primary/hit.rchit:59-71``), which is what makes
``materials[material_ptr + popcount(mask & (bit-1))]`` line up.

The port's copy of :mod:`dust_tpu.vox.collector`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["collect_material_indices"]


def collect_material_indices(coords: np.ndarray, palette_idx: np.ndarray):
    """Compact per-voxel palette indices.

    Args:
      coords: (N,3) int voxel coordinates (already in engine orientation).
      palette_idx: (N,) uint8 palette index per voxel (``voxel.i``).

    Returns:
      ``(materials, block_ptr)`` where ``materials`` is the compacted (N,)
      uint8 array and ``block_ptr`` is the dense 64³ exclusive prefix sum
      indexed by block-linear order — exactly the reference's
      ``running_sum()`` that the loader writes into each leaf's
      ``material_ptr`` (loader.rs:265-273).

    Duplicate coordinates follow last-write-wins like the dense grid in the
    reference.
    """
    coords = np.asarray(coords, dtype=np.int64)
    palette_idx = np.asarray(palette_idx, dtype=np.uint8)
    if coords.shape[0] != palette_idx.shape[0]:
        raise ValueError("coords and palette_idx length mismatch")

    block_lin = (coords[:, 0] >> 2) + (coords[:, 1] >> 2) * 64 + (coords[:, 2] >> 2) * 64 * 64
    bit = ((coords[:, 0] & 3) << 4) | ((coords[:, 1] & 3) << 2) | (coords[:, 2] & 3)
    cell = block_lin * 64 + bit  # dense 256^3 cell in compaction order

    # Last write wins per cell.
    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    keep = np.ones(len(cell_sorted), dtype=bool)
    keep[:-1] = cell_sorted[1:] != cell_sorted[:-1]  # keep last duplicate
    uniq_cells = cell_sorted[keep]
    uniq_vals = palette_idx[order][keep]

    materials = uniq_vals  # already ordered by (block_lin, bit)
    counts = np.zeros(64 * 64 * 64, dtype=np.uint32)
    ublocks, ucounts = np.unique(uniq_cells >> 6, return_counts=True)
    counts[ublocks] = ucounts
    block_ptr = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=block_ptr[1:])
    return materials, block_ptr
