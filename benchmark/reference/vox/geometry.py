"""Flat per-model geometry: the port's copy of the host half of
:mod:`dust_tpu.vox.geometry` (numpy), and leaf attribute unpacking on
tensors (its device half).

Reference: ``crates/vox/src/geometry.rs`` — per occupied leaf, one AABB
(BLAS input) and one 24-byte ``GPUVoxNode{pos u16x4, mask u64,
material_ptr, avg_albedo}``. Here the "AABB buffer" is replaced by the
dense 64³ ``leaf_grid`` (block → leaf row) from :class:`FlatTree`, and the
GPUVoxNode fields become columnar arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.utils import color as colorlib
from benchmark.reference.voxtree.tree import FlatTree, VoxTree

__all__ = ["VoxGeometry", "build_geometry", "build_geometry_from_flat",
           "pack_avg_albedo", "unpack_r10g10b10a2"]


def pack_avg_albedo(rgba: np.ndarray) -> np.ndarray:
    """Pack float RGBA (sRGB-encoded, 0..1) into R10G10B10A2 as
    ``(r<<22)|(g<<12)|(b<<2)|a`` (geometry.rs:111-117)."""
    rgba = np.asarray(rgba, dtype=np.float64)
    r = (rgba[..., 0] * 1023.0).astype(np.uint32)
    g = (rgba[..., 1] * 1023.0).astype(np.uint32)
    b = (rgba[..., 2] * 1023.0).astype(np.uint32)
    a = (rgba[..., 3] * 3.0).astype(np.uint32)
    return (r << 22) | (g << 12) | (b << 2) | a


def unpack_r10g10b10a2(packed: torch.Tensor) -> torch.Tensor:
    """R10G10B10A2 words ``(r<<22)|(g<<12)|(b<<2)|a`` (any integer dtype
    holding the 32-bit pattern) -> (..., 4) float32 RGBA in [0, 1]."""
    p = packed.long() & 0xFFFFFFFF
    r = ((p >> 22) & 1023).float() / 1023.0
    g = ((p >> 12) & 1023).float() / 1023.0
    b = ((p >> 2) & 1023).float() / 1023.0
    a = (p & 3).float() / 3.0
    return torch.stack([r, g, b, a], dim=-1)


@dataclasses.dataclass
class VoxGeometry:
    """One model's flat geometry + material arrays (all host numpy; the
    scene assembler moves them to device)."""

    flat: FlatTree
    avg_albedo: np.ndarray  # (L,) uint32 R10G10B10A2 per leaf
    materials: np.ndarray  # (M,) uint8 compacted palette indices
    size: tuple[int, int, int]  # model extent in engine orientation
    unit_size: float = 1.0

    @property
    def num_blocks(self) -> int:
        return self.flat.num_leaves


def build_geometry(
    tree: VoxTree,
    materials: np.ndarray,
    block_ptr: np.ndarray,
    palette: np.ndarray,
    size: tuple[int, int, int],
    unit_size: float = 1.0,
) -> VoxGeometry:
    """Assemble flat geometry from a built tree + collector output."""
    tree.set_material_ptrs(block_ptr)
    return build_geometry_from_flat(tree.flatten(), materials, palette, size, unit_size)


def build_geometry_from_flat(
    flat,
    materials: np.ndarray,
    palette: np.ndarray,
    size: tuple[int, int, int],
    unit_size: float = 1.0,
) -> VoxGeometry:
    """Per-leaf attribute pass of ``VoxGeometry::from_tree``
    (geometry.rs:66-127) vectorised over a FlatTree: the average-albedo
    pack — palette u8 RGBA summed over the leaf's voxels, divided by
    255·n, sRGB-OETF'd, packed R10G10B10A2."""
    L = flat.num_leaves

    avg = np.zeros((L, 4), dtype=np.float64)
    if L:
        occ = flat.occupancy_u64()
        # Vectorised popcount: u64 -> 8 bytes -> unpackbits.
        counts = np.unpackbits(
            occ.view(np.uint8).reshape(L, 8), axis=1).sum(
            axis=1).astype(np.int64)
        # Segment-sum palette colors per leaf over the compacted materials.
        starts = flat.material_ptr.astype(np.int64)
        seg_id = np.repeat(np.arange(L), counts)
        # Positions within the materials array: starts[i] .. starts[i]+counts[i]
        offsets = np.arange(len(seg_id)) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        mat_idx = np.repeat(starts, counts) + offsets
        cols = palette[materials[mat_idx].astype(np.int64)].astype(np.float64)
        sums = np.stack(
            [np.bincount(seg_id, weights=cols[:, c], minlength=L)
             for c in range(4)], axis=1)
        avg = sums / (counts[:, None] * 255.0)
        # linear2srgb on rgb only (geometry.rs:103-110)
        avg[:, :3] = colorlib.srgb_oetf_np(avg[:, :3])

    return VoxGeometry(
        flat=flat,
        avg_albedo=pack_avg_albedo(avg),
        materials=np.asarray(materials, dtype=np.uint8),
        size=size,
        unit_size=unit_size,
    )
