"""Colour-space math on tensors, and the host-side numpy pieces.

Port of :mod:`dust_tpu.utils.color`: the matrices are copies of its
numpy constants, :func:`srgb_oetf` its ``srgb_oetf`` on tensors, and
:func:`srgb_oetf_np` the same in numpy (the importer's average-albedo
pack). On tensors, a 3×3 matrix is applied as
three explicit dot products, so no library matrix kernel (and no TF32) is
involved on the card.

Reference: ``assets/shaders/headers/color.glsl`` (the standard
sRGB/ACEScg/XYZ relations, AP1 primaries, D60/D65 adaptation).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SRGB_TO_ACESCG", "ACESCG_TO_SRGB", "XYZ_TO_ACESCG",
           "ACESCG_TO_XYZ", "apply_mat3", "srgb_to_acescg", "acescg_to_srgb",
           "xyz_to_acescg", "acescg_to_xyz", "srgb_eotf", "srgb_oetf",
           "srgb_oetf_np",
           "luminance_rec601"]

# color.glsl sRGB2AECScg / AECScg2sRGB (column-major in GLSL; rows here).
SRGB_TO_ACESCG = np.array(
    [
        [0.6031065, 0.32633433, 0.047995567],
        [0.07011794, 0.9199162, 0.012763573],
        [0.022178888, 0.11607823, 0.94101846],
    ],
    dtype=np.float32,
)
ACESCG_TO_SRGB = np.array(
    [
        [1.7312546, -0.6040432, -0.08010775],
        [-0.131619, 1.1348418, -0.008679431],
        [-0.024568284, -0.12575036, 1.0656371],
    ],
    dtype=np.float32,
)
XYZ_TO_ACESCG = np.array(
    [
        [1.6410228, -0.32480323, -0.23642465],
        [-0.66366285, 1.6153315, 0.016756356],
        [0.011721907, -0.0082844375, 0.9883947],
    ],
    dtype=np.float32,
)
ACESCG_TO_XYZ = np.array(
    [
        [0.66245437, 0.13400422, 0.15618773],
        [0.2722288, 0.6740818, 0.05368953],
        [-0.0055746622, 0.00406073, 1.0103393],
    ],
    dtype=np.float32,
)


def apply_mat3(v: torch.Tensor, m) -> torch.Tensor:
    """``m @ v`` over the last axis of ``v`` for a 3×3 numpy matrix."""
    rows = [v[..., 0] * float(m[i][0]) + v[..., 1] * float(m[i][1])
            + v[..., 2] * float(m[i][2]) for i in range(3)]
    return torch.stack(rows, dim=-1)


def srgb_to_acescg(v):
    return apply_mat3(v, SRGB_TO_ACESCG)


def acescg_to_srgb(v):
    return apply_mat3(v, ACESCG_TO_SRGB)


def xyz_to_acescg(v):
    return apply_mat3(v, XYZ_TO_ACESCG)


def srgb_eotf(c):
    """sRGB-encoded -> linear."""
    return torch.where(c < 0.04045, c / 12.92,
                       ((c.abs() + 0.055) / 1.055) ** 2.4)


def srgb_oetf_np(c: np.ndarray) -> np.ndarray:
    """Linear -> sRGB-encoded, numpy (the importer's linear2srgb in
    crates/vox/src/geometry.rs:103-110)."""
    c = np.asarray(c)
    return np.where(c <= 0.0031308, 12.92 * c,
                    1.055 * np.maximum(c, 1e-12) ** (1.0 / 2.4) - 0.055)


def luminance_rec601(rgb):
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
