"""Colour-space math on tensors.

Port of the device half of :mod:`dust_tpu.utils.color` (the matrices are
the same numpy constants, imported from there). A 3×3 matrix is applied
as three explicit dot products, so no library matrix kernel (and no
TF32) is involved on the card.
"""

from __future__ import annotations

import torch

from dust_tpu.utils.color import ACESCG_TO_SRGB, SRGB_TO_ACESCG, XYZ_TO_ACESCG

__all__ = ["apply_mat3", "srgb_to_acescg", "acescg_to_srgb",
           "xyz_to_acescg", "srgb_eotf", "luminance_rec601"]


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


def luminance_rec601(rgb):
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
