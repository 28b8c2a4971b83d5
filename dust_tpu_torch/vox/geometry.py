"""Leaf attribute unpacking on tensors (port of the device half of
:mod:`dust_tpu.vox.geometry`)."""

from __future__ import annotations

import torch

__all__ = ["unpack_r10g10b10a2"]


def unpack_r10g10b10a2(packed: torch.Tensor) -> torch.Tensor:
    """R10G10B10A2 words ``(r<<22)|(g<<12)|(b<<2)|a`` (any integer dtype
    holding the 32-bit pattern) -> (..., 4) float32 RGBA in [0, 1]."""
    p = packed.long() & 0xFFFFFFFF
    r = ((p >> 22) & 1023).float() / 1023.0
    g = ((p >> 12) & 1023).float() / 1023.0
    b = ((p >> 2) & 1023).float() / 1023.0
    a = (p & 3).float() / 3.0
    return torch.stack([r, g, b, a], dim=-1)
