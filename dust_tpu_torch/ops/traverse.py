"""The traversal result type shared by every trace entry point.

Port of :class:`dust_tpu.ops.traverse.TraceResult`. The XLA wavefront
backend of that module (``trace_instance`` / ``trace_scene``, the
``traversal_backend="jnp"`` setting) is not ported yet; the port traces
through :mod:`dust_tpu_torch.ops.hdda`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TraceResult"]


class TraceResult(NamedTuple):
    t: torch.Tensor     # (N,) float32 world-parameter t of the hit, inf on miss
    inst: torch.Tensor  # (N,) int32 instance index, -1 on miss
    row: torch.Tensor   # (N,) int32 leaf row in the model's flat arrays
    bit: torch.Tensor   # (N,) int32 voxel bit (x<<4|y<<2|z), -1 rough, 255 ao

    @property
    def hit(self) -> torch.Tensor:
        return self.inst >= 0
