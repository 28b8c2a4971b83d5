"""Reservoir packing for weighted reservoir resampling (port of
:mod:`dust_tpu.ops.reservoir`).

Reference: ``assets/shaders/headers/reservoir.glsl``, RTXDI-style
reservoir pack/unpack with an octahedral direction. The frame does not
call it; it is a public part of the package.

Packed layout (``PackedReservoir`` in layout.playout), as four arrays:
  sample_count u16 | direction u32 (oct) | radiance u32 (LogLuv) | weight f32
The two 32-bit words are int64 tensors in [0, 2^32), as
:func:`~dust_tpu_torch.ops.packing.encode_logluv` keeps LogLuv.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dust_tpu_torch.ops.packing import (
    decode_logluv, decode_oct_normal, encode_logluv, encode_oct_normal,
)

__all__ = ["Reservoir", "make_reservoirs", "reservoir_update",
           "pack_reservoir", "unpack_reservoir"]


class Reservoir(NamedTuple):
    sample_count: torch.Tensor  # (N,) int32
    direction: torch.Tensor     # (N, 3) float32 unit
    radiance: torch.Tensor      # (N, 3) float32
    weight_sum: torch.Tensor    # (N,) float32


def make_reservoirs(n: int, device) -> Reservoir:
    return Reservoir(
        sample_count=torch.zeros(n, dtype=torch.int32, device=device),
        direction=torch.zeros((n, 3), device=device),
        radiance=torch.zeros((n, 3), device=device),
        weight_sum=torch.zeros(n, device=device),
    )


def reservoir_update(res: Reservoir, direction, radiance, weight,
                     u) -> Reservoir:
    """Weighted reservoir sampling step: keep the new sample with
    probability weight / (weight_sum + weight); ``u`` uniform in [0,1).
    The test runs in float32, as the reference's."""
    new_sum = res.weight_sum + weight
    take = u * new_sum < weight
    return Reservoir(
        sample_count=res.sample_count + 1,
        direction=torch.where(take[..., None], direction, res.direction),
        radiance=torch.where(take[..., None], radiance, res.radiance),
        weight_sum=new_sum,
    )


def _u16(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> 16-bit code: clamp, then truncate toward zero."""
    return torch.clamp(x * 65535.0, 0.0, 65535.0).long()


def pack_reservoir(res: Reservoir):
    """-> (sample_count clamped to u16 as int32, oct-direction word,
    LogLuv word, weight float32); the words int64 in [0, 2^32)."""
    oct_ = encode_oct_normal(res.direction)
    dir_u = (_u16(oct_[..., 0]) << 16) | _u16(oct_[..., 1])
    return (
        torch.clamp(res.sample_count, 0, 65535),
        dir_u,
        encode_logluv(res.radiance),
        res.weight_sum,
    )


def unpack_reservoir(count, dir_u, rad_u, weight) -> Reservoir:
    dir_u = dir_u.long()
    oct_ = torch.stack([((dir_u >> 16) & 0xFFFF).float() / 65535.0,
                        (dir_u & 0xFFFF).float() / 65535.0], dim=-1)
    return Reservoir(
        sample_count=count.int(),
        direction=decode_oct_normal(oct_),
        radiance=decode_logluv(rad_u),
        weight_sum=weight,
    )
