"""Float32 helpers that pin rounding where the reference's numerics need it.

The reference runs its float32 math through XLA, which contracts ``a*b +
c`` into one fused multiply-add and rounds ``sqrt`` correctly. Plain
PyTorch rounds the product and the sum separately, and its float32 CPU
``sqrt`` is not always correctly rounded. Where the port must agree with
the reference to the last bit (ray origins and directions that decide
voxel crossings, the packed GI cache), it uses these. The bit helpers
hold unsigned 32-bit words, whose arithmetic torch's ``uint32`` covers
poorly, in int64 masked to 32 bits.
"""

from __future__ import annotations

import torch

__all__ = ["fma", "sqrt", "as_u32", "as_i32", "f16_bits", "bits_f16"]


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) else float(x)


def fma(a, b, c):
    """``a*b + c`` rounded once to float32 (the float32 product is exact
    in float64, so only the final sum rounds twice, which changes the
    result in a vanishing fraction of cases). Any operand but one may be
    a Python number holding a float32 value."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def sqrt(x):
    """Correctly rounded float32 square root (via float64)."""
    return torch.sqrt(x.double()).float()


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The unsigned 32-bit value of an integer tensor's low 32 bits, as
    int64 (torch's uint32 supports few operations)."""
    return x.long() & 0xFFFFFFFF


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding the low 32 bits of ``x`` (two's complement)."""
    return (((x.long() & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).int()


def f16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the float16 bit pattern (round to nearest even), int64."""
    return x.to(torch.float16).view(torch.int16).long() & 0xFFFF


def bits_f16(b: torch.Tensor) -> torch.Tensor:
    """Low 16 bits as a float16 pattern -> float32."""
    b = b.long() & 0xFFFF
    return ((b ^ 0x8000) - 0x8000).to(torch.int16).view(torch.float16).float()
