"""Packing and geometric helpers from the shader headers (port of
:mod:`dust_tpu.ops.packing`): the 32-bit LogLuv radiance word of the
spatial hash, the NRD (REBLUR) YCoCg radiance + hit-distance pack and
normal + roughness pack, cube-face normals and ids, octahedral normal
encoding, and the quaternion rotate of a +z sample into a normal
frame."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.ops.fp import fma
from benchmark.reference.utils import color as colorlib

__all__ = ["encode_logluv", "decode_logluv",
           "pack_radiance_hitdist", "unpack_radiance_hitdist",
           "linear_to_ycocg", "ycocg_to_linear",
           "encode_oct_normal", "decode_oct_normal",
           "pack_normal_roughness", "unpack_normal_roughness",
           "cubed_normalize", "normal_to_face_id", "face_id_to_normal",
           "rotate_vector_by_normal", "norm3"]

NRD_FP16_MIN = 1e-7

# float32 ln 2: the reference lowers log2(x) to log(x) / ln 2 and
# exp2(x) to exp(x * ln 2).
_LN2 = float(np.float32(math.log(2.0)))


def _f32(x: float) -> float:
    return float(np.float32(x))


# The reference's compiler folds each division by a constant into a
# product with the float32 reciprocal, and a constant factor into it.
_INV_409_6 = _f32(1.0 / np.float32(409.6))
_U_SCALE = {k: _f32(np.float32(k) * np.float32(1.0 / np.float32(820.0)))
            for k in (4, 6, 9, 16)}


def _mat3_fma(v: torch.Tensor, m) -> torch.Tensor:
    """``m @ v`` over the last axis, rounded as the reference's float32
    dot on the CPU: ``fma(v2, m2, fma(v1, m1, v0 * m0))`` per row."""
    v0, v1, v2 = v.unbind(-1)
    rows = [fma(v2, _f32(m[i][2]), fma(v1, _f32(m[i][1]), v0 * _f32(m[i][0])))
            for i in range(3)]
    return torch.stack(rows, dim=-1)


def encode_logluv(color: torch.Tensor) -> torch.Tensor:
    """ACEScg RGB (..., 3) -> 32-bit LogLuv word, as int64 in [0, 2^32):
    14-bit log luminance << 18 | 9-bit u << 9 | 9-bit v
    (spatial_hash.glsl:28-60)."""
    xyz = _mat3_fma(color, colorlib.ACESCG_TO_XYZ)
    x, y, z = xyz.unbind(-1)
    log_y = 409.6 * (torch.log(torch.clamp(y, min=1e-30)) / _LN2 + 20.0)
    le = torch.clamp(log_y, 0.0, 16383.0).long()
    denom = fma(3.0, (x + y) + z, fma(12.0, y, -2.0 * x))
    inv_denom = 1.0 / torch.clamp(denom, min=1e-30)
    ue = torch.clamp(820.0 * (4.0 * x * inv_denom), 0.0, 511.0).long()
    ve = torch.clamp(820.0 * (9.0 * y * inv_denom), 0.0, 511.0).long()
    packed = (le << 18) | (ue << 9) | ve
    return torch.where(le == 0, 0, packed)


def decode_logluv(packed: torch.Tensor) -> torch.Tensor:
    """32-bit LogLuv word (any integer dtype; the low 32 bits) -> ACEScg
    RGB (..., 3) float32 (spatial_hash.glsl:64-93), with the reference's
    folded constants; its XYZ -> ACEScg product unrolls into
    ``fma(Z, m2, fma(X, m0, Y * m1))``."""
    packed = packed.long() & 0xFFFFFFFF
    le = packed >> 18
    y = torch.exp((fma(le.float() + 0.5, _INV_409_6, -20.0)) * _LN2)
    ua = ((packed >> 9) & 0x1FF).float() + 0.5
    va = (packed & 0x1FF).float() + 0.5
    inv_denom = 1.0 / (fma(ua, _U_SCALE[6], -(va * _U_SCALE[16])) + 12.0)
    x_c = ua * _U_SCALE[9] * inv_denom
    y_c = va * _U_SCALE[4] * inv_denom
    s = y / torch.clamp(y_c, min=1e-9)
    big_x = s * x_c
    big_z = s * ((1.0 - x_c) - y_c)
    m = colorlib.XYZ_TO_ACESCG
    rgb = torch.stack([fma(big_z, _f32(m[i][2]),
                           fma(big_x, _f32(m[i][0]), y * _f32(m[i][1])))
                       for i in range(3)], dim=-1)
    return torch.where((le == 0)[..., None], 0.0, torch.clamp(rgb, min=0.0))


def norm3(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean length over the last axis."""
    return torch.sqrt((v * v).sum(dim=-1, keepdim=keepdim))


def _sign1(x):
    """+1 where ``x >= 0`` else -1."""
    return torch.where(x >= 0.0, 1.0, -1.0)


def cubed_normalize(d: torch.Tensor) -> torch.Tensor:
    """Dominant-axis cube-face normal (ties keep every tied axis)."""
    a = d.abs()
    m = a.amax(dim=-1, keepdim=True)
    return torch.sign(d) * (a >= m).to(d.dtype)


def normal_to_face_id(n: torch.Tensor) -> torch.Tensor:
    """Axis-aligned unit normal -> face id in [0, 6): bit 0 = positive,
    bits 1-2 = axis."""
    s = torch.clamp(n.sum(dim=-1), 0.0, 1.0)
    face = torch.round(s).int()
    face = face + torch.round(n[..., 2].abs()).int() * 4
    return face + torch.round(n[..., 1].abs()).int() * 2


def face_id_to_normal(face: torch.Tensor) -> torch.Tensor:
    s = (face & 1).float() * 2.0 - 1.0
    axis = face >> 1
    return s[..., None] * torch.stack(
        [axis == 0, axis == 1, axis == 2], dim=-1).float()


def rotate_vector_by_normal(normal: torch.Tensor,
                            target: torch.Tensor) -> torch.Tensor:
    """Rotate ``target`` from the +z frame into the ``normal`` frame via
    the shortest-arc quaternion (normal.glsl rotateVectorByNormal)."""
    nx, ny, nz = normal.unbind(-1)
    q = torch.stack([-ny, nx, torch.zeros_like(nx), 1.0 + nz], dim=-1)
    q = q / torch.sqrt((q * q).sum(dim=-1, keepdim=True))
    degenerate = (nz < -0.99999)[..., None]
    q = torch.where(degenerate, q.new_tensor([-1.0, 0.0, 0.0, 0.0]), q)
    qv, qw = q[..., :3], q[..., 3]
    dot_qt = (qv * target).sum(dim=-1, keepdim=True)
    cross = torch.linalg.cross(qv, target, dim=-1)
    return (2.0 * dot_qt * qv
            + (qw * qw - (qv * qv).sum(dim=-1))[..., None] * target
            + 2.0 * qw[..., None] * cross)


def encode_oct_normal(n: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """Octahedral map of unit vectors to [0, 1]² (``signed``: [-1, 1]²).
    The L1 norm adds x, y, z in that order: a reduction kernel on the
    card may pair them otherwise, which moves the result by an ulp."""
    a = n.abs()
    n = n / ((a[..., 0:1] + a[..., 1:2]) + a[..., 2:3])
    wrap = (1.0 - n[..., [1, 0]].abs()) * _sign1(n[..., :2])
    xy = torch.where((n[..., 2] >= 0.0)[..., None], n[..., :2], wrap)
    return xy if signed else xy * 0.5 + 0.5


def decode_oct_normal(p: torch.Tensor, signed: bool = False,
                      normalize: bool = True) -> torch.Tensor:
    p = p if signed else p * 2.0 - 1.0
    z = 1.0 - p[..., 0].abs() - p[..., 1].abs()
    t = torch.clamp(-z, 0.0, 1.0)
    xy = p - t[..., None] * _sign1(p)
    n = torch.cat([xy, z[..., None]], dim=-1)
    return n / norm3(n, keepdim=True) if normalize else n


