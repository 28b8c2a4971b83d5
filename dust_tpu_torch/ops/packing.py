"""Geometric helpers from the shader headers (port of the parts of
:mod:`dust_tpu.ops.packing` the frame uses): cube-face normals and ids,
octahedral normal encoding, and the quaternion rotate of a +z sample
into a normal frame."""

from __future__ import annotations

import torch

__all__ = ["cubed_normalize", "normal_to_face_id", "face_id_to_normal",
           "rotate_vector_by_normal", "encode_oct_normal", "decode_oct_normal",
           "norm3"]


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


def encode_oct_normal(n: torch.Tensor) -> torch.Tensor:
    """Octahedral map of unit vectors to [0, 1]²."""
    n = n / n.abs().sum(dim=-1, keepdim=True)
    wrap = (1.0 - n[..., [1, 0]].abs()) * _sign1(n[..., :2])
    xy = torch.where((n[..., 2] >= 0.0)[..., None], n[..., :2], wrap)
    return xy * 0.5 + 0.5


def decode_oct_normal(p: torch.Tensor) -> torch.Tensor:
    p = p * 2.0 - 1.0
    z = 1.0 - p[..., 0].abs() - p[..., 1].abs()
    t = torch.clamp(-z, 0.0, 1.0)
    xy = p - t[..., None] * _sign1(p)
    n = torch.cat([xy, z[..., None]], dim=-1)
    return n / norm3(n, keepdim=True)
