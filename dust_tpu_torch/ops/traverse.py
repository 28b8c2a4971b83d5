"""The traversal result type and the per-instance ray set-up.

Port of :class:`dust_tpu.ops.traverse.TraceResult` and
:func:`~dust_tpu.ops.traverse.clip_to_model_aabb`, and of the affine
applies the per-instance loop of the scene trace uses
(``pallas_trace._xform_point``/``_xform_dir``). The XLA wavefront
backend of that module (``trace_instance`` / ``trace_scene``, the
``traversal_backend="jnp"`` setting) is not ported yet; the port traces
through :mod:`dust_tpu_torch.ops.hdda`.

These follow the reference's rounding as it runs op by op: products and
sums rounded one at a time, left to right, and the direction length as
``jnp.linalg.norm`` rounds it on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dust_tpu_torch.ops.fp import fma, sqrt

__all__ = ["TraceResult", "xform_point", "xform_dir", "dir_length",
           "clip_to_model_aabb"]


class TraceResult(NamedTuple):
    t: torch.Tensor     # (N,) float32 world-parameter t of the hit, inf on miss
    inst: torch.Tensor  # (N,) int32 instance index, -1 on miss
    row: torch.Tensor   # (N,) int32 leaf row in the model's flat arrays
    bit: torch.Tensor   # (N,) int32 voxel bit (x<<4|y<<2|z), -1 rough, 255 ao

    @property
    def hit(self) -> torch.Tensor:
        return self.inst >= 0


def xform_point(a34, p):
    """(N, 3) points through a (3, 4) affine."""
    x, y, z = p.unbind(-1)
    return torch.stack([a34[k, 0] * x + a34[k, 1] * y + a34[k, 2] * z
                        + a34[k, 3] for k in range(3)], dim=-1)


def xform_dir(a34, d):
    """(N, 3) directions through the linear part of a (3, 4) affine."""
    x, y, z = d.unbind(-1)
    return torch.stack([a34[k, 0] * x + a34[k, 1] * y + a34[k, 2] * z
                        for k in range(3)], dim=-1)


def dir_length(d):
    """``max(|d|, 1e-20)`` of (N, 3) directions, rounded as the
    reference's ``jnp.linalg.norm`` rounds it on the CPU (x² first, then
    y² and z² fused in)."""
    x, y, z = d.unbind(-1)
    return torch.clamp(sqrt(fma(z, z, fma(y, y, x * x))), min=1e-20)


def clip_to_model_aabb(scene, m, o_obj, d_obj, t_min, t_max):
    """Tighten per-ray [t_min, t_max] (N,) to model ``m``'s occupied
    AABB. Rays that miss the box get t_max < t_min."""
    bmin = scene.model_aabb_min[m]
    bmax = scene.model_aabb_max[m]
    dlen = dir_length(d_obj)
    dn = d_obj / dlen[:, None]
    tiny = dn.abs() < 1e-20
    big = torch.where(dn < 0, -1e20, 1e20).to(dn.dtype)
    rcp = torch.where(tiny, big, 1.0 / torch.where(tiny, 1.0, dn))
    t_lo = (bmin - o_obj) * rcp
    t_hi = (bmax - o_obj) * rcp
    enter = torch.minimum(t_lo, t_hi).amax(dim=-1) / dlen
    exit_ = torch.maximum(t_lo, t_hi).amin(dim=-1) / dlen
    return torch.maximum(t_min, enter), torch.minimum(t_max, exit_)
