"""Camera: settings, ray generation, projection matrices.

Port of :mod:`dust_tpu.ops.camera`. The host-side bakes (look-at,
projection, view-projection) stay in numpy; the per-frame uniform is a
tuple of tensors on the frame's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dust_tpu_torch.ops import gbuffer

__all__ = ["CameraSettings", "camera_settings", "camera_ray_dirs", "look_at",
           "perspective_infinite_reverse", "primary_rays",
           "primary_rays_plain", "check_ray_range"]


class CameraSettings(NamedTuple):
    view_cols: torch.Tensor     # (3,3) camera-to-world rotation (columns)
    position: torch.Tensor      # (3,)
    tan_half_fov: torch.Tensor  # ()
    near: torch.Tensor          # ()
    far: torch.Tensor           # ()
    view_proj: torch.Tensor     # (4,4) world -> clip (infinite reverse-Z)


def perspective_infinite_reverse(fov_y: float, aspect: float,
                                 near: float) -> np.ndarray:
    f = 1.0 / math.tan(fov_y / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = 0.0
    m[2, 3] = near
    m[3, 2] = -1.0
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world affine looking down -Z at ``target``."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    a = np.eye(4, dtype=np.float64)
    a[:3, 0] = right
    a[:3, 1] = true_up
    a[:3, 2] = -fwd
    a[:3, 3] = eye
    return a.astype(np.float32)


def camera_settings(camera_to_world: np.ndarray, fov: float, near: float,
                    far: float, width: int, height: int,
                    device) -> CameraSettings:
    c2w = np.asarray(camera_to_world, np.float64)
    proj = perspective_infinite_reverse(fov, width / height,
                                        near).astype(np.float64)
    view_proj = proj @ np.linalg.inv(c2w)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return CameraSettings(view_cols=t(c2w[:3, :3]), position=t(c2w[:3, 3]),
                          tan_half_fov=t(math.tan(fov / 2.0)), near=t(near),
                          far=t(far), view_proj=t(view_proj))


def camera_ray_dirs(cam: CameraSettings, width: int,
                    height: int) -> torch.Tensor:
    """(H, W, 3) world-space ray directions, not normalised."""
    dev = cam.position.device
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
    v, u = torch.meshgrid(py, px, indexing="ij")
    cx = (2.0 * u - 1.0) * (width / height) * cam.tan_half_fov
    cy = (1.0 - 2.0 * v) * cam.tan_half_fov
    m = cam.view_cols
    return torch.stack([m[i, 0] * cx + m[i, 1] * cy - m[i, 2]
                        for i in range(3)], dim=-1)


def primary_rays_plain(cam: CameraSettings, width: int, height: int,
                       tiled: bool, lo: int, hi: int):
    """The plain version of :func:`primary_rays`."""
    d = camera_ray_dirs(cam, width, height)
    if tiled:
        d = torch.movedim(d.reshape(height // 8, 8, width // 128, 128, 3),
                          2, 0)
    return (cam.position.expand(hi - lo, 3).contiguous(),
            d.reshape(width * height, 3)[lo:hi])


def check_ray_range(width: int, height: int, tiled: bool, lo: int,
                    hi: int):
    """Raise ``ValueError`` unless ``[lo, hi)`` are rays of the image and,
    with ``tiled``, the image divides into 8×128-pixel tiles."""
    n = width * height
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"rays [{lo}, {hi}) of {n}")
    if tiled and (height % 8 or width % 128):
        raise ValueError(f"{width}x{height} does not divide into 8x128 "
                         "tiles")


def primary_rays(cam: CameraSettings, width: int, height: int, tiled: bool,
                 lo: int = 0, hi: int | None = None):
    """The camera rays ``[lo, hi)`` of the image (default: all of them) in
    the order the trace takes them: with ``tiled``, 8×128-pixel tiles
    (the image must divide into them), raster order otherwise. Returns
    (origins, directions), each (hi - lo, 3) float32: the camera position
    and :func:`camera_ray_dirs`' directions.

    CPU tensors run :func:`primary_rays_plain`; CUDA tensors launch
    ``primary_rays_kernel`` (:mod:`dust_tpu_torch.ops.gbuffer`)."""
    hi = width * height if hi is None else hi
    check_ray_range(width, height, tiled, lo, hi)
    if cam.position.device.type == "cpu":
        return primary_rays_plain(cam, width, height, tiled, lo, hi)
    return gbuffer.rays(cam, width, height, tiled, lo, hi)
