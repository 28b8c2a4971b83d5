"""The converged ground truth's scene settings and camera: the port's
copy of ``tests/quality_setup.py``, so that
:mod:`~dust_tpu_torch.tools.gen_ground_truth` and ``chip_smoke.py``'s
quality gates use one definition."""

from __future__ import annotations

from dust_tpu_torch.config import (RenderSettings, SpatialHashSettings,
                                   SurfelSettings)
from dust_tpu_torch.ops import camera as cameralib

GT_EYE = (150.0, 90.0, 180.0)
GT_TARGET = (0.0, 30.0, 0.0)
GT_CAPACITY = 1 << 18
GT_POOL = 16384


def gt_settings(width: int, height: int, backend: str = "jnp",
                **overrides) -> RenderSettings:
    base = dict(
        width=width, height=height,
        spatial_hash=SpatialHashSettings(capacity=GT_CAPACITY),
        surfels=SurfelSettings(pool_size=GT_POOL),
        traversal_backend=backend,
        gi_cache="dense",
    )
    base.update(overrides)
    return RenderSettings(**base)


def gt_camera(settings: RenderSettings, width: int, height: int, device):
    c2w = cameralib.look_at(GT_EYE, GT_TARGET)
    return cameralib.camera_settings(
        c2w, settings.camera.fov, settings.camera.near,
        settings.camera.far, width, height, device,
    )
