"""The primary stage's G-buffer kernels: their launch arguments and
checks.

``csrc/gbuffer.cu`` holds two kernels around the primary trace, one
thread per ray:

* ``primary_rays_kernel`` — the camera rays ``[lo, hi)`` in the trace's
  order; its plain version is
  :func:`dust_tpu_torch.ops.camera.primary_rays_plain`;
* ``gbuffer_resolve_kernel`` — the G-buffer of a primary trace, and the
  sky its rays see; its plain version is
  :func:`dust_tpu_torch.ops.shade.resolve_hits_plain`.

Their entry points, :func:`~dust_tpu_torch.ops.camera.primary_rays` and
:func:`~dust_tpu_torch.ops.shade.resolve_primary`, run the plain versions
for CPU tensors and call :func:`rays` / :func:`resolve` here for any
other, which launch the kernels on CUDA tensors or raise.
:data:`LIBRARY` (:class:`dust_tpu_torch.csrc.Library`) builds them at
the first launch and counts each launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dust_tpu_torch import csrc
from dust_tpu_torch.csrc import check, f32_recip, on_cuda
from dust_tpu_torch.utils import color as colorlib

__all__ = ["rays", "resolve", "LIBRARY", "LAUNCHES"]

# Launches of each kernel since the last reset (the plain versions count
# nothing).
LAUNCHES = {"primary_rays": 0, "gbuffer_resolve": 0}

_vp, _ci, _ll, _cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)


class _RaysArgs(ctypes.Structure):
    _fields_ = [("view_cols", _vp), ("position", _vp),
                ("tan_half_fov", _vp), ("origin", _vp), ("dir", _vp),
                ("lo", _ll), ("count", _ll), ("width", _ci),
                ("height", _ci), ("tiled", _ci), ("inv_w", _cf),
                ("inv_h", _cf), ("aspect", _cf)]


class _ResolveArgs(ctypes.Structure):
    _fields_ = [(name, _vp) for name in (
        "t", "inst", "row", "bit", "origin", "dir", "leaf_base",
        "voxel_attr", "world_to_obj", "obj_to_world", "prev_obj_to_world",
        "sky_configs", "sky_radiances", "sky_ld", "sun_dir",
        "solar_intensity", "solar_radius", "hit", "inst_out", "depth",
        "albedo", "normal", "motion", "voxel_id", "world_pos",
        "palette_idx", "sky_out")] + [
        ("xyz_to_acescg", _cf * 9), ("inv_255", _cf), ("inv_pi", _cf),
        ("va_rows", _ll), ("n", _ci)]


LIBRARY = csrc.Library("gbuffer.cu", "gbuffer", {
    "primary_rays_launch": ([_vp], LAUNCHES),
    "gbuffer_resolve_launch": ([_vp], LAUNCHES)})


def rays(cam, width: int, height: int, tiled: bool, lo: int, hi: int):
    """Launch ``primary_rays_kernel``: (origins, directions) of the rays
    ``[lo, hi)``, each (hi - lo, 3) float32 (contract of
    :func:`~dust_tpu_torch.ops.camera.primary_rays`)."""
    dev = cam.position.device
    on_cuda("primary_rays", dev, hi - lo, "rays")
    check("view_cols", cam.view_cols, torch.float32, (3, 3), dev)
    check("position", cam.position, torch.float32, (3,), dev)
    check("tan_half_fov", cam.tan_half_fov, torch.float32, (), dev)
    m = hi - lo
    origin = torch.empty((m, 3), dtype=torch.float32, device=dev)
    direction = torch.empty((m, 3), dtype=torch.float32, device=dev)
    args = _RaysArgs(
        view_cols=cam.view_cols.data_ptr(), position=cam.position.data_ptr(),
        tan_half_fov=cam.tan_half_fov.data_ptr(), origin=origin.data_ptr(),
        dir=direction.data_ptr(), lo=lo, count=m, width=width, height=height,
        tiled=int(tiled), inv_w=f32_recip(width), inv_h=f32_recip(height),
        aspect=float(np.float32(width / height)))
    LIBRARY.launch("primary_rays_launch", ctypes.addressof(args), device=dev,
                   count="primary_rays")
    return origin, direction


def resolve(scene, res, origin_w, dir_w, sky_state=None) -> dict:
    """Launch ``gbuffer_resolve_kernel``: the G-buffer dict of
    :func:`~dust_tpu_torch.ops.shade.resolve_primary`, with ``sky_out``
    when ``sky_state`` is given."""
    args, g = _resolve_args(scene, res, origin_w, dir_w, sky_state)
    LIBRARY.launch("gbuffer_resolve_launch", ctypes.addressof(args),
                   device=origin_w.device, count="gbuffer_resolve")
    return g


def _resolve_args(scene, res, origin_w, dir_w, sky_state):
    """The checked launch arguments of :func:`resolve` and its outputs,
    allocated (the upload of ``inst_leaf_base`` is the one host sync)."""
    dev = origin_w.device
    n = origin_w.shape[0]
    on_cuda("gbuffer_resolve", dev, n, "rays")
    n_inst = scene.world_to_obj.shape[0]
    va_rows = scene.voxel_attr.shape[0]
    check("t", res.t, torch.float32, (n,), dev)
    for name in ("inst", "row", "bit"):
        check(name, getattr(res, name), torch.int32, (n,), dev)
    check("origin_w", origin_w, torch.float32, (n, 3), dev)
    check("dir_w", dir_w, torch.float32, (n, 3), dev)
    check("voxel_attr", scene.voxel_attr, torch.int32, (va_rows, 16), dev)
    for name in ("world_to_obj", "obj_to_world", "prev_obj_to_world"):
        check(name, getattr(scene, name), torch.float32, (n_inst, 3, 4),
              dev)
    if va_rows == 0:
        raise ValueError("voxel_attr: no rows")
    base = torch.tensor(scene.inst_leaf_base, dtype=torch.long, device=dev)
    check("inst_leaf_base", base, torch.long, (n_inst,), dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    g = dict(hit=empty(n, dtype=torch.bool), inst=empty(n, dtype=torch.long),
             depth=empty(n), albedo=empty(n, 4), normal=empty(n, 3),
             motion=empty(n, 3), voxel_id=empty(n, dtype=torch.long),
             world_pos=empty(n, 3), palette_idx=empty(n, dtype=torch.long))
    sky = {}
    if sky_state is not None:
        for name, shape in (("configs", (3, 9)), ("radiances", (3,)),
                            ("ld_coefs", (3, 6)), ("direction", (3,)),
                            ("solar_intensity", (3,)),
                            ("solar_radius", ())):
            t = getattr(sky_state, name)
            check(f"sky_state.{name}", t, torch.float32, shape, dev)
            sky[name] = t.data_ptr()
        g["sky_out"] = empty(n, 3)
    args = _ResolveArgs(
        t=res.t.data_ptr(), inst=res.inst.data_ptr(),
        row=res.row.data_ptr(), bit=res.bit.data_ptr(),
        origin=origin_w.data_ptr(), dir=dir_w.data_ptr(),
        leaf_base=base.data_ptr(), voxel_attr=scene.voxel_attr.data_ptr(),
        world_to_obj=scene.world_to_obj.data_ptr(),
        obj_to_world=scene.obj_to_world.data_ptr(),
        prev_obj_to_world=scene.prev_obj_to_world.data_ptr(),
        sky_configs=sky.get("configs"), sky_radiances=sky.get("radiances"),
        sky_ld=sky.get("ld_coefs"), sun_dir=sky.get("direction"),
        solar_intensity=sky.get("solar_intensity"),
        solar_radius=sky.get("solar_radius"),
        hit=g["hit"].data_ptr(), inst_out=g["inst"].data_ptr(),
        depth=g["depth"].data_ptr(), albedo=g["albedo"].data_ptr(),
        normal=g["normal"].data_ptr(), motion=g["motion"].data_ptr(),
        voxel_id=g["voxel_id"].data_ptr(),
        world_pos=g["world_pos"].data_ptr(),
        palette_idx=g["palette_idx"].data_ptr(),
        sky_out=g["sky_out"].data_ptr() if "sky_out" in g else None,
        xyz_to_acescg=(_cf * 9)(*colorlib.XYZ_TO_ACESCG.reshape(-1).tolist()),
        inv_255=f32_recip(255.0), inv_pi=f32_recip(3.14), va_rows=va_rows,
        n=n)
    args.keep = (base,)  # alive as long as the arguments point into it
    return args, g
