"""The G-buffer and final-gather kernels: their launch arguments and
checks.

``csrc/gbuffer.cu`` holds four kernels, one thread per ray: two around
the primary trace,

* ``primary_rays_kernel`` — the camera rays ``[lo, hi)`` in the trace's
  order; its plain version is
  :func:`dust_tpu_torch.ops.camera.primary_rays_plain`;
* ``gbuffer_resolve_kernel`` — the G-buffer of a primary trace, and the
  sky its rays see; its plain version is
  :func:`dust_tpu_torch.ops.shade.resolve_hits_plain`;

and two around the AO and final-gather traces,

* ``gather_dirs_kernel`` — the gather rays' cosine directions and the AO
  trace's ``t_max``; its plain version is
  :func:`dust_tpu_torch.ops.shade.gather_dirs_plain`;
* ``gather_resolve_kernel`` — the dense GI cache's read at the final
  gather's hits, the bounce, the sky, and the frame's radiance, hit
  distance and indirect light; its plain version is
  :func:`dust_tpu_torch.ops.shade.resolve_gather_plain`.

Their entry points, :func:`~dust_tpu_torch.ops.camera.primary_rays`,
:func:`~dust_tpu_torch.ops.shade.resolve_primary`,
:func:`~dust_tpu_torch.ops.shade.gather_dirs` and
:func:`~dust_tpu_torch.ops.shade.resolve_gather`, run the plain versions
for CPU tensors and call :func:`rays`, :func:`resolve`, :func:`dirs` and
:func:`gather` here for any other, which launch the kernels on CUDA
tensors or raise. :data:`LIBRARY` (:class:`dust_tpu_torch.csrc.Library`)
builds them at the first launch and counts each launch in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dust_tpu_torch import csrc
from dust_tpu_torch.csrc import check, f32_recip, on_cuda
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.utils import color as colorlib

__all__ = ["rays", "resolve", "dirs", "gather", "LIBRARY", "LAUNCHES"]

# Launches of each kernel since the last reset (the plain versions count
# nothing).
LAUNCHES = {"primary_rays": 0, "gbuffer_resolve": 0, "gather_dirs": 0,
            "gather_resolve": 0}

_vp, _ci, _ll, _cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)


class _RaysArgs(ctypes.Structure):
    _fields_ = [("view_cols", _vp), ("position", _vp),
                ("tan_half_fov", _vp), ("origin", _vp), ("dir", _vp),
                ("lo", _ll), ("count", _ll), ("width", _ci),
                ("height", _ci), ("tiled", _ci), ("inv_w", _cf),
                ("inv_h", _cf), ("aspect", _cf)]


class _SkyArgs(ctypes.Structure):
    _fields_ = [(name, _vp) for name in (
        "configs", "radiances", "ld", "sun_dir", "solar_intensity",
        "solar_radius")] + [("xyz_to_acescg", _cf * 9)]


class _ResolveArgs(ctypes.Structure):
    _fields_ = [(name, _vp) for name in (
        "t", "inst", "row", "bit", "origin", "dir", "leaf_base",
        "voxel_attr", "world_to_obj", "obj_to_world",
        "prev_obj_to_world")] + [("sky", _SkyArgs)] + [
        (name, _vp) for name in (
            "hit", "inst_out", "depth", "albedo", "normal", "motion",
            "voxel_id", "world_pos", "palette_idx", "sky_out")] + [
        ("inv_255", _cf), ("inv_pi", _cf), ("va_rows", _ll), ("n", _ci)]


class _GatherDirsArgs(ctypes.Structure):
    _fields_ = [(name, _vp) for name in (
        "normal", "hit", "noise", "gi_dir", "ao_t_max")] + [
        ("lo", _ll), ("count", _ll)] + [(name, _ci) for name in (
            "width", "height", "tiled", "noise_h", "noise_w", "shift_x",
            "shift_y")] + [("ao_threshold", _cf)]


class _CacheArgs(ctypes.Structure):
    _fields_ = [(name, _vp) for name in (
        "world_to_obj", "obj_to_world", "layout", "table")] + [
        ("cells", _ll), ("acescg_to_srgb", _cf * 9),
        ("srgb_to_acescg", _cf * 9), ("inv_1023", _cf), ("inv_12_92", _cf),
        ("inv_1_055", _cf)]


class _GatherResolveArgs(ctypes.Structure):
    _fields_ = [(name, _vp) for name in (
        "fg_t", "fg_inst", "fg_row", "ao_t", "ao_inst", "origin", "dir",
        "hit", "direct", "sky_out", "debug_illum")] + [
        ("cache", _CacheArgs), ("sky", _SkyArgs)] + [
        (name, _vp) for name in (
            "radiance", "hitdist", "illum", "face", "count", "center")] + [
        (name, _ci) for name in ("bounce", "skylight", "n")]


LIBRARY = csrc.Library("gbuffer.cu", "gbuffer", {
    "primary_rays_launch": ([_vp], LAUNCHES),
    "gbuffer_resolve_launch": ([_vp], LAUNCHES),
    "gather_dirs_launch": ([_vp], LAUNCHES),
    "gather_resolve_launch": ([_vp], LAUNCHES)})


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


def _sky_args(sky_state, dev) -> _SkyArgs:
    """The sky model's launch arguments, checked; all null without
    ``sky_state``."""
    sky = {}
    if sky_state is not None:
        for name, field, shape in (
                ("configs", "configs", (3, 9)),
                ("radiances", "radiances", (3,)),
                ("ld", "ld_coefs", (3, 6)), ("sun_dir", "direction", (3,)),
                ("solar_intensity", "solar_intensity", (3,)),
                ("solar_radius", "solar_radius", ())):
            t = getattr(sky_state, field)
            check(f"sky_state.{field}", t, torch.float32, shape, dev)
            sky[name] = t.data_ptr()
    return _SkyArgs(**sky, xyz_to_acescg=_mat(colorlib.XYZ_TO_ACESCG))


def _mat(m):
    """A 3x3 colour matrix as the kernels take it, row-major float32."""
    return (_cf * 9)(*np.asarray(m, np.float32).reshape(-1).tolist())


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
    sky = _sky_args(sky_state, dev)
    if sky_state is not None:
        g["sky_out"] = empty(n, 3)
    args = _ResolveArgs(
        t=res.t.data_ptr(), inst=res.inst.data_ptr(),
        row=res.row.data_ptr(), bit=res.bit.data_ptr(),
        origin=origin_w.data_ptr(), dir=dir_w.data_ptr(),
        leaf_base=base.data_ptr(), voxel_attr=scene.voxel_attr.data_ptr(),
        world_to_obj=scene.world_to_obj.data_ptr(),
        obj_to_world=scene.obj_to_world.data_ptr(),
        prev_obj_to_world=scene.prev_obj_to_world.data_ptr(), sky=sky,
        hit=g["hit"].data_ptr(), inst_out=g["inst"].data_ptr(),
        depth=g["depth"].data_ptr(), albedo=g["albedo"].data_ptr(),
        normal=g["normal"].data_ptr(), motion=g["motion"].data_ptr(),
        voxel_id=g["voxel_id"].data_ptr(),
        world_pos=g["world_pos"].data_ptr(),
        palette_idx=g["palette_idx"].data_ptr(),
        sky_out=g["sky_out"].data_ptr() if "sky_out" in g else None,
        inv_255=f32_recip(255.0), inv_pi=f32_recip(3.14), va_rows=va_rows,
        n=n)
    args.keep = (base,)  # alive as long as the arguments point into it
    return args, g


def dirs(normal, hit, table, layer: int, offset, rand: int, width: int,
         height: int, tiled: bool, lo: int, hi: int, ao_threshold: float):
    """Launch ``gather_dirs_kernel``: (gi_dir (m, 3), ao_t_max (m,)) of the
    rays ``[lo, hi)`` (contract of
    :func:`~dust_tpu_torch.ops.shade.gather_dirs`)."""
    args, out = _dirs_args(normal, hit, table, layer, offset, rand, width,
                           height, tiled, lo, hi, ao_threshold)
    LIBRARY.launch("gather_dirs_launch", ctypes.addressof(args),
                   device=normal.device, count="gather_dirs")
    return out


def _dirs_args(normal, hit, table, layer, offset, rand, width, height,
               tiled, lo, hi, ao_threshold):
    """The checked launch arguments of :func:`dirs` and its outputs,
    allocated."""
    dev = normal.device
    m = hi - lo
    on_cuda("gather_dirs", dev, m, "rays")
    check("normal", normal, torch.float32, (m, 3), dev)
    check("hit", hit, torch.bool, (m,), dev)
    layers, th, tw = table.shape[:3]
    check("table", table, torch.float32, (layers, th, tw, 3), dev)
    gi_dir = torch.empty((m, 3), dtype=torch.float32, device=dev)
    t_max = torch.empty((m,), dtype=torch.float32, device=dev)
    args = _GatherDirsArgs(
        normal=normal.data_ptr(), hit=hit.data_ptr(),
        noise=table[layer].data_ptr(), gi_dir=gi_dir.data_ptr(),
        ao_t_max=t_max.data_ptr(), lo=lo, count=m, width=width,
        height=height, tiled=int(tiled), noise_h=th, noise_w=tw,
        shift_x=(offset[0] + rand) % tw, shift_y=(offset[1] + rand) % th,
        ao_threshold=float(np.float32(ao_threshold)))
    return args, (gi_dir, t_max)


def gather(scene, fg, ao, origin, direction, hit, direct, sky_out, cache,
           sky_state, bounce: bool, skylight: bool, cells: bool,
           debug_illum=None) -> dict:
    """Launch ``gather_resolve_kernel``: the dict of
    :func:`~dust_tpu_torch.ops.shade.resolve_gather`."""
    args, out = _gather_args(scene, fg, ao, origin, direction, hit, direct,
                             sky_out, cache, sky_state, bounce, skylight,
                             cells, debug_illum)
    LIBRARY.launch("gather_resolve_launch", ctypes.addressof(args),
                   device=origin.device, count="gather_resolve")
    return out


@functools.lru_cache(maxsize=8)
def _cell_layout(layout: tuple, device) -> torch.Tensor:
    """(I, 2) int64 (cell base, cell cap) of each instance on ``device``,
    uploaded once for each layout (an animated instance's new scene each
    frame keeps its layout)."""
    return torch.tensor(layout, dtype=torch.long, device=device).reshape(
        -1, 2)


def _gather_args(scene, fg, ao, origin, direction, hit, direct, sky_out,
                 cache, sky_state, bounce, skylight, cells, debug_illum=None):
    """The checked launch arguments of :func:`gather` and its outputs,
    allocated."""
    if skylight and sky_state is None:
        raise ValueError("gather_resolve: skylight without a sky_state")
    dev = origin.device
    n = origin.shape[0]
    on_cuda("gather_resolve", dev, n, "rays")
    n_inst = scene.world_to_obj.shape[0]
    for name, res in (("fg", fg), ("ao", ao)):
        check(f"{name}.t", res.t, torch.float32, (n,), dev)
        check(f"{name}.inst", res.inst, torch.int32, (n,), dev)
    check("fg.row", fg.row, torch.int32, (n,), dev)
    for name, t in (("origin", origin), ("direction", direction),
                    ("direct", direct), ("sky_out", sky_out)):
        check(name, t, torch.float32, (n, 3), dev)
    if debug_illum is not None:
        check("debug_illum", debug_illum, torch.float32, (n, 3), dev)
    check("hit", hit, torch.bool, (n,), dev)
    for name in ("world_to_obj", "obj_to_world"):
        check(name, getattr(scene, name), torch.float32, (n_inst, 3, 4),
              dev)
    n_cells = gilib.dense_cells(scene)
    check("cache.table", cache.table, torch.int32, (6 * n_cells, 3), dev)
    bases, caps, _ = gilib.cell_layout(scene)
    layout = _cell_layout(tuple(v for pair in zip(bases, caps)
                                for v in pair), dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(radiance=empty(n, 3), hitdist=empty(n), illum=empty(n, 3))
    if cells:
        out.update(face=empty(n, dtype=torch.int32), count=empty(n),
                   center=empty(n, 3))
    args = _GatherResolveArgs(
        fg_t=fg.t.data_ptr(), fg_inst=fg.inst.data_ptr(),
        fg_row=fg.row.data_ptr(), ao_t=ao.t.data_ptr(),
        ao_inst=ao.inst.data_ptr(), origin=origin.data_ptr(),
        dir=direction.data_ptr(), hit=hit.data_ptr(),
        direct=direct.data_ptr(), sky_out=sky_out.data_ptr(),
        debug_illum=None if debug_illum is None else debug_illum.data_ptr(),
        cache=_CacheArgs(
            world_to_obj=scene.world_to_obj.data_ptr(),
            obj_to_world=scene.obj_to_world.data_ptr(),
            layout=layout.data_ptr(), table=cache.table.data_ptr(),
            cells=n_cells, acescg_to_srgb=_mat(colorlib.ACESCG_TO_SRGB),
            srgb_to_acescg=_mat(colorlib.SRGB_TO_ACESCG),
            inv_1023=f32_recip(1023.0), inv_12_92=f32_recip(12.92),
            inv_1_055=f32_recip(1.055)),
        sky=_sky_args(sky_state, dev),
        **{name: out[name].data_ptr() if name in out else None
           for name in ("radiance", "hitdist", "illum", "face", "count",
                        "center")},
        bounce=int(bounce), skylight=int(skylight), n=n)
    args.keep = (layout,)
    return args, out
