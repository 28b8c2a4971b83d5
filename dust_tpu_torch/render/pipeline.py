"""The per-frame render pipeline (port of :mod:`dust_tpu.render.pipeline`).

This is the headline frame of the reference: dense GI cache, the HDDA
traversal kernel for every trace, reference-mode sun shadows and the
half-resolution indirect denoise. Per frame:

1. **primary** — precise trace from the camera; the G-buffer; misses
   write sky radiance straight to the output.
2. **sun NEE** — one fused AO-threshold + rough shadow walk per hit.
3. **AO** then **final gather** — one cosine ray per hit (blue noise),
   traced to the AO threshold, then continued rough; final-gather hits
   read the dense GI cache.
4. **surfel refresh** — every (instance, leaf, face) cell shoots a sun
   ray and a cosine ray and folds the result into its cache row; when
   the cache has more rows than ``dense_refresh_budget``, a rotating
   slice of that many rows per frame.
5. **post** — half-res temporal + à-trous denoise of the indirect,
   joint-bilateral upsample, auto-exposure, ACES tonemap.

Six traces per frame: precise, ao_fg, ao_threshold and three rough; each
is one launch of the scene kernel, or with ``DUST_PALLAS_SCENE=loop``
one launch of the single-instance kernel per instance
(:mod:`dust_tpu_torch.ops.hdda`). Settings the port does not cover yet
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dust_tpu_torch.config import RenderSettings
from dust_tpu_torch.ops import camera as cameralib
from dust_tpu_torch.ops import denoise as denoiselib
from dust_tpu_torch.ops import exposure as exposurelib
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops import noise as noiselib
from dust_tpu_torch.ops import packing as pk
from dust_tpu_torch.ops import shade
from dust_tpu_torch.ops import sky as skylib
from dust_tpu_torch.ops import tonemap as tonemaplib
from dust_tpu_torch.ops.fp import fma
from dust_tpu_torch.ops.hdda import trace_scene, trace_scene_ao_fg
from dust_tpu_torch.render.materials import apply_materials
from dust_tpu_torch.utils import color as colorlib
from dust_tpu_torch.vox.geometry import unpack_r10g10b10a2

__all__ = ["FrameState", "make_frame_state", "render_frame",
           "state_from_numpy"]


@dataclasses.dataclass(frozen=True)
class FrameState:
    """Everything carried from frame to frame."""

    gi: gilib.DenseGICache              # dense GI cache table
    surfels: torch.Tensor               # (0, 4): dense mode has no pool
    denoiser: denoiselib.DenoiserState  # half-res packed history
    exposure_avg: torch.Tensor          # () float32
    frame_index: int
    prev_view_proj: torch.Tensor        # (4, 4) float32


def _check_settings(settings: RenderSettings):
    """The settings this port covers; the rest name their ROADMAP item."""
    unported = []
    if settings.gi_cache != "dense":
        unported.append("gi_cache='hash' (Queue 1, 'Hash GI')")
    if settings.traversal_backend != "pallas":
        unported.append("traversal_backend='jnp' (Queue 1, 'Eager "
                        "traversal backend')")
    if not (settings.denoiser.half_res_indirect and settings.height % 2 == 0
            and settings.width % 2 == 0):
        unported.append("full-resolution denoise (Queue 1, 'The other frame "
                        "branches')")
    if settings.debug_visualize_spatial_hash:
        unported.append("debug_visualize_spatial_hash (Queue 1, 'The other "
                        "frame branches')")
    if settings.shadow_mode != "reference":
        unported.append("shadow_mode='precise' (Queue 1, 'The other frame "
                        "branches')")
    if not (settings.contribution_secondary_spatial_hash
            or settings.contribution_secondary_skylight):
        unported.append("the primary+shadow frame without GI (Queue 1, 'The "
                        "other frame branches')")
    if unported:
        raise NotImplementedError("not ported yet: " + "; ".join(unported)
                                  + " (see ROADMAP.md)")


def make_frame_state(settings: RenderSettings, scene, device) -> FrameState:
    _check_settings(settings)
    return FrameState(
        gi=gilib.make_dense_gi_cache(scene),
        surfels=torch.zeros((0, 4), device=device),
        denoiser=denoiselib.make_denoiser_state(settings.height // 2,
                                                settings.width // 2, device),
        exposure_avg=torch.tensor(1.0, device=device),
        frame_index=0,
        prev_view_proj=torch.eye(4, device=device),
    )


def state_from_numpy(fields: dict, device) -> FrameState:
    """Carry a reference :class:`dust_tpu.render.pipeline.FrameState`
    (dense mode) into the port. ``fields``: ``gi`` (the cache table),
    ``surfels``, ``denoiser`` (the packed history), ``exposure_avg``,
    ``frame_index``, ``prev_view_proj``, as numpy arrays."""
    def t(a, dtype):
        a = np.array(a, copy=True, order="C")
        a = a.view(dtype) if a.dtype.kind in "ui" else a.astype(dtype)
        return torch.from_numpy(a).to(device)

    return FrameState(
        gi=gilib.DenseGICache(table=t(fields["gi"], np.int32)),
        surfels=t(fields["surfels"], np.float32),
        denoiser=denoiselib.DenoiserState(history=t(fields["denoiser"],
                                                    np.int32)),
        exposure_avg=t(fields["exposure_avg"], np.float32),
        frame_index=int(fields["frame_index"]),
        prev_view_proj=t(fields["prev_view_proj"], np.float32),
    )


def _pcg_scalar(v):
    """PCG hash of a frame counter, 15 bits (int or integer tensor)."""
    m = 0xFFFFFFFF
    v = v & m
    state = (v * 747796405 + 2891336453) & m
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & m
    return ((word >> 22) ^ word) & 0x7FFF


def _cell_enumeration(scene):
    """World-space leaf centres + validity of every (instance, leaf) cell
    in the cache's per-instance layout, padded to ``dense_cells``."""
    _, ccaps, _ = gilib.cell_layout(scene)
    centers, vleafs = [], []
    for i, m in enumerate(scene.inst_model):
        cc = ccaps[i]
        co = scene.leaf_origin[m, :cc].float() + 2.0
        a = scene.obj_to_world[i]
        centers.append(torch.stack(
            [co[:, 0] * a[k, 0] + co[:, 1] * a[k, 1] + co[:, 2] * a[k, 2]
             + a[k, 3] for k in range(3)], dim=-1))
        vleafs.append((scene.mask_lo[m, :cc] | scene.mask_hi[m, :cc]) != 0)
    centers = torch.cat(centers)
    vleafs = torch.cat(vleafs)
    pad = gilib.dense_cells(scene) - centers.shape[0]
    centers = torch.cat([centers, centers.new_zeros((pad, 3))])
    vleafs = torch.cat([vleafs, vleafs.new_zeros(pad)])
    return centers, vleafs


def _tiling(H: int, W: int):
    """Pixel order of the ray arrays: 8×128-pixel tiles when the image
    divides into them (a warp then walks neighbouring pixels), raster
    order otherwise. Returns (to_tiles, from_tiles)."""
    n = H * W
    tiled = H % 8 == 0 and W % 128 == 0

    def to_tiles(img):
        if not tiled:
            return img.reshape((n,) + img.shape[2:])
        x = img.reshape((H // 8, 8, W // 128, 128) + img.shape[2:])
        return torch.movedim(x, 2, 0).reshape((n,) + img.shape[2:])

    def from_tiles(flat):
        if not tiled:
            return flat.reshape((H, W) + flat.shape[1:])
        x = flat.reshape((W // 128, H // 8, 8, 128) + flat.shape[1:])
        return torch.movedim(x, 0, 2).reshape((H, W) + flat.shape[1:])

    return to_tiles, from_tiles


def render_frame(scene, state: FrameState, cam: cameralib.CameraSettings,
                 sky_state: skylib.SkyModelState, bn_cosine: torch.Tensor,
                 settings: RenderSettings, return_aux: bool = True):
    """Render one frame. Returns (output_srgb (H, W, 3), aux dict, new
    state). ``bn_cosine``: the (64, 128, 128, 3) cosine blue-noise table."""
    _check_settings(settings)
    H, W = settings.height, settings.width
    n = H * W
    dev = scene.device
    frame_index = state.frame_index
    rand = _pcg_scalar(frame_index)
    layer = frame_index % bn_cosine.shape[0]
    to_tiles, from_tiles = _tiling(H, W)

    def fill(mask, yes, no):
        return torch.where(mask, yes, no).float()

    # -------------------------------------------------- 1. primary
    dirs = to_tiles(cameralib.camera_ray_dirs(cam, W, H))
    origins = cam.position.expand(n, 3).contiguous()
    primary = trace_scene(scene, origins, dirs, cam.near, cam.far, "precise")
    g = shade.resolve_hits(scene, primary, origins, dirs)
    g, mat_emissive = apply_materials(g, settings.instance_materials)
    hit = g["hit"]

    dirs_n = dirs / pk.norm3(dirs, keepdim=True)
    sky_out = (skylib.sky_radiance(sky_state, dirs_n)
               + skylib.sun_radiance(sky_state, dirs_n)) / 3.14

    # -------------------------------------------------- 2. sun NEE
    normal = g["normal"]
    hit_loc = fma(normal, torch.full_like(normal, 0.01), g["world_pos"])
    sun_dir = sky_state.direction
    strength = skylib.sun_radiance(sky_state, sun_dir[None])[0] * (
        1.0 - torch.cos(sky_state.solar_radius))
    direct = mat_emissive
    if settings.contribution_direct:
        ndl = (normal * sun_dir).sum(dim=-1)
        facing = (ndl > 0.0) & hit
        sthr = settings.ambient_occlusion_threshold
        s_ao, s_fg = trace_scene_ao_fg(
            scene, hit_loc, sun_dir.expand(n, 3), 0.1,
            fill(facing, sthr, -1.0), fill(facing, 10000.0, -1.0))
        unoccluded = facing & ~(s_ao.hit | s_fg.hit)
        direct = direct + torch.where(
            unoccluded[:, None], strength * torch.clamp(ndl, min=0.0)[:, None],
            0.0)

    # -------------------------------------------------- 3. AO + final gather
    cos_sample = to_tiles(noiselib.bn_fetch(bn_cosine, layer, (7, 183), rand,
                                            H, W)) * 2.0 - 1.0
    gi_dir = pk.rotate_vector_by_normal(normal, cos_sample)
    gi_dir = torch.where(hit[:, None], gi_dir, gi_dir.new_tensor([0.0, 1.0, 0.0]))
    thr = settings.ambient_occlusion_threshold
    ao = trace_scene(scene, hit_loc, gi_dir, 0.1, fill(hit, thr, -1.0),
                     "ao_threshold")
    ao_hit = ao.hit
    fg_active = hit & ~ao_hit
    fg = trace_scene(scene, hit_loc, gi_dir, thr,
                     torch.where(fg_active, cam.far, -1.0), "rough")
    fg_hit = fg_active & fg.hit

    gi_reads = state.gi
    face = shade.entry_face(scene, fg, hit_loc, gi_dir)
    _found, cached, _cnt, alb_u32 = gilib.dense_get(
        gi_reads, gilib.dense_index(scene, fg.inst, fg.row, face), fg_hit)
    albedo_lin = colorlib.srgb_eotf(unpack_r10g10b10a2(alb_u32)[:, :3])
    indirect = colorlib.srgb_to_acescg(
        colorlib.acescg_to_srgb(cached) * albedo_lin)
    illum = torch.zeros((n, 3), device=dev)
    if settings.contribution_secondary_spatial_hash:
        illum = illum + torch.where(fg_hit[:, None], indirect, 0.0)
    if settings.contribution_secondary_skylight:
        illum = illum + torch.where((fg_active & ~fg.hit)[:, None],
                                    skylib.sky_radiance(sky_state, gi_dir), 0.0)

    hitdist = torch.where(ao_hit, ao.t, 0.0)
    hitdist = torch.where(fg_hit, fg.t, hitdist)
    radiance_img = torch.where(hit[:, None], direct + illum, sky_out)
    hitdist = torch.where(hit, hitdist, 100000.0)

    # -------------------------------------------------- 4. surfel refresh
    # The pool is the cell list, face-major: row = face * cells + cell.
    centers_w, vleaf = _cell_enumeration(scene)
    C = centers_w.shape[0]
    surfel_pos = centers_w.repeat(6, 1)
    surfel_dir = torch.arange(6, dtype=torch.int32,
                              device=dev)[:, None].expand(6, C).reshape(-1)
    s_valid = vleaf.repeat(6)
    # Refresh budget: big scenes patch a rotating contiguous slice of
    # ``budget`` rows per frame.
    rows_total = surfel_pos.shape[0]
    budget = settings.surfels.dense_refresh_budget
    slice_start = None
    if budget and rows_total > budget:
        nslices = -(-rows_total // budget)
        slice_start = min((frame_index % nslices) * budget,
                          rows_total - budget)
        window = slice(slice_start, slice_start + budget)
        surfel_pos = surfel_pos[window]
        surfel_dir = surfel_dir[window]
        s_valid = s_valid[window]
    p = surfel_pos.shape[0]
    s_normal = pk.face_id_to_normal(surfel_dir)
    s_origin = fma(torch.full_like(s_normal, 2.01), s_normal, surfel_pos)
    s_cos = noiselib.bn_fetch_pool(bn_cosine, layer, (16, 47), rand,
                                   p) * 2.0 - 1.0
    s_dir = pk.rotate_vector_by_normal(s_normal, s_cos)

    s_payload = torch.zeros((p, 3), device=dev)
    if settings.contribution_secondary_sunlight:
        s_ndl = (s_normal * sun_dir).sum(dim=-1)
        s_facing = (s_ndl > 0.0) & s_valid
        s_shadow = trace_scene(scene, s_origin, sun_dir.expand(p, 3), 0.1,
                               fill(s_facing, 10000.0, -1.0), "rough")
        s_unocc = s_facing & ~s_shadow.hit
        s_payload = s_payload + torch.where(
            s_unocc[:, None], strength * torch.clamp(s_ndl, min=0.0)[:, None],
            0.0)

    s_res = trace_scene(scene, s_origin, s_dir, 0.1,
                        fill(s_valid, 10000.0, -1.0), "rough")
    s_hit = s_valid & s_res.hit
    s_face = shade.entry_face(scene, s_res, s_origin, s_dir)
    s_found, s_cached, _s_cnt, s_alb_u32 = gilib.dense_get(
        gi_reads, gilib.dense_index(scene, s_res.inst, s_res.row, s_face),
        s_hit)
    s_albedo_lin = colorlib.srgb_eotf(unpack_r10g10b10a2(s_alb_u32)[:, :3])
    s_bounce = colorlib.srgb_to_acescg(
        colorlib.acescg_to_srgb(s_cached) * s_albedo_lin)
    s_sky = skylib.sky_radiance(
        sky_state, s_dir / torch.clamp(pk.norm3(s_dir, keepdim=True), min=1e-8))
    insert_val = torch.where(s_hit[:, None], s_bounce + s_payload,
                             s_sky + s_payload)
    insert_ok = s_valid & (~s_hit | s_found)
    if slice_start is None:
        new_gi = gilib.dense_update(state.gi, insert_val, insert_ok)
    else:
        new_gi = gilib.dense_update_slice(state.gi, slice_start, insert_val,
                                          insert_ok)

    # -------------------------------------------------- 5. post (half res)
    dep2 = from_tiles(g["depth"])
    nor2 = from_tiles(normal)
    ind2 = from_tiles(torch.where(hit[:, None], illum, 0.0))
    rh, hh, dh, nh, wh, mh = denoiselib.downsample_inputs(
        ind2, from_tiles(hitdist), dep2, nor2, from_tiles(g["world_pos"]),
        from_tiles(g["motion"]))
    # One fewer à-trous iteration at half res (same world-space footprint).
    den_settings = dataclasses.replace(
        settings.denoiser,
        atrous_iterations=max(settings.denoiser.atrous_iterations - 1, 1))
    den_h, hd_h, new_den = denoiselib.denoise(
        state.denoiser, rh, hh, dh, nh, wh, mh, state.prev_view_proj,
        den_settings)
    ind_full, acc_hd = denoiselib.upsample_bilateral(den_h, hd_h, dh, nh,
                                                     dep2, nor2)
    valid2 = torch.isfinite(dep2)
    denoised = torch.where(valid2[..., None], ind_full, 0.0) + from_tiles(
        torch.where(hit[:, None], direct, sky_out))

    weighted = exposurelib.mean_bin(denoised, settings.exposure)
    new_avg = exposurelib.adapt_average_luminance(
        state.exposure_avg, n, settings.exposure, weighted)
    exposure = exposurelib.exposure_value(new_avg)
    albedo_img = from_tiles(g["albedo"][:, :3])
    output = tonemaplib.tonemap(denoised, albedo_img, exposure, "srgb")

    aux = dict(
        depth=dep2, albedo=albedo_img, normal=nor2,
        motion=from_tiles(g["motion"]), voxel_id=from_tiles(g["voxel_id"]),
        radiance=from_tiles(radiance_img), hitdist=from_tiles(hitdist),
        denoised=denoised, exposure=exposure,
    ) if return_aux else {}
    new_state = FrameState(
        gi=new_gi, surfels=state.surfels, denoiser=new_den,
        exposure_avg=new_avg, frame_index=frame_index + 1,
        prev_view_proj=cam.view_proj)
    return output, aux, new_state


def frame_ray_count(scene, settings: RenderSettings) -> int:
    """Rays per frame as the reference's bench counts them: four
    full-resolution launches plus two rays per valid dense-cache cell,
    or, under a refresh budget, per valid cell of the frame's slice
    (``budget`` rows times the valid fraction of all rows)."""
    valid = (scene.mask_lo | scene.mask_hi) != 0
    counts = valid.sum(dim=1).tolist()
    patch_cells = sum(counts[m] for m in scene.inst_model) * 6
    total_rows = gilib.dense_rows(scene)
    budget = settings.surfels.dense_refresh_budget
    if budget and total_rows > budget:
        patch_cells = int(budget * patch_cells / total_rows)
    return settings.width * settings.height * 4 + patch_cells * 2
