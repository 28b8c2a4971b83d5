"""The per-frame render pipeline, plain: the benchmark's frozen copy of
the port's frame without a mesh, every trace through the plain walk of
:mod:`benchmark.reference.ops.hdda` in the order and modes of the
kernel's backend (8×128-pixel tiles, the fused ao_fg sun ray).

``render_frame(..., fused_sun=False)`` follows the port's ray-sharded
frame: reference-mode sun shadows as two plain launches, ao_threshold
then rough, in place of the fused ao_fg walk (a grazing sun ray may end
otherwise than in the fused walk); every other trace is the same.

``render_frame(..., lowp=True)`` is the control of the benchmark's
check: every float tensor handed from one stage to the next (ray origins
and directions, the G-buffer, the shading terms, the surfel rays and
inserts, the denoised image, the exposure and the output) is rounded to
bfloat16, the precision below the frame's float32.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.config import RenderSettings
from benchmark.reference.ops import camera as cameralib
from benchmark.reference.ops import denoise as denoiselib
from benchmark.reference.ops import exposure as exposurelib
from benchmark.reference.ops import gi_cache as gilib
from benchmark.reference.ops import hdda
from benchmark.reference.ops import noise as noiselib
from benchmark.reference.ops import packing as pk
from benchmark.reference.ops import shade
from benchmark.reference.ops import sky as skylib
from benchmark.reference.ops import spatial_hash as sh
from benchmark.reference.ops import tonemap as tonemaplib
from benchmark.reference.ops.fp import fma
from benchmark.reference.utils import color as colorlib
from benchmark.reference.vox.geometry import unpack_r10g10b10a2

__all__ = ["FrameState", "make_frame_state", "render_frame",
           "frame_ray_count"]

INVALID_SURFEL = 7  # a pool row whose face id is >= 6 is empty


@dataclasses.dataclass(frozen=True)
class FrameState:
    """Everything carried from frame to frame."""

    gi: gilib.DenseGICache | sh.SpatialHash  # by settings.gi_cache
    # Hash mode: the surfel pool, (P, 4) float32 rows [x, y, z, face id].
    # Dense mode has no pool: (0, 4).
    surfels: torch.Tensor
    denoiser: denoiselib.DenoiserState  # packed history (half or full res)
    exposure_avg: torch.Tensor          # () float32
    frame_index: int
    prev_view_proj: torch.Tensor        # (4, 4) float32
    # Hash mode with ws_refresh_slices > 1: the working set, whose
    # rotating slice is re-probed each frame. None otherwise.
    gi_ws: gilib.DenseGICache | None = None


def _check_settings(settings: RenderSettings):
    """Refuses a traversal backend or shadow mode that does not exist."""
    if settings.traversal_backend not in ("pallas", "jnp"):
        raise ValueError(f"traversal_backend={settings.traversal_backend!r}")
    if settings.shadow_mode not in ("reference", "precise"):
        raise ValueError(f"shadow_mode={settings.shadow_mode!r}")


def _half_res(settings: RenderSettings) -> bool:
    """Whether the indirect is denoised at half resolution."""
    return (settings.denoiser.half_res_indirect and settings.height % 2 == 0
            and settings.width % 2 == 0)


def _gi_enabled(settings: RenderSettings) -> bool:
    """Whether the frame has its AO, final-gather and surfel passes."""
    return (settings.contribution_secondary_spatial_hash
            or settings.contribution_secondary_skylight
            or settings.debug_visualize_spatial_hash)


def make_frame_state(settings: RenderSettings, scene, device) -> FrameState:
    """The first frame's state: an empty cache (hash mode: a zero table
    of ``spatial_hash.capacity`` slots and a pool of ``pool_size`` empty
    surfels), on ``device``."""
    _check_settings(settings)
    gi_ws = None
    if settings.gi_cache == "dense":
        gi = gilib.make_dense_gi_cache(scene)
        surfels = torch.zeros((0, 4), device=device)
    else:
        gi = sh.make_spatial_hash(settings.spatial_hash.capacity, device)
        surfels = torch.zeros((settings.surfels.pool_size, 4), device=device)
        surfels[:, 3] = float(INVALID_SURFEL)
        if settings.spatial_hash.ws_refresh_slices > 1:
            gi_ws = gilib.make_dense_gi_cache(scene)
    div = 2 if _half_res(settings) else 1
    return FrameState(
        gi=gi,
        surfels=surfels,
        denoiser=denoiselib.make_denoiser_state(settings.height // div,
                                                settings.width // div, device),
        exposure_avg=torch.tensor(1.0, device=device),
        frame_index=0,
        prev_view_proj=torch.eye(4, device=device),
        gi_ws=gi_ws,
    )


def _pool_enqueue_mod(dest, mask, values):
    """Enqueue ``values[i]`` where ``mask[i]`` into pool slot ``i % P``
    (the reference's surfel mapping); of the candidates for one slot the
    lowest index wins, and a slot with none keeps ``dest``."""
    size = dest.shape[0]
    n = mask.shape[0]
    k = -(-n // size)
    pad = k * size - n
    m = torch.cat([mask, mask.new_zeros(pad)]).reshape(k, size)
    v = torch.cat([values, values.new_zeros((pad,) + values.shape[1:])])
    v = v.reshape((k, size) + values.shape[1:])
    rows = torch.arange(k, device=mask.device)[:, None]
    winner = torch.where(m, rows, k).amin(dim=0)   # k where no candidate
    picked = torch.gather(
        v, 0, torch.clamp(winner, max=k - 1)[None, :, None].expand(
            1, size, v.shape[2]))[0]
    return torch.where((winner < k)[:, None], picked, dest)


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


def _tiling(H: int, W: int, tiled: bool):
    """Pixel order of the ray arrays: with ``tiled`` (the HDDA kernel's
    backend), 8×128-pixel tiles when the image divides into them (a warp
    then walks neighbouring pixels), raster order otherwise. Returns
    (to_tiles, from_tiles)."""
    n = H * W
    tiled = tiled and H % 8 == 0 and W % 128 == 0

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


def _working_set(scene, state: FrameState, settings: RenderSettings,
                 frame_index: int):
    """The hash frame's GI reads: one ``hash_get`` per (instance, leaf,
    face) cell packed into dense-cache rows, so that every ray-side read
    is the dense gather. With ``ws_refresh_slices`` N > 1 only the
    frame's rotating 1/N slice is probed and the rest keeps its last
    probe. Returns (the cache to read, the new ``gi_ws``)."""
    centers_w, vleaf = _cell_enumeration(scene)
    cells = centers_w.shape[0]
    face6 = torch.arange(6, dtype=torch.int32,
                         device=scene.device)[:, None].expand(6, cells)
    qpos6, face6 = sh.spatial_hash_key(centers_w.repeat(6, 1),
                                       face6.reshape(-1),
                                       settings.spatial_hash.cell_size)
    valid6 = vleaf.repeat(6)
    nslices = settings.spatial_hash.ws_refresh_slices
    if nslices > 1 and state.gi_ws is not None:
        rows_total = qpos6.shape[0]
        size = -(-rows_total // nslices)
        start = min((frame_index % nslices) * size, rows_total - size)
        window = slice(start, start + size)
        found, rad, cnt = sh.hash_get(state.gi, qpos6[window], face6[window])
        cnt = torch.where(found & valid6[window], cnt, 0)
        table = state.gi_ws.table.clone()
        table[window] = gilib.pack_working_set_rows(rad, cnt,
                                                    table[window, 2:3])
        ws = gilib.DenseGICache(table=table)
        return ws, ws
    found, rad, cnt = sh.hash_get(state.gi, qpos6, face6)
    cnt = torch.where(found & valid6, cnt, 0)
    return gilib.pack_working_set(rad, cnt, scene), state.gi_ws


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back (the control's precision)."""
    return x.to(torch.bfloat16).float()


def render_frame(scene, state: FrameState, cam: cameralib.CameraSettings,
                 sky_state: skylib.SkyModelState, bn_cosine: torch.Tensor,
                 bn_scalar: torch.Tensor, settings: RenderSettings,
                 lowp: bool = False, fused_sun: bool = True):
    """Render one frame. Returns (output_srgb (H, W, 3), aux dict, new
    state), as the port's ``render_frame(..., return_aux=True)`` without a
    mesh, or with ``fused_sun=False`` the whole frame of its sharded
    frame. ``lowp``: the control (module docstring)."""
    _check_settings(settings)
    if settings.instance_materials and any(settings.instance_materials):
        raise ValueError("the frozen frame covers palette materials only")
    q = _bf16 if lowp else (lambda x: x)
    H, W = settings.height, settings.width
    n = H * W
    dev = scene.device
    frame_index = state.frame_index
    rand = _pcg_scalar(frame_index)
    layer = frame_index % bn_cosine.shape[0]
    to_tiles, from_tiles = _tiling(H, W, True)
    dense = settings.gi_cache == "dense"
    cell_size = settings.spatial_hash.cell_size
    gi = _gi_enabled(settings)
    trace = hdda.trace_scene

    def fill(mask, yes, no):
        return torch.where(mask, yes, no).float()

    # -------------------------------------------------- 1. primary
    dirs = q(to_tiles(cameralib.camera_ray_dirs(cam, W, H)))
    origins = q(cam.position.expand(n, 3).contiguous())
    primary = trace(scene, origins, dirs, cam.near, cam.far, "precise")
    g = dict(shade.resolve_hits(scene, primary, origins, dirs))
    for key in ("depth", "normal", "world_pos", "albedo", "motion"):
        g[key] = q(g[key])
    hit = g["hit"]

    dirs_n = dirs / pk.norm3(dirs, keepdim=True)
    sky_out = (skylib.sky_radiance(sky_state, dirs_n)
               + skylib.sun_radiance(sky_state, dirs_n)) / 3.14

    # -------------------------------------------------- 2. sun NEE
    normal = g["normal"]
    hit_loc = q(fma(normal, torch.full_like(normal, 0.01), g["world_pos"]))
    sun_dir = sky_state.direction
    strength = skylib.sun_radiance(sky_state, sun_dir[None])[0] * (
        1.0 - torch.cos(sky_state.solar_radius))
    direct = torch.zeros((n, 3), device=dev)
    if settings.contribution_direct:
        ndl = (normal * sun_dir).sum(dim=-1)
        facing = (ndl > 0.0) & hit
        sthr = settings.ambient_occlusion_threshold
        sun_rays = sun_dir.expand(n, 3)
        s_tmax = fill(facing, 10000.0, -1.0)
        if settings.shadow_mode == "precise":
            occluded = trace(scene, hit_loc, sun_rays, 0.1, s_tmax,
                             "precise").hit
        elif fused_sun:
            s_ao, s_fg = hdda.trace_scene_ao_fg(
                scene, hit_loc, sun_rays, 0.1, fill(facing, sthr, -1.0),
                s_tmax)
            occluded = s_ao.hit | s_fg.hit
        else:
            occluded = (
                trace(scene, hit_loc, sun_rays, 0.1, fill(facing, sthr, -1.0),
                      "ao_threshold").hit
                | trace(scene, hit_loc, sun_rays, sthr, s_tmax, "rough").hit)
        unoccluded = facing & ~occluded
        direct = direct + torch.where(
            unoccluded[:, None], strength * torch.clamp(ndl, min=0.0)[:, None],
            0.0)
    direct = q(direct)

    if not gi:
        hitdist = torch.where(hit, 0.0, 100000.0)
        radiance_img = torch.where(hit[:, None], direct, sky_out)
        surfels, new_gi, new_gi_ws = state.surfels, state.gi, state.gi_ws
    else:
        # ---------------------------------------------- 3. AO + final gather
        cos_sample = to_tiles(noiselib.bn_fetch(
            bn_cosine, layer, (7, 183), rand, H, W)) * 2.0 - 1.0
        gi_dir = pk.rotate_vector_by_normal(normal, cos_sample)
        gi_dir = q(torch.where(hit[:, None], gi_dir,
                               gi_dir.new_tensor([0.0, 1.0, 0.0])))
        thr = settings.ambient_occlusion_threshold
        ao = trace(scene, hit_loc, gi_dir, 0.1, fill(hit, thr, -1.0),
                   "ao_threshold")
        ao_hit = ao.hit
        fg_active = hit & ~ao_hit
        fg = trace(scene, hit_loc, gi_dir, thr,
                   torch.where(fg_active, cam.far, -1.0), "rough")
        fg_hit = fg_active & fg.hit

        if dense:
            gi_reads, new_gi_ws = state.gi, state.gi_ws
        else:
            gi_reads, new_gi_ws = _working_set(scene, state, settings,
                                               frame_index)
        face = shade.entry_face(scene, fg, hit_loc, gi_dir)
        _found, cached, cnt, alb_u32 = gilib.dense_get(
            gi_reads, gilib.dense_index(scene, fg.inst, fg.row, face),
            fg_hit)
        albedo_lin = colorlib.srgb_eotf(unpack_r10g10b10a2(alb_u32)[:, :3])
        indirect = colorlib.srgb_to_acescg(
            colorlib.acescg_to_srgb(cached) * albedo_lin)
        illum = torch.zeros((n, 3), device=dev)
        if settings.contribution_secondary_spatial_hash:
            illum = illum + torch.where(fg_hit[:, None], indirect, 0.0)
        if settings.contribution_secondary_skylight:
            illum = illum + torch.where(
                (fg_active & ~fg.hit)[:, None],
                skylib.sky_radiance(sky_state, gi_dir), 0.0)
        illum = q(illum)

        surfels = state.surfels
        if not dense:
            p_sched = 1.0 / (cnt + 2.0)
            noise0 = to_tiles(noiselib.bn_fetch(
                bn_scalar, layer, (34, 21), rand, H, W))[:, 0]
            enqueue = fg_hit & (noise0 > p_sched)
            center_fg = shade.entry_leaf_center(scene, fg, hit_loc, gi_dir)
            rows = torch.cat([center_fg, face.float()[:, None]], dim=-1)
            surfels = _pool_enqueue_mod(surfels, enqueue, rows)
        if settings.debug_visualize_spatial_hash:
            raise ValueError("the frozen frame has no debug view")

        hitdist = torch.where(ao_hit, ao.t, 0.0)
        hitdist = torch.where(fg_hit, fg.t, hitdist)
        radiance_img = torch.where(hit[:, None], direct + illum, sky_out)
        hitdist = q(torch.where(hit, hitdist, 100000.0))

        # ---------------------------------------------- 4. surfel refresh
        slice_start = None
        if dense:
            centers_w, vleaf = _cell_enumeration(scene)
            C = centers_w.shape[0]
            surfel_pos = centers_w.repeat(6, 1)
            surfel_dir = torch.arange(6, dtype=torch.int32, device=dev)[
                :, None].expand(6, C).reshape(-1)
            s_valid = vleaf.repeat(6)
            rows_total = surfel_pos.shape[0]
            budget = settings.surfels.dense_refresh_budget
            if budget and rows_total > budget:
                nslices = -(-rows_total // budget)
                slice_start = min((frame_index % nslices) * budget,
                                  rows_total - budget)
                window = slice(slice_start, slice_start + budget)
                surfel_pos = surfel_pos[window]
                surfel_dir = surfel_dir[window]
                s_valid = s_valid[window]
        else:
            pool_rows = surfels
            pbudget = settings.surfels.pool_refresh_budget
            if pbudget and surfels.shape[0] > pbudget:
                nslices = -(-surfels.shape[0] // pbudget)
                slice_start = min((frame_index % nslices) * pbudget,
                                  surfels.shape[0] - pbudget)
                pool_rows = surfels[slice_start:slice_start + pbudget]
            surfel_pos = pool_rows[:, :3]
            surfel_dir = pool_rows[:, 3].int()
            s_valid = surfel_dir < 6
            surfel_dir = torch.clamp(surfel_dir, max=5)
        p = surfel_pos.shape[0]
        s_normal = pk.face_id_to_normal(surfel_dir)
        s_origin = q(fma(torch.full_like(s_normal, 2.01), s_normal,
                         surfel_pos))
        s_cos = noiselib.bn_fetch_pool(bn_cosine, layer, (16, 47), rand,
                                       p) * 2.0 - 1.0
        s_dir = q(pk.rotate_vector_by_normal(s_normal, s_cos))

        s_payload = torch.zeros((p, 3), device=dev)
        if settings.contribution_secondary_sunlight:
            s_ndl = (s_normal * sun_dir).sum(dim=-1)
            s_facing = (s_ndl > 0.0) & s_valid
            s_shadow = trace(scene, s_origin, sun_dir.expand(p, 3), 0.1,
                             fill(s_facing, 10000.0, -1.0), "rough")
            s_unocc = s_facing & ~s_shadow.hit
            s_payload = s_payload + torch.where(
                s_unocc[:, None],
                strength * torch.clamp(s_ndl, min=0.0)[:, None], 0.0)

        s_res = trace(scene, s_origin, s_dir, 0.1,
                      fill(s_valid, 10000.0, -1.0), "rough")
        s_hit = s_valid & s_res.hit
        s_face = shade.entry_face(scene, s_res, s_origin, s_dir)
        s_found, s_cached, s_cnt, s_alb_u32 = gilib.dense_get(
            gi_reads, gilib.dense_index(scene, s_res.inst, s_res.row,
                                        s_face), s_hit)
        s_albedo_lin = colorlib.srgb_eotf(
            unpack_r10g10b10a2(s_alb_u32)[:, :3])
        s_bounce = colorlib.srgb_to_acescg(
            colorlib.acescg_to_srgb(s_cached) * s_albedo_lin)
        s_sky = skylib.sky_radiance(sky_state, s_dir / torch.clamp(
            pk.norm3(s_dir, keepdim=True), min=1e-8))
        insert_val = q(torch.where(s_hit[:, None], s_bounce + s_payload,
                                   s_sky + s_payload))
        insert_ok = s_valid & (~s_hit | s_found)
        if dense and slice_start is None:
            new_gi = gilib.dense_update(state.gi, insert_val, insert_ok)
        elif dense:
            new_gi = gilib.dense_update_slice(state.gi, slice_start,
                                              insert_val, insert_ok)
        else:
            new_gi = sh.hash_insert(
                state.gi,
                *sh.spatial_hash_key(surfel_pos, surfel_dir, cell_size),
                insert_val, frame_index, valid=insert_ok,
                max_updates=settings.spatial_hash.insert_cap or None)
            s_noise = noiselib.bn_fetch_pool(bn_scalar, layer, (114, 40),
                                             rand, p)[:, 0]
            s_requeue = s_hit & ~s_found & (s_noise > 1.0 / (s_cnt + 2.0))
            s_center = shade.entry_leaf_center(scene, s_res, s_origin, s_dir)
            requeued = torch.where(
                s_requeue[:, None],
                torch.cat([s_center, s_face.float()[:, None]], dim=-1),
                pool_rows)
            if slice_start is None:
                surfels = requeued
            else:
                surfels = surfels.clone()
                surfels[slice_start:slice_start + p] = requeued

    radiance_img = q(radiance_img)

    # -------------------------------------------------- 5. post
    half = _half_res(settings)
    split = half or settings.denoiser.split_direct
    chans = dict(depth=g["depth"], albedo=g["albedo"][:, :3], hitdist=hitdist,
                 normal=normal, world_pos=g["world_pos"], motion=g["motion"],
                 voxel_id=g["voxel_id"], radiance=radiance_img)
    if gi and split:
        chans.update(ind=torch.where(hit[:, None], illum, 0.0),
                     comp=torch.where(hit[:, None], direct, sky_out))
    img = {name: from_tiles(v) for name, v in chans.items()}

    dep2 = img["depth"]
    valid2 = torch.isfinite(dep2)
    if not gi:
        denoised = img["radiance"]
        new_den = state.denoiser
    elif not half:
        rad2 = img["ind"] if split else img["radiance"]
        den, _hd, new_den = denoiselib.denoise(
            state.denoiser, rad2, img["hitdist"], dep2, img["normal"],
            img["world_pos"], img["motion"], state.prev_view_proj,
            settings.denoiser)
        denoised = (torch.where(valid2[..., None], den, 0.0)
                    + img["comp"]) if split else den
    else:
        rh, hh, dh, nh, wh, mh = denoiselib.downsample_inputs(
            img["ind"], img["hitdist"], dep2, img["normal"],
            img["world_pos"], img["motion"])
        den_settings = dataclasses.replace(
            settings.denoiser,
            atrous_iterations=max(settings.denoiser.atrous_iterations - 1, 1))
        den_h, hd_h, new_den = denoiselib.denoise(
            state.denoiser, rh, hh, dh, nh, wh, mh, state.prev_view_proj,
            den_settings)
        ind_full, _hd = denoiselib.upsample_bilateral(
            den_h, hd_h, dh, nh, dep2, img["normal"])
        denoised = torch.where(valid2[..., None], ind_full, 0.0) + img["comp"]
    denoised = q(denoised)

    weighted = exposurelib.mean_bin(denoised, settings.exposure)
    new_avg = exposurelib.adapt_average_luminance(
        None, state.exposure_avg, n, settings.exposure, weighted=weighted)
    exposure = q(exposurelib.exposure_value(new_avg))
    output = q(tonemaplib.tonemap(denoised, img["albedo"], exposure, "srgb"))

    aux = dict(depth=dep2, albedo=img["albedo"], normal=img["normal"],
               motion=img["motion"], voxel_id=img["voxel_id"],
               radiance=img["radiance"], hitdist=img["hitdist"],
               denoised=denoised, exposure=exposure)
    new_state = FrameState(
        gi=new_gi, surfels=surfels, denoiser=new_den,
        exposure_avg=new_avg, frame_index=frame_index + 1,
        prev_view_proj=cam.view_proj, gi_ws=new_gi_ws)
    return output, aux, new_state


def frame_ray_count(scene, settings: RenderSettings) -> int:
    """Rays per frame as the reference's bench counts them: four
    full-resolution launches plus two rays per surfel. Hash mode: per
    pool slot, or per slot of the frame's slice under a pool budget.
    Dense mode: per valid cache cell, or, under a refresh budget, per
    valid cell of the frame's slice (``budget`` rows times the valid
    fraction of all rows). Without GI, the primary and shadow launches
    alone."""
    if not _gi_enabled(settings):
        return settings.width * settings.height * 2
    if settings.gi_cache != "dense":
        pool = settings.surfels.pool_size
        budget = settings.surfels.pool_refresh_budget
        patch = min(pool, budget) if budget else pool
        return settings.width * settings.height * 4 + patch * 2
    valid = (scene.mask_lo | scene.mask_hi) != 0
    counts = valid.sum(dim=1).tolist()
    patch_cells = sum(counts[m] for m in scene.inst_model) * 6
    total_rows = gilib.dense_rows(scene)
    budget = settings.surfels.dense_refresh_budget
    if budget and total_rows > budget:
        patch_cells = int(budget * patch_cells / total_rows)
    return settings.width * settings.height * 4 + patch_cells * 2
