"""The per-frame render pipeline (port of :mod:`dust_tpu.render.pipeline`).

Both of the reference's GI caches: the dense cache (one row per
(instance, leaf, face) cell, every cell refreshed each frame; the
headline frame) and the spatial hash (the renderer's default; a surfel
pool refreshes it). Per frame:

1. **primary** — precise trace from the camera; the G-buffer; misses
   write sky radiance straight to the output.
2. **sun NEE** — ``shadow_mode="reference"``: a precise walk to the AO
   threshold, then block-granular (rough) hits past it; on the
   ``pallas`` backend one fused ao_fg launch. ``"precise"``: one precise
   walk to 10000.
3. **AO** then **final gather** — one cosine ray per hit (blue noise),
   traced to the AO threshold, then continued rough; final-gather hits
   read the GI cache. The hash frame first probes the hash once per
   cell into dense-cache rows (the working set), so its reads are the
   dense gather too, and enqueues hit cells into the surfel pool by
   blue noise.
4. **surfel refresh** — dense: every (instance, leaf, face) cell shoots
   a sun ray and a cosine ray and folds the result into its cache row;
   when the cache has more rows than ``dense_refresh_budget``, a
   rotating slice of that many rows per frame. Hash: every valid pool
   surfel (or a rotating ``pool_refresh_budget`` slice) does the same
   and inserts at its own cell; hit cells not yet cached requeue.
5. **post** — temporal + à-trous denoise of the indirect at half
   resolution with a joint-bilateral upsample, or at full resolution
   (the indirect alone with ``split_direct``, else direct and indirect
   together), then auto-exposure and ACES tonemap.

With every secondary contribution off (and no debug view) steps 3-4 and
the denoiser do not exist: the primary+shadow frame. Traces go through
``traversal_backend``: ``"pallas"``, the HDDA kernel
(:mod:`dust_tpu_torch.ops.hdda`; ``DUST_PALLAS_SCENE=loop`` takes its
per-instance route), or ``"jnp"``, the eager torch wavefront
(:mod:`dust_tpu_torch.ops.traverse`), which has no kernel. Registered
``instance_materials`` (:mod:`dust_tpu_torch.render.materials`) refine
the primary hits' shading, and their emission joins the direct
channel. The slices of the working set and the pool are chosen on
the host from the Python ``frame_index``, so the frame branches on no
tensor's value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dust_tpu_torch import parallel
from dust_tpu_torch.config import RenderSettings
from dust_tpu_torch.ops import camera as cameralib
from dust_tpu_torch.ops import denoise as denoiselib
from dust_tpu_torch.ops import exposure as exposurelib
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops import noise as noiselib
from dust_tpu_torch.ops import packing as pk
from dust_tpu_torch.ops import shade
from dust_tpu_torch.ops import sky as skylib
from dust_tpu_torch.ops import spatial_hash as sh
from dust_tpu_torch.ops import tonemap as tonemaplib
from dust_tpu_torch.ops.fp import fma
from dust_tpu_torch.ops import hdda
from dust_tpu_torch.ops import traverse
from dust_tpu_torch.render.materials import apply_materials
from dust_tpu_torch.utils import color as colorlib
from dust_tpu_torch.vox.geometry import unpack_r10g10b10a2

__all__ = ["FrameState", "make_frame_state", "render_frame",
           "state_from_numpy", "frame_ray_count"]

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


def state_from_numpy(fields: dict, device) -> FrameState:
    """Carry a reference :class:`dust_tpu.render.pipeline.FrameState`
    into the port. ``fields``: ``gi`` (the cache table: (R, 3) dense rows
    or the hash's (C/4, 16) group rows), ``surfels``, ``denoiser`` (the
    packed history), ``exposure_avg``, ``frame_index``,
    ``prev_view_proj``, and in hash mode ``gi_ws`` (the working set's
    table, or None), as numpy arrays."""
    def t(a, dtype):
        a = np.array(a, copy=True, order="C")
        a = a.view(dtype) if a.dtype.kind in "ui" else a.astype(dtype)
        return torch.from_numpy(a).to(device)

    table = t(fields["gi"], np.int32)
    gi_ws = fields.get("gi_ws")
    return FrameState(
        gi=(sh.SpatialHash(table=table) if table.shape[1] == 16
            else gilib.DenseGICache(table=table)),
        surfels=t(fields["surfels"], np.float32),
        denoiser=denoiselib.DenoiserState(history=t(fields["denoiser"],
                                                    np.int32)),
        exposure_avg=t(fields["exposure_avg"], np.float32),
        frame_index=int(fields["frame_index"]),
        prev_view_proj=t(fields["prev_view_proj"], np.float32),
        gi_ws=None if gi_ws is None else gilib.DenseGICache(
            table=t(gi_ws, np.int32)),
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


def _gather_trace(mesh, res: traverse.TraceResult,
                  length: int) -> traverse.TraceResult:
    """Every rank's trace results of an axis of ``length``, in order (one
    all-gather of t's bits beside the three int32 fields)."""
    w = parallel.gather_rows(mesh, torch.stack(
        [res.t.view(torch.int32), res.inst, res.row, res.bit], dim=-1),
        length)
    return traverse.TraceResult(t=w[:, 0].contiguous().view(torch.float32),
                                inst=w[:, 1], row=w[:, 2], bit=w[:, 3])


def _gather_columns(mesh, chans: dict, length: int) -> dict:
    """Every rank's rows of per-ray ``chans`` (float32 or int32 tensors
    with a leading ray axis of the rank's chunk of ``length``), in one
    all-gather."""
    flat = [v.reshape(v.shape[0], -1) for v in chans.values()]
    packed = torch.cat([f.view(torch.float32) if f.dtype == torch.int32
                        else f.float() for f in flat], dim=-1)
    whole = parallel.gather_rows(mesh, packed, length)
    out, k = {}, 0
    for (name, v), f in zip(chans.items(), flat):
        w = whole[:, k:k + f.shape[1]]
        k += f.shape[1]
        if v.dtype == torch.int32:
            w = w.contiguous().view(torch.int32)
        out[name] = w.reshape((length,) + v.shape[1:])
    return out


def render_frame(scene, state: FrameState, cam: cameralib.CameraSettings,
                 sky_state: skylib.SkyModelState, bn_cosine: torch.Tensor,
                 bn_scalar: torch.Tensor, settings: RenderSettings,
                 tile: int = 16384, return_aux: bool = True, mesh=None):
    """Render one frame. Returns (output_srgb (H, W, 3), aux dict, new
    state). ``bn_cosine``: the (64, 128, 128, 3) cosine blue-noise table;
    ``bn_scalar``: the (64, 128, 128, 1) scalar table (the hash frame's
    enqueue and requeue draws). ``tile``: rays per walk of the ``"jnp"``
    backend (bounds its memory; no result depends on it).

    ``mesh`` (:class:`dust_tpu_torch.parallel.Mesh`): the ray-sharded
    frame. ``scene`` is replicated and ``state`` sharded
    (:func:`~dust_tpu_torch.parallel.shard_frame_state`); the rank traces
    its chunk of the rays, in the order they are traced (8×128 tiles on
    the kernel's backend), and computes its chunk of the image rows
    (:func:`~dust_tpu_torch.parallel.ray_sharding` over H); the output
    and the aux images are those rows
    (:func:`~dust_tpu_torch.parallel.gather_image` assembles them). On the
    kernel's backend each trace pads the rank's rays to the chunk size
    with inactive rays, and reference-mode sun shadows take the two
    launches (ao_threshold, rough) in place of the fused ao_fg, as the
    reference's sharded frame does (a grazing sun ray may end otherwise
    than in the fused walk). Besides, only the exposure's float sum (one
    all-reduce) and, at more than 2 instances, the sweep order (the mean
    of the rank's ray origins) can round otherwise than in the frame
    without a mesh."""
    _check_settings(settings)
    H, W = settings.height, settings.width
    n = H * W
    dev = scene.device
    frame_index = state.frame_index
    rand = _pcg_scalar(frame_index)
    layer = frame_index % bn_cosine.shape[0]
    pallas = settings.traversal_backend == "pallas"
    to_tiles, from_tiles = _tiling(H, W, pallas)
    dense = settings.gi_cache == "dense"
    cell_size = settings.spatial_hash.cell_size
    gi = _gi_enabled(settings)
    sharded = mesh is not None
    lo, hi = parallel.ray_sharding(mesh, n) if sharded else (0, n)
    m = hi - lo

    def fill(mask, yes, no):
        return torch.where(mask, yes, no).float()

    def trace(o, d, t_min, t_max, mode, length=n):
        """Trace the rank's rays of an axis of ``length``."""
        if not pallas:
            return traverse.trace_scene_tiled(scene, o, d, t_min, t_max,
                                              mode=mode, tile=tile)
        if not sharded:
            return hdda.trace_scene(scene, o, d, t_min, t_max, mode)
        k = o.shape[0]
        res = hdda.trace_scene(scene, *parallel.pad_rays(
            mesh, length, o, d, t_min, t_max), mode)
        return traverse.TraceResult(*(x[:k] for x in res))

    # -------------------------------------------------- 1. primary
    dirs = to_tiles(cameralib.camera_ray_dirs(cam, W, H))[lo:hi]
    origins = cam.position.expand(m, 3).contiguous()
    primary = trace(origins, dirs, cam.near, cam.far, "precise")
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
        sun_rays = sun_dir.expand(m, 3)
        s_tmax = fill(facing, 10000.0, -1.0)
        if settings.shadow_mode == "precise":
            occluded = trace(hit_loc, sun_rays, 0.1, s_tmax, "precise").hit
        elif pallas and not sharded:
            s_ao, s_fg = hdda.trace_scene_ao_fg(
                scene, hit_loc, sun_rays, 0.1, fill(facing, sthr, -1.0),
                s_tmax)
            occluded = s_ao.hit | s_fg.hit
        else:
            occluded = (trace(hit_loc, sun_rays, 0.1,
                              fill(facing, sthr, -1.0), "ao_threshold").hit
                        | trace(hit_loc, sun_rays, sthr, s_tmax, "rough").hit)
        unoccluded = facing & ~occluded
        direct = direct + torch.where(
            unoccluded[:, None], strength * torch.clamp(ndl, min=0.0)[:, None],
            0.0)

    if not gi:
        # The primary+shadow frame: no AO, final-gather or surfel pass,
        # and (below) no denoiser; the cache and pool carry unchanged.
        hitdist = torch.where(hit, 0.0, 100000.0)
        radiance_img = torch.where(hit[:, None], direct, sky_out)
        surfels, new_gi, new_gi_ws = state.surfels, state.gi, state.gi_ws
    else:
        # ---------------------------------------------- 3. AO + final gather
        cos_sample = to_tiles(noiselib.bn_fetch(
            bn_cosine, layer, (7, 183), rand, H, W))[lo:hi] * 2.0 - 1.0
        gi_dir = pk.rotate_vector_by_normal(normal, cos_sample)
        gi_dir = torch.where(hit[:, None], gi_dir,
                             gi_dir.new_tensor([0.0, 1.0, 0.0]))
        thr = settings.ambient_occlusion_threshold
        ao = trace(hit_loc, gi_dir, 0.1, fill(hit, thr, -1.0), "ao_threshold")
        ao_hit = ao.hit
        fg_active = hit & ~ao_hit
        fg = trace(hit_loc, gi_dir, thr,
                   torch.where(fg_active, cam.far, -1.0), "rough")
        fg_hit = fg_active & fg.hit

        if dense:
            gi_reads, new_gi_ws = state.gi, state.gi_ws
            if sharded:
                # The rays read any row: one all-gather of the
                # row-sharded table gives the replicated read view.
                gi_reads = gilib.DenseGICache(table=parallel.gather_rows(
                    mesh, state.gi.table, gilib.dense_rows(scene)))
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
        illum = torch.zeros((m, 3), device=dev)
        if settings.contribution_secondary_spatial_hash:
            illum = illum + torch.where(fg_hit[:, None], indirect, 0.0)
        if settings.contribution_secondary_skylight:
            illum = illum + torch.where(
                (fg_active & ~fg.hit)[:, None],
                skylib.sky_radiance(sky_state, gi_dir), 0.0)

        surfels = state.surfels
        if not dense:
            # Stochastic enqueue of final-gather hit cells: pool slot =
            # ray index % pool size, the lowest index wins.
            p_sched = 1.0 / (cnt + 2.0)
            noise0 = to_tiles(noiselib.bn_fetch(
                bn_scalar, layer, (34, 21), rand, H, W))[lo:hi, 0]
            enqueue = fg_hit & (noise0 > p_sched)
            center_fg = shade.entry_leaf_center(scene, fg, hit_loc, gi_dir)
            rows = torch.cat([center_fg, face.float()[:, None]], dim=-1)
            if sharded:
                # The pool is replicated: every rank enqueues every
                # rank's candidates, in the global ray order.
                both = parallel.gather_rows(mesh, torch.cat(
                    [enqueue.float()[:, None], rows], dim=-1), n)
                enqueue, rows = both[:, 0] > 0.0, both[:, 1:]
            surfels = _pool_enqueue_mod(surfels, enqueue, rows)
        if settings.debug_visualize_spatial_hash:
            # Show the cache: the primary hit cell's cached radiance.
            dbg = shade.leaf_attributes(scene, primary, origins, dirs,
                                        cell_size)
            if dense:
                _, dbg_rad, _, _ = gilib.dense_get(
                    gi_reads, gilib.dense_index(scene, primary.inst,
                                                primary.row, dbg["face"]), hit)
            else:
                _, dbg_rad, _ = sh.hash_get(state.gi, dbg["qpos"],
                                            dbg["face"])
            illum = torch.where(hit[:, None], dbg_rad, illum)

        hitdist = torch.where(ao_hit, ao.t, 0.0)
        hitdist = torch.where(fg_hit, fg.t, hitdist)
        radiance_img = torch.where(hit[:, None], direct + illum, sky_out)
        hitdist = torch.where(hit, hitdist, 100000.0)

        # ---------------------------------------------- 4. surfel refresh
        slice_start = None
        if dense:
            # The pool is the cell list, face-major: row = face * cells +
            # cell.
            centers_w, vleaf = _cell_enumeration(scene)
            C = centers_w.shape[0]
            surfel_pos = centers_w.repeat(6, 1)
            surfel_dir = torch.arange(6, dtype=torch.int32, device=dev)[
                :, None].expand(6, C).reshape(-1)
            s_valid = vleaf.repeat(6)
            # Refresh budget: big scenes patch a rotating contiguous slice
            # of ``budget`` rows per frame.
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
            # The pool, or under a refresh budget its rotating slice.
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
        s_origin = fma(torch.full_like(s_normal, 2.01), s_normal, surfel_pos)
        s_cos = noiselib.bn_fetch_pool(bn_cosine, layer, (16, 47), rand,
                                       p) * 2.0 - 1.0
        s_dir = pk.rotate_vector_by_normal(s_normal, s_cos)
        # Sharded: the rank traces its chunk of the p surfel rays. Dense
        # goes on with that chunk (without a budget, its rows are the
        # rank's rows of the table); the hash pool is replicated, so
        # every rank gathers every rank's trace results.
        s_lo, s_hi = parallel.ray_sharding(mesh, p) if sharded else (0, p)
        if sharded and dense:
            surfel_pos, surfel_dir, s_valid, s_normal, s_origin, s_dir = (
                x[s_lo:s_hi] for x in (surfel_pos, surfel_dir, s_valid,
                                       s_normal, s_origin, s_dir))

        def trace_surfels(o, d, t_max):
            if not sharded or dense:
                return trace(o, d, 0.1, t_max, "rough", length=p)
            res = trace(o[s_lo:s_hi], d[s_lo:s_hi], 0.1, t_max[s_lo:s_hi],
                        "rough", length=p)
            return _gather_trace(mesh, res, p)

        k = s_origin.shape[0]
        s_payload = torch.zeros((k, 3), device=dev)
        if settings.contribution_secondary_sunlight:
            s_ndl = (s_normal * sun_dir).sum(dim=-1)
            s_facing = (s_ndl > 0.0) & s_valid
            s_shadow = trace_surfels(s_origin, sun_dir.expand(k, 3),
                                     fill(s_facing, 10000.0, -1.0))
            s_unocc = s_facing & ~s_shadow.hit
            s_payload = s_payload + torch.where(
                s_unocc[:, None],
                strength * torch.clamp(s_ndl, min=0.0)[:, None], 0.0)

        s_res = trace_surfels(s_origin, s_dir, fill(s_valid, 10000.0, -1.0))
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
        # Insert at the surfel's own cell: the bounce on a cached hit, the
        # sky on a miss.
        insert_val = torch.where(s_hit[:, None], s_bounce + s_payload,
                                 s_sky + s_payload)
        insert_ok = s_valid & (~s_hit | s_found)
        if dense and slice_start is None:
            new_gi = gilib.dense_update(state.gi, insert_val, insert_ok)
        elif dense and sharded:
            # The budget's window is not aligned with the table's shards:
            # gather its results, then each rank updates the rows it owns.
            both = parallel.gather_rows(mesh, torch.cat(
                [insert_val, insert_ok.float()[:, None]], dim=-1), p)
            r0, _ = parallel.ray_sharding(mesh, gilib.dense_rows(scene))
            new_gi = gilib.dense_update_rows(state.gi, r0, slice_start,
                                             both[:, :3], both[:, 3] > 0.0)
        elif dense:
            new_gi = gilib.dense_update_slice(state.gi, slice_start,
                                              insert_val, insert_ok)
        else:
            new_gi = sh.hash_insert(
                state.gi,
                *sh.spatial_hash_key(surfel_pos, surfel_dir, cell_size),
                insert_val, frame_index, valid=insert_ok,
                max_updates=settings.spatial_hash.insert_cap or None)
            # A hit cell not in the cache requeues into the surfel's own
            # slot.
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

    # -------------------------------------------------- 5. post
    # The per-ray channels the post reads, as images. Sharded: one
    # all-gather assembles every rank's rays on every rank; each pass
    # then computes the rank's rows.
    half = _half_res(settings)
    split = half or settings.denoiser.split_direct
    chans = dict(depth=g["depth"], albedo=g["albedo"][:, :3])
    if gi:
        chans.update(hitdist=hitdist, normal=normal, world_pos=g["world_pos"],
                     motion=g["motion"])
    if gi and split:
        chans.update(ind=torch.where(hit[:, None], illum, 0.0),
                     comp=torch.where(hit[:, None], direct, sky_out))
    if not (gi and split) or return_aux:
        chans["radiance"] = radiance_img
    if return_aux:
        chans.update(hitdist=hitdist, normal=normal, motion=g["motion"],
                     voxel_id=g["voxel_id"])
    if sharded:
        chans = _gather_columns(mesh, chans, n)
    img = {name: from_tiles(v) for name, v in chans.items()}

    row_lo, row_hi = parallel.ray_sharding(mesh, H) if sharded else (0, H)
    own = slice(row_lo, row_hi)

    def around(lo_, hi_, length):
        """Rows [lo_, hi_) and one more on each side, in the image."""
        return slice(max(lo_ - 1, 0), min(hi_ + 1, length))

    def den_rows(lo_, hi_, length):
        """The denoiser's keyword ``rows`` for image rows [lo_, hi_) of
        ``length``; none (the whole image) without a mesh."""
        if not sharded:
            return {}
        return dict(rows=(lo_, hi_, lambda x: parallel.gather_rows(
            mesh, x, length)))

    dep2 = img["depth"]
    valid2 = torch.isfinite(dep2[own])
    if not gi:
        # Direct light alone is deterministic: nothing to denoise.
        denoised = img["radiance"][own]
        new_den = state.denoiser
    elif not half:
        # Full resolution: the indirect alone rides the temporal chain and
        # direct composes after (split_direct: the half-res estimator at
        # full resolution), or both through the denoiser together, as the
        # reference's REBLUR input.
        rad2 = img["ind"] if split else img["radiance"]
        den, _hd, new_den = denoiselib.denoise(
            state.denoiser, rad2[around(row_lo, row_hi, H)],
            img["hitdist"][own], dep2[own], img["normal"][own],
            img["world_pos"][own], img["motion"][own], state.prev_view_proj,
            settings.denoiser, **den_rows(row_lo, row_hi, H))
        denoised = (torch.where(valid2[..., None], den, 0.0)
                    + img["comp"][own]) if split else den
    else:
        # Half resolution: the rank's half-res rows [lo_h, hi_h); its
        # full-res rows read the half-res rows [up_lo, up_hi) in the
        # upsample; the downsample covers both with the denoiser's
        # one-row margin.
        Hh = H // 2
        lo_h, hi_h = parallel.ray_sharding(mesh, Hh) if sharded else (0, Hh)
        up_lo, up_hi = max(0, row_lo // 2 - 1), min(Hh, (row_hi - 1) // 2 + 2)
        a = min(max(lo_h - 1, 0), up_lo)
        b = max(min(hi_h + 1, Hh), up_hi)
        full = slice(2 * a, 2 * b)
        rh, hh, dh, nh, wh, mh = denoiselib.downsample_inputs(
            img["ind"][full], img["hitdist"][full], dep2[full],
            img["normal"][full], img["world_pos"][full], img["motion"][full])
        mine = slice(lo_h - a, hi_h - a)
        win = around(lo_h, hi_h, Hh)
        # One fewer à-trous iteration at half res (same world-space
        # footprint).
        den_settings = dataclasses.replace(
            settings.denoiser,
            atrous_iterations=max(settings.denoiser.atrous_iterations - 1, 1))
        den_h, hd_h, new_den = denoiselib.denoise(
            state.denoiser, rh[win.start - a:win.stop - a], hh[mine],
            dh[mine], nh[mine], wh[mine], mh[mine], state.prev_view_proj,
            den_settings, **den_rows(lo_h, hi_h, Hh))
        if sharded:
            both = parallel.gather_rows(
                mesh, torch.cat([den_h, hd_h[..., None]], dim=-1), Hh)
            den_h, hd_h = both[..., :3], both[..., 3]
        up = slice(up_lo - a, up_hi - a)
        ind_full, _hd = denoiselib.upsample_bilateral(
            den_h[up_lo:up_hi], hd_h[up_lo:up_hi], dh[up], nh[up],
            dep2[2 * up_lo:2 * up_hi], img["normal"][2 * up_lo:2 * up_hi])
        ind_full = ind_full[row_lo - 2 * up_lo:row_hi - 2 * up_lo]
        denoised = torch.where(valid2[..., None], ind_full, 0.0) + \
            img["comp"][own]

    weighted = exposurelib.mean_bin(denoised, settings.exposure)
    if sharded:
        weighted = parallel.all_reduce_sum(mesh, weighted)
    new_avg = exposurelib.adapt_average_luminance(
        state.exposure_avg, n, settings.exposure, weighted)
    exposure = exposurelib.exposure_value(new_avg)
    albedo_img = img["albedo"][own]
    output = tonemaplib.tonemap(denoised, albedo_img, exposure, "srgb")

    aux = dict(
        depth=dep2[own], albedo=albedo_img, normal=img["normal"][own],
        motion=img["motion"][own], voxel_id=img["voxel_id"][own],
        radiance=img["radiance"][own], hitdist=img["hitdist"][own],
        denoised=denoised, exposure=exposure,
    ) if return_aux else {}
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
