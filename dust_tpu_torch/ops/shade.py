"""Hit-attribute resolution (port of :mod:`dust_tpu.ops.shade`): the
primary G-buffer from one voxel-row gather, the spatial-hash key of a
hit's leaf, and the analytic entry face and leaf centre of rough
hits; and the final gather around its two traces: the gather rays'
directions before them, and after them the GI-cache read at the rough
hits, the bounce, the sky, and the frame's radiance, hit distance and
indirect light."""

from __future__ import annotations

import torch

from dust_tpu_torch.ops import gbuffer
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops import noise as noiselib
from dust_tpu_torch.ops import packing as pk
from dust_tpu_torch.ops import sky as skylib
from dust_tpu_torch.ops.camera import check_ray_range
from dust_tpu_torch.ops.fp import fma
from dust_tpu_torch.ops.sky import primary_sky
from dust_tpu_torch.utils import color as colorlib
from dust_tpu_torch.vox.geometry import unpack_r10g10b10a2

__all__ = ["resolve_hits", "resolve_primary", "resolve_hits_plain",
           "leaf_attributes", "entry_face", "entry_leaf_center",
           "gather_dirs", "gather_dirs_plain", "resolve_gather",
           "resolve_gather_plain"]


def _inst_xform(arrs, inst, p, with_translation: bool):
    """Apply each ray's instance affine (a select over the few instances)."""
    px, py, pz = p.unbind(-1)

    def apply(i):
        m = arrs[i]
        o = [fma(m[k, 2], pz, fma(m[k, 0], px, m[k, 1] * py))
             for k in range(3)]
        if with_translation:
            o = [o[k] + m[k, 3] for k in range(3)]
        return o

    out = apply(0)
    for i in range(1, arrs.shape[0]):
        cand = apply(i)
        sel = inst == i
        out = [torch.where(sel, cand[k], out[k]) for k in range(3)]
    return torch.stack(out, dim=-1)


def _along(o, d, t):
    """o + d * t[:, None], one rounding per component."""
    return fma(d, t[:, None], o)


def resolve_hits(scene, res, origin_w, dir_w):
    """Per-pixel primary-hit attributes; miss lanes carry the miss values
    (albedo 1, depth inf, motion 0). :func:`resolve_primary` without the
    sky."""
    return resolve_primary(scene, res, origin_w, dir_w, None)


def resolve_primary(scene, res, origin_w, dir_w, sky_state):
    """The primary stage's G-buffer: :func:`resolve_hits`' dict, which with
    ``sky_state`` also holds ``sky_out``,
    :func:`~dust_tpu_torch.ops.sky.primary_sky` of ``dir_w``.

    CPU tensors run :func:`resolve_hits_plain`; CUDA tensors launch
    ``gbuffer_resolve_kernel`` (:mod:`dust_tpu_torch.ops.gbuffer`)."""
    if origin_w.device.type == "cpu":
        return resolve_hits_plain(scene, res, origin_w, dir_w, sky_state)
    return gbuffer.resolve(scene, res, origin_w, dir_w, sky_state)


def resolve_hits_plain(scene, res, origin_w, dir_w, sky_state=None):
    """The plain version of :func:`resolve_primary`."""
    hit = res.inst >= 0
    inst = torch.clamp(res.inst, min=0).long()
    base = torch.tensor(scene.inst_leaf_base, dtype=torch.long,
                        device=inst.device)
    flat_row = base[inst] + torch.clamp(res.row, min=0).long()

    bit = torch.clamp(res.bit, min=0).long()
    vid = flat_row * 64 + bit
    rows = scene.voxel_attr.shape[0]
    prow = scene.voxel_attr[torch.clamp(vid >> 4, 0, rows - 1)]
    rgba = torch.gather(prow, 1, (vid & 15)[:, None])[:, 0].long() & 0xFFFFFFFF

    o_obj = _inst_xform(scene.world_to_obj, inst, origin_w, True)
    d_obj = _inst_xform(scene.world_to_obj, inst, dir_w, False)
    t = torch.where(hit, res.t, 0.0)
    hit_obj = _along(o_obj, d_obj, t)

    # Leaf origin from the hit point: step 0.05 voxels into the hit voxel,
    # floor, subtract the in-leaf offset, snap to the 4-voxel lattice.
    off = torch.stack([(bit >> 4) & 3, (bit >> 2) & 3, bit & 3], dim=-1)
    dlen = pk.norm3(d_obj, keepdim=True)
    p_in = fma(d_obj / torch.clamp(dlen, min=1e-20),
               torch.full_like(dlen, 0.05), hit_obj)
    vhat = torch.floor(p_in).long()
    leaf_origin = ((vhat - off + 2) >> 2) << 2
    box_center = leaf_origin.float() + off.float() + 0.5

    normal_obj = pk.cubed_normalize(hit_obj - box_center)
    normal_w = _inst_xform(scene.obj_to_world, inst, normal_obj, False)
    normal_w = normal_w / torch.clamp(pk.norm3(normal_w, keepdim=True),
                                      min=1e-8)

    palette_idx = (rgba >> 24) & 0xFF
    albedo = torch.stack([rgba & 0xFF, (rgba >> 8) & 0xFF, (rgba >> 16) & 0xFF,
                          torch.full_like(rgba, 255)], dim=-1).float() / 255.0
    albedo = torch.where(hit[:, None], albedo, 1.0)

    hit_w = _along(origin_w, dir_w, t)
    hit_model = _along(o_obj, d_obj, t)
    prev_w = _inst_xform(scene.prev_obj_to_world, inst, hit_model, True)
    motion = torch.where(hit[:, None], prev_w - hit_w, 0.0)

    # | 8 bit voxel id | 8 bit palette | 16 bit instance | (as int64)
    voxel_id = torch.where(hit, (bit << 24) | (palette_idx << 16)
                           | (inst & 0xFFFF), 0)
    g = dict(
        hit=hit,
        inst=inst,
        depth=torch.where(hit, res.t, float("inf")),
        albedo=albedo,
        normal=torch.where(hit[:, None], normal_w, 0.0),
        motion=motion,
        voxel_id=voxel_id,
        world_pos=torch.where(hit[:, None], hit_w, 0.0),
        palette_idx=palette_idx,
    )
    if sky_state is not None:
        g["sky_out"] = primary_sky(sky_state, dir_w)
    return g


def _hit_obj(scene, res, origin_w, dir_w):
    """(inst, object-space origin and direction, object-space hit point)
    of each ray; miss lanes take instance 0 and t = 0."""
    inst = torch.clamp(res.inst, min=0).long()
    o_obj = _inst_xform(scene.world_to_obj, inst, origin_w, True)
    d_obj = _inst_xform(scene.world_to_obj, inst, dir_w, False)
    t = torch.where(res.inst >= 0, res.t, 0.0)
    return inst, o_obj, d_obj, _along(o_obj, d_obj, t)


def leaf_attributes(scene, res, origin_w, dir_w, cell_size: float = 4.0):
    """The spatial-hash key of each hit's leaf (final_gather.rchit:38-55):
    ``qpos``, the quantised world leaf centre, and ``face``, the face id
    of the leaf-box normal at the hit; also ``center_world``, the world
    leaf centre, ``aabb_normal``, that normal, and ``avg_albedo``, the
    leaf's sRGB-encoded average albedo as (N, 4) RGBA."""
    inst, _o, _d, hit_obj = _hit_obj(scene, res, origin_w, dir_w)
    model = torch.tensor(scene.inst_model, dtype=torch.long,
                         device=inst.device)[inst]
    row = torch.clamp(res.row, 0, scene.leaf_origin.shape[1] - 1).long()
    center_obj = scene.leaf_origin[model, row].float() + 2.0
    n_world = _inst_xform(scene.obj_to_world, inst, hit_obj - center_obj,
                          False)
    center_w = _inst_xform(scene.obj_to_world, inst, center_obj, True)
    normal = pk.cubed_normalize(n_world)
    return dict(hit=res.inst >= 0,
                qpos=torch.trunc(center_w / cell_size).int(),
                face=pk.normal_to_face_id(normal),
                center_world=center_w, aabb_normal=normal,
                avg_albedo=unpack_r10g10b10a2(scene.avg_albedo[model, row]))


def entry_leaf_center(scene, res, origin_w, dir_w):
    """World centre of a rough hit's leaf: the hit lies on the leaf box's
    entry face, so a step of 0.05 voxels into the leaf, floored to the
    4-voxel lattice, gives the leaf origin."""
    inst, _o, d_obj, hit_obj = _hit_obj(scene, res, origin_w, dir_w)
    dlen = pk.norm3(d_obj, keepdim=True)
    p_in = fma(d_obj / torch.clamp(dlen, min=1e-20),
               torch.full_like(dlen, 0.05), hit_obj)
    center_obj = torch.floor(p_in * 0.25) * 4.0 + 2.0
    return _inst_xform(scene.obj_to_world, inst, center_obj, True)


def entry_face(scene, res, origin_w, dir_w):
    """World-space cube-face id of a rough hit: the hit lies on a block
    grid plane; the entry axis is the one nearest that grid and the face
    opposes the ray."""
    inst, _o, d_obj, hit_obj = _hit_obj(scene, res, origin_w, dir_w)

    v = hit_obj * 0.25
    fr = (v - torch.round(v)).abs()
    ax_y = (fr[:, 1] <= fr[:, 0]) & (fr[:, 1] <= fr[:, 2])
    ax_z = ~ax_y & (fr[:, 2] <= fr[:, 0]) & (fr[:, 2] <= fr[:, 1])
    ax_x = ~ax_y & ~ax_z
    axes = torch.stack([ax_x, ax_y, ax_z], dim=-1).float()
    n_obj = -torch.sign(d_obj) * axes
    n_world = _inst_xform(scene.obj_to_world, inst, n_obj, False)
    return pk.normal_to_face_id(pk.cubed_normalize(n_world))


def gather_dirs(normal, hit, bn_cosine, layer: int, offset, rand: int,
                width: int, height: int, tiled: bool, lo: int, hi: int,
                ao_threshold: float):
    """The final gather's rays ``[lo, hi)`` of the image, in the trace's
    order (:func:`~dust_tpu_torch.ops.camera.primary_rays`' ``tiled``):
    (gi_dir (m, 3), ao_t_max (m,)). ``gi_dir`` is the cosine blue-noise
    sample of the ray's pixel (:func:`~dust_tpu_torch.ops.noise.bn_fetch`
    of ``bn_cosine`` at ``layer``, ``offset`` and ``rand``) rotated into
    the frame of its G-buffer ``normal``, or (0, 1, 0) where the primary
    ray missed; ``ao_t_max`` is ``ao_threshold`` on a hit, -1 on a miss.

    CPU tensors run :func:`gather_dirs_plain`; CUDA tensors launch
    ``gather_dirs_kernel`` (:mod:`dust_tpu_torch.ops.gbuffer`)."""
    check_ray_range(width, height, tiled, lo, hi)
    if normal.device.type == "cpu":
        return gather_dirs_plain(normal, hit, bn_cosine, layer, offset,
                                 rand, width, height, tiled, lo, hi,
                                 ao_threshold)
    return gbuffer.dirs(normal, hit, bn_cosine, layer, offset, rand, width,
                        height, tiled, lo, hi, ao_threshold)


def gather_dirs_plain(normal, hit, bn_cosine, layer, offset, rand, width,
                      height, tiled, lo, hi, ao_threshold):
    """The plain version of :func:`gather_dirs`."""
    img = noiselib.bn_fetch(bn_cosine, layer, offset, rand, height, width)
    if tiled:
        img = torch.movedim(img.reshape(height // 8, 8, width // 128, 128,
                                        img.shape[-1]), 2, 0)
    cos_sample = img.reshape(width * height, -1)[lo:hi] * 2.0 - 1.0
    gi_dir = pk.rotate_vector_by_normal(normal, cos_sample)
    gi_dir = torch.where(hit[:, None], gi_dir,
                         gi_dir.new_tensor([0.0, 1.0, 0.0]))
    return gi_dir, torch.where(hit, ao_threshold, -1.0).float()


def resolve_gather(scene, fg, ao, hit_loc, gi_dir, hit, direct, sky_out,
                   cache, sky_state, bounce: bool, skylight: bool,
                   cells: bool = False, debug_illum=None) -> dict:
    """What the final gather yields, from the AO trace ``ao`` and the
    final-gather trace ``fg`` of the gather rays (``hit_loc``,
    ``gi_dir``): a dict of ``radiance`` (m, 3), the primary hit's
    ``direct`` light plus ``illum`` where ``hit``, else ``sky_out``;
    ``hitdist`` (m,), the AO hit's or else the final-gather hit's t (0
    when neither hit, 100000 on a primary miss); and ``illum`` (m, 3),
    the indirect light: with ``bounce``, the radiance that the dense GI
    ``cache`` (a :class:`~dust_tpu_torch.ops.gi_cache.DenseGICache`)
    holds at the final-gather hit's entry face, bounced off its leaf's
    albedo; with ``skylight``, the sky of ``sky_state`` where the gather
    ray leaves the scene. With ``cells`` (the hash frame's enqueue), also
    ``face`` (m,) int32, the hit's entry face, ``count`` (m,), the cached
    row's samples, and ``center`` (m, 3), its leaf's world centre.
    ``debug_illum`` (m, 3) replaces ``illum`` where ``hit``
    (``debug_visualize_spatial_hash``).

    CPU tensors run :func:`resolve_gather_plain`; CUDA tensors launch
    ``gather_resolve_kernel`` (:mod:`dust_tpu_torch.ops.gbuffer`)."""
    if hit_loc.device.type == "cpu":
        return resolve_gather_plain(scene, fg, ao, hit_loc, gi_dir, hit,
                                    direct, sky_out, cache, sky_state,
                                    bounce, skylight, cells, debug_illum)
    return gbuffer.gather(scene, fg, ao, hit_loc, gi_dir, hit, direct,
                          sky_out, cache, sky_state, bounce, skylight, cells,
                          debug_illum)


def resolve_gather_plain(scene, fg, ao, hit_loc, gi_dir, hit, direct,
                         sky_out, cache, sky_state, bounce, skylight,
                         cells=False, debug_illum=None):
    """The plain version of :func:`resolve_gather`."""
    ao_hit = ao.hit
    fg_active = hit & ~ao_hit
    fg_hit = fg_active & fg.hit
    face = entry_face(scene, fg, hit_loc, gi_dir)
    _found, cached, cnt, alb_u32 = gilib.dense_get(
        cache, gilib.dense_index(scene, fg.inst, fg.row, face), fg_hit)
    albedo_lin = colorlib.srgb_eotf(unpack_r10g10b10a2(alb_u32)[:, :3])
    indirect = colorlib.srgb_to_acescg(
        colorlib.acescg_to_srgb(cached) * albedo_lin)
    illum = torch.zeros((hit.shape[0], 3), device=hit.device)
    if bounce:
        illum = illum + torch.where(fg_hit[:, None], indirect, 0.0)
    if skylight:
        illum = illum + torch.where(
            (fg_active & ~fg.hit)[:, None],
            skylib.sky_radiance(sky_state, gi_dir), 0.0)
    if debug_illum is not None:
        illum = torch.where(hit[:, None], debug_illum, illum)
    hitdist = torch.where(ao_hit, ao.t, 0.0)
    hitdist = torch.where(fg_hit, fg.t, hitdist)
    radiance = torch.where(hit[:, None], direct + illum, sky_out)
    hitdist = torch.where(hit, hitdist, 100000.0)
    out = dict(radiance=radiance, hitdist=hitdist, illum=illum)
    if cells:
        out.update(face=face, count=cnt,
                   center=entry_leaf_center(scene, fg, hit_loc, gi_dir))
    return out
