"""Device scene assembly: flat per-model tables + the instance table.

The benchmark's frozen copy of the port's scene build, with the fields
the frame reads. Per-model arrays are stacked over models (leading ``M`` axis,
padded to the largest leaf count); per-instance arrays have a leading
``I`` axis. Unsigned 32-bit words (leaf masks, packed albedo) are kept as
int32 tensors holding the same bit patterns, because torch's ``uint32``
supports few operations.

The HDDA traversal tables (``hdda_*``) hold the contents of the Pallas
tables (:func:`dust_tpu.ops.pallas_trace.build_pallas_tables`) laid out
flat instead of in (8, 128) tiles; see :mod:`benchmark.reference.ops.hdda`.
``cell_info`` holds one int32 per 4³ block cell:

* ``v >= 0``: an occupied block; ``v`` is the leaf row in the model's
  flat leaf arrays;
* ``v < 0``: empty; ``-v`` is a conservative chebyshev distance (in
  blocks) to the nearest occupied block, so a ray at this cell may skip
  ``-v`` blocks in one step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.vox.loader import VoxScene
from benchmark.reference.ops.hdda import build_hdda_tables, stack_tables

__all__ = ["DeviceScene", "build_device_scene", "splice_model",
           "leaf_layout", "material_layout", "pad_rows_past_dead_zone",
           "chebyshev_distance_field", "cell_info_grid"]

MAX_SKIP = 63  # distances are clamped; any value >= 1 is a valid skip


def chebyshev_distance_field(occupied: np.ndarray,
                     max_dist: int = MAX_SKIP) -> np.ndarray:
    """Chebyshev (L-infinity) distance to the nearest occupied cell of a
    (64, 64, 64) block grid, clamped to ``max_dist``; occupied cells get
    0: the iterative 3³ dilation in numpy."""
    occ = occupied.astype(bool)
    dist = np.full(occ.shape, max_dist, dtype=np.int32)
    dist[occ] = 0
    frontier = occ
    for d in range(1, max_dist):
        if frontier.all():
            break
        p = np.pad(frontier, 1, constant_values=False)
        grown = np.zeros_like(frontier)
        for dx in (0, 1, 2):
            for dy in (0, 1, 2):
                for dz in (0, 1, 2):
                    grown |= p[dx:dx + 64, dy:dy + 64, dz:dz + 64]
        dist[grown & ~frontier] = d
        frontier = grown
    return dist


def cell_info_grid(leaf_grid: np.ndarray,
                   max_dist: int = MAX_SKIP) -> np.ndarray:
    """Leaf rows and skip distances fused into one int32 lookup table."""
    occ = leaf_grid >= 0
    dist = chebyshev_distance_field(occ, max_dist)
    return np.where(occ, leaf_grid, -np.maximum(dist, 1)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """All scene state the frame reads, as tensors on one device."""

    cell_info: torch.Tensor        # (M, 64, 64, 64) int32 (eager traversal)
    mask_lo: torch.Tensor          # (M, Lmax) int32 (u32 bits)
    mask_hi: torch.Tensor          # (M, Lmax) int32 (u32 bits)
    leaf_origin: torch.Tensor      # (M, Lmax, 3) int32
    avg_albedo: torch.Tensor       # (M, Lmax) int32 (R10G10B10A2 bits)
    model_aabb_min: torch.Tensor   # (M, 3) float32
    model_aabb_max: torch.Tensor   # (M, 3) float32
    # Denormalised per-voxel shading rows, 16 voxels per row: row =
    # (flat_row*64 + bit) >> 4, word = bit & 15; each word is
    # R | G<<8 | B<<16 | palette_idx<<24.
    voxel_attr: torch.Tensor       # (>=F*4, 16) int32
    # HDDA traversal tables (ops/hdda.py layout).
    hdda_l1: torch.Tensor          # (M, 512) int32 packed L1 nibbles
    hdda_l2: torch.Tensor          # (M, 4096, 4) int32 [w0, w1, rank0, rank1]
    hdda_mask: torch.Tensor        # (M, CL*1024, 2) int32 [mask_lo, mask_hi]
    obj_to_world: torch.Tensor     # (I, 3, 4) float32
    world_to_obj: torch.Tensor     # (I, 3, 4) float32
    prev_obj_to_world: torch.Tensor  # (I, 3, 4) float32
    # Static metadata (python ints).
    inst_model: tuple = ()         # per-instance model slot
    hdda_chunks: tuple = ()        # per-model real 1024-leaf mask chunks
    leaf_base: tuple = ()          # per-model flat leaf-row base
    leaf_cap: tuple = ()           # per-model flat leaf-row capacity
    gi_cell_cap: tuple = ()        # per-model dense-GI cell capacity

    @property
    def num_instances(self) -> int:
        return len(self.inst_model)

    @property
    def num_models(self) -> int:
        return self.cell_info.shape[0]

    @property
    def inst_leaf_base(self) -> tuple:
        return tuple(self.leaf_base[m] for m in self.inst_model)

    @property
    def device(self) -> torch.device:
        return self.mask_lo.device

    def with_transforms(self, obj_to_world) -> "DeviceScene":
        """Move instances: new transforms; the current ones become the
        previous frame's (motion vectors)."""
        o2w = torch.as_tensor(obj_to_world, dtype=torch.float32,
                              device=self.device)
        return dataclasses.replace(
            self, obj_to_world=o2w, world_to_obj=_invert_affines(o2w),
            prev_obj_to_world=self.obj_to_world)


def _invert_affines(a34: torch.Tensor) -> torch.Tensor:
    lin = a34[..., :3, :3]
    t = a34[..., :3, 3]
    inv = torch.linalg.inv(lin)
    it = -torch.einsum("...ij,...j->...i", inv, t)
    return torch.cat([inv, it[..., :, None]], dim=-1)


def material_layout(geos) -> tuple[list[int], list[int]]:
    """Per-model (base, capacity) segments of the shared material pool
    (256-aligned, ~12.5% headroom, as the reference lays them out)."""
    bases, caps = [], []
    base = 0
    for g in geos:
        n = len(g.materials)
        cap = max(256, -(-(n + n // 8) // 256) * 256)
        bases.append(base)
        caps.append(cap)
        base += cap
    return bases, caps


# Row-count padding of the reference's gather-hot tables. The port keeps
# it so its voxel_attr and dense-GI row layouts are the reference's.
_GATHER_SMALL_MAX_ROWS = 220_000
_GATHER_BIG_MIN_ROWS = 524_288


def pad_rows_past_dead_zone(rows: int) -> int:
    if _GATHER_SMALL_MAX_ROWS < rows < _GATHER_BIG_MIN_ROWS:
        return _GATHER_BIG_MIN_ROWS
    return rows


def leaf_layout(geos) -> tuple[list[int], list[int]]:
    """Per-model (base, capacity) row segments of the flat leaf tables
    (64-aligned, ~25% headroom)."""
    bases, caps = [], []
    base = 0
    for g in geos:
        L = g.num_blocks
        cap = max(64, -(-(L + L // 4) // 64) * 64)
        bases.append(base)
        caps.append(cap)
        base += cap
    return bases, caps


def _build_voxel_attr(mask_lo, mask_hi, matptr, mat_words):
    """(R*4, 16) int32 per-voxel shading rows from flat (R,) per-leaf
    masks and material pointers into the packed material words."""
    R = mask_lo.shape[0]
    m64 = (mask_hi.astype(np.uint64) << np.uint64(32)) | mask_lo.astype(
        np.uint64)
    occ = ((m64[:, None] >> np.arange(64, dtype=np.uint64)) &
           np.uint64(1)).astype(np.int32)
    below = np.cumsum(occ, axis=1, dtype=np.int32) - occ
    midx = np.minimum(matptr[:, None].astype(np.int64) + below,
                      len(mat_words) - 1)
    rgba = np.where(occ.astype(bool), mat_words[midx], np.int32(0))
    return np.ascontiguousarray(rgba.reshape(R * 4, 16))


def build_device_scene(scene: VoxScene, device) -> DeviceScene:
    """Assemble a :class:`DeviceScene` on ``device`` from a loaded
    ``.vox`` scene (host work in numpy, one upload per table)."""
    model_ids = sorted(scene.geometries)
    geos = [scene.geometries[m] for m in model_ids]
    id_to_slot = {m: i for i, m in enumerate(model_ids)}

    lmax = max(max((g.num_blocks for g in geos), default=1), 1)
    lmax = -(-(lmax + lmax // 4) // 64) * 64
    M = len(geos)

    cell = np.full((M, 64, 64, 64), -MAX_SKIP, dtype=np.int32)
    mask_lo = np.zeros((M, lmax), dtype=np.uint32)
    mask_hi = np.zeros((M, lmax), dtype=np.uint32)
    origin = np.zeros((M, lmax, 3), dtype=np.int32)
    albedo = np.zeros((M, lmax), dtype=np.uint32)

    bases, caps = material_layout(geos)
    materials = []
    for i, g in enumerate(geos):
        L = g.num_blocks
        cell[i] = cell_info_grid(g.flat.leaf_grid)
        mask_lo[i, :L] = g.flat.mask_lo
        mask_hi[i, :L] = g.flat.mask_hi
        origin[i, :L] = g.flat.leaf_origin
        albedo[i, :L] = g.avg_albedo
        seg = np.zeros(caps[i], dtype=np.int32)
        seg[: len(g.materials)] = g.materials.astype(np.int32)
        materials.append(seg)
    materials = (np.concatenate(materials) if materials
                 else np.zeros(4, dtype=np.int32))

    per_model = [build_hdda_tables(g.flat) for g in geos]
    hdda_chunks = tuple(t.mask_chunks for t in per_model)
    l1, l2, mask = stack_tables(per_model)

    ab_min = np.zeros((M, 3), dtype=np.float32)
    ab_max = np.full((M, 3), 256.0, dtype=np.float32)
    for i, g in enumerate(geos):
        if g.num_blocks:
            ab_min[i] = g.flat.leaf_origin.min(axis=0)
            ab_max[i] = g.flat.leaf_origin.max(axis=0) + 4.0

    # Packed material words R | G<<8 | B<<16 | palette_idx<<24, padded as
    # the reference pads them (the voxel rows clamp pointers into it).
    m4 = pad_rows_past_dead_zone(max(-(-len(materials) // 4), 1))
    mat_words = np.zeros(m4 * 4, dtype=np.int32)
    rgba8 = scene.palette[materials].astype(np.uint32)
    mat_words[: len(materials)] = (
        rgba8[:, 0] | (rgba8[:, 1] << 8) | (rgba8[:, 2] << 16)
        | (materials.astype(np.uint32) << 24)).view(np.int32)

    lbase, lcap = leaf_layout(geos)
    F = (lbase[-1] + lcap[-1]) if geos else 64
    flat_lo = np.zeros(F, dtype=np.uint32)
    flat_hi = np.zeros(F, dtype=np.uint32)
    flat_mp = np.zeros(F, dtype=np.int32)
    for i, g in enumerate(geos):
        L = g.num_blocks
        b = lbase[i]
        flat_lo[b:b + L] = g.flat.mask_lo
        flat_hi[b:b + L] = g.flat.mask_hi
        flat_mp[b:b + L] = g.flat.material_ptr.astype(np.int64) + bases[i]
    voxel_attr = _build_voxel_attr(flat_lo, flat_hi, flat_mp, mat_words)
    va_rows = pad_rows_past_dead_zone(voxel_attr.shape[0])
    if va_rows > voxel_attr.shape[0]:
        voxel_attr = np.concatenate(
            [voxel_attr,
             np.zeros((va_rows - voxel_attr.shape[0], 16), np.int32)])

    inst_model = tuple(id_to_slot[inst.model_id] for inst in scene.instances)
    o2w = np.stack([inst.transform[:3, :4] for inst in scene.instances]
                   ).astype(np.float32) if scene.instances \
        else np.zeros((0, 3, 4), np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    o2w_t = dev(o2w)
    return DeviceScene(
        cell_info=dev(cell),
        mask_lo=dev(mask_lo.view(np.int32)),
        mask_hi=dev(mask_hi.view(np.int32)),
        leaf_origin=dev(origin),
        avg_albedo=dev(albedo.view(np.int32)),
        model_aabb_min=dev(ab_min),
        model_aabb_max=dev(ab_max),
        voxel_attr=dev(voxel_attr),
        hdda_l1=dev(l1), hdda_l2=dev(l2), hdda_mask=dev(mask),
        obj_to_world=o2w_t,
        world_to_obj=_invert_affines(o2w_t) if inst_model
        else torch.zeros((0, 3, 4), device=device),
        prev_obj_to_world=o2w_t,
        inst_model=inst_model,
        hdda_chunks=hdda_chunks,
        leaf_base=tuple(lbase),
        leaf_cap=tuple(lcap),
        gi_cell_cap=tuple(max(64, -(-g.num_blocks // 64) * 64)
                          for g in geos),
    )


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``. To a CUDA device it goes through pinned
    memory, queued on the current stream: no host sync (a copy from
    pageable memory would wait for the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _set(t: torch.Tensor, index, value) -> torch.Tensor:
    """A copy of ``t`` with ``t[index] = value`` (the scene a refit
    replaces stays as it was)."""
    out = t.clone()
    out[index] = value
    return out


def _packed_words(palette: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Packed material words R | G<<8 | B<<16 | palette_idx<<24 (int32
    bits) of the palette indices ``idx``."""
    rgba8 = palette[idx].astype(np.uint32)
    return (rgba8[:, 0] | (rgba8[:, 1] << 8) | (rgba8[:, 2] << 16)
            | (idx.astype(np.uint32) << 24)).view(np.int32)


def splice_model(device: DeviceScene, slot: int, geo, mat_cap: int,
                 palette: np.ndarray) -> DeviceScene | None:
    """Incremental refit: a scene with ONE model's rows replaced in every
    per-model table and its segment of the flat voxel rows, every other
    model's rows untouched (the BLAS refit, ``accel_struct/blas.rs:125``).

    ``mat_cap``: the capacity of the model's segment of the material pool
    as the scene was built (:func:`material_layout`); ``palette`` the
    (256, 4) uint8 palette. Returns None when the rebuilt model no
    longer fits the scene's padding (leaf rows, mask chunks or material
    capacity); the caller then rebuilds the whole scene. The refusals are the
    reference's, so every edit takes the reference's tier."""
    lmax = device.mask_lo.shape[1]
    lcap = device.leaf_cap[slot]
    CL = device.hdda_mask.shape[1] // 1024
    L = geo.num_blocks
    n_mats = len(geo.materials)
    if L > lmax or L > lcap or n_mats > mat_cap:
        return None
    tables = build_hdda_tables(geo.flat)
    # The reference bakes each model's real chunk count into its kernel;
    # a model that crosses a 1024-leaf chunk boundary is rebuilt there,
    # and so here.
    if tables.mask_chunks > min(CL, device.hdda_chunks[slot]):
        return None

    ml = np.zeros(lmax, dtype=np.uint32)
    mh = np.zeros(lmax, dtype=np.uint32)
    org = np.zeros((lmax, 3), dtype=np.int32)
    mp = np.zeros(lmax, dtype=np.int32)
    alb = np.zeros(lmax, dtype=np.uint32)
    ml[:L] = geo.flat.mask_lo
    mh[:L] = geo.flat.mask_hi
    org[:L] = geo.flat.leaf_origin
    mp[:L] = geo.flat.material_ptr
    alb[:L] = geo.avg_albedo

    seg = np.zeros(mat_cap, dtype=np.int32)
    seg[:n_mats] = geo.materials.astype(np.int32)
    # Voxel rows index the model's own material words.
    va = _build_voxel_attr(ml[:lcap], mh[:lcap],
                           np.where((ml | mh)[:lcap], mp[:lcap], 0),
                           _packed_words(palette, seg))

    if L:
        abmin = geo.flat.leaf_origin.min(axis=0).astype(np.float32)
        abmax = (geo.flat.leaf_origin.max(axis=0) + 4.0).astype(np.float32)
    else:
        abmin = np.zeros(3, np.float32)
        abmax = np.full(3, 256.0, np.float32)
    mask = np.zeros((CL * 1024, 2), np.int32)
    mask[:tables.mask.shape[0]] = tables.mask

    dev = device.device
    rows = {
        "cell_info": cell_info_grid(geo.flat.leaf_grid),
        "mask_lo": ml.view(np.int32), "mask_hi": mh.view(np.int32),
        "leaf_origin": org, "avg_albedo": alb.view(np.int32),
        "model_aabb_min": abmin, "model_aabb_max": abmax,
        "hdda_l1": tables.l1, "hdda_l2": tables.l2, "hdda_mask": mask,
    }
    repl = {name: _set(getattr(device, name), slot, _upload(a, dev))
            for name, a in rows.items()}
    r0 = device.leaf_base[slot]
    repl["voxel_attr"] = _set(device.voxel_attr,
                              slice(r0 * 4, (r0 + lcap) * 4), _upload(va, dev))
    return dataclasses.replace(device, **repl)
