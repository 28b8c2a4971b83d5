"""The eager traversal backend and the per-instance ray set-up.

Port of :mod:`dust_tpu.ops.traverse`: :class:`TraceResult`,
:func:`clip_to_model_aabb`, and the wavefront HDDA of the
``traversal_backend="jnp"`` setting (:func:`trace_instance`,
:func:`trace_scene`, :func:`trace_scene_tiled`) as torch ops. It has no
kernel of its own: every ray advances in lockstep, one macro step over
the 64³ block grid (``DeviceScene.cell_info``: a leaf row, or a
chebyshev skip over known-empty blocks) and one micro step of the 4³
voxel DDA per iteration, up to ``max_iters`` iterations; a lane still
active at the cap ends as a miss. The ``pallas`` backend traces through
:mod:`dust_tpu_torch.ops.hdda` instead, whose caps differ.

The rounding is the reference's. Its compiler fuses ``origin + dn * s``
into one multiply-add and its ``einsum`` affine applies into a chain of
them (:func:`dot_point`); the loop route of
:mod:`~dust_tpu_torch.ops.hdda` rounds the affine op by op
(:func:`xform_point`). The direction length
is rounded as ``jnp.linalg.norm`` rounds it on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dust_tpu_torch.ops.fp import fma, sqrt

__all__ = ["TraceResult", "xform_point", "xform_dir", "dir_length",
           "clip_to_model_aabb", "dot_point", "dot_dir", "trace_instance",
           "trace_scene", "trace_scene_tiled"]

_EPS = 1e-3       # the DDA exit epsilon (hit.rint:107), voxel units
_STEP_EPS = 1e-4  # nudge when sampling the cell a ray sits in
GRID_BLOCKS = 64
BLOCK_WIDTH = 4.0
GRID_WIDTH = GRID_BLOCKS * BLOCK_WIDTH  # 256 voxel units
TRACE_MODES = ("precise", "rough", "ao_threshold")
# Iterations between two reads of "is any lane still active?" (a host
# sync); at each read the finished lanes leave the arrays. Timed on the
# card with chip_smoke.py (PERF.md): a 1080p gi frame took 2.43 s with a
# read every iteration, 1.62 s every 16 and 10.1 s with none (256 fixed
# steps over every lane).
SYNC_EVERY = 16


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


def dot_point(a34, p):
    """(N, 3) points through a (3, 4) affine, rounded as the reference's
    ``einsum`` + translation: x, then y and z fused in, then the add."""
    x, y, z = p.unbind(-1)
    return torch.stack([fma(a34[k, 2], z, fma(a34[k, 1], y, a34[k, 0] * x))
                        + a34[k, 3] for k in range(3)], dim=-1)


def dot_dir(a34, d):
    """(N, 3) directions through the linear part, as :func:`dot_point`."""
    x, y, z = d.unbind(-1)
    return torch.stack([fma(a34[k, 2], z, fma(a34[k, 1], y, a34[k, 0] * x))
                        for k in range(3)], dim=-1)


def _safe_rcp(v):
    """1/v with ±0 mapped to ±1e20."""
    tiny = v.abs() < 1e-20
    big = torch.where(v < 0, -1e20, 1e20).to(v.dtype)
    return torch.where(tiny, big, 1.0 / torch.where(tiny, 1.0, v))


def _slab(o, rcp, box_min, box_max):
    """Entry and exit of (N, 3) rays in an axis-aligned box."""
    t_lo = (box_min - o) * rcp
    t_hi = (box_max - o) * rcp
    return (torch.minimum(t_lo, t_hi).amax(dim=-1),
            torch.maximum(t_lo, t_hi).amin(dim=-1))


def _macro_step(st, cell_flat, mask_lo, mask_hi, mode):
    """The block-grid step of every lane not inside a block: descend into
    an occupied block (or report it), or skip the known-empty box."""
    o, dn, rcp, s = st["o"], st["dn"], st["rcp"], st["s"]
    p = fma(dn, (s + _STEP_EPS)[:, None], o)
    cell = torch.floor(p * (1.0 / BLOCK_WIDTH)).int()
    inb = ((cell >= 0) & (cell < GRID_BLOCKS)).all(dim=-1)
    macro = st["active"] & ~st["in_micro"]
    alive = macro & inb & (s < st["s_end"])
    lin = (cell[:, 0] * GRID_BLOCKS + cell[:, 1]) * GRID_BLOCKS + cell[:, 2]
    lin = torch.where(alive, lin, 0).clamp(0, cell_flat.shape[0] - 1)
    v = cell_flat[lin]
    occupied = alive & (v >= 0)

    bmin = cell.float() * BLOCK_WIDTH
    s_blk_entry, s_exit = _slab(o, rcp, bmin, bmin + BLOCK_WIDTH)
    new = dict(st)
    if mode == "rough":
        # Hit at the leaf AABB's entry, no DDA; an entry before t_min is
        # rejected and the ray jumps to the block's exit.
        report = (occupied & (s_blk_entry >= st["s_min"])
                  & (s_blk_entry <= st["s_end"]))
        new["hit_s"] = torch.where(report, torch.clamp(s_blk_entry, min=0.0),
                                   st["hit_s"])
        new["hit_bit"] = torch.where(report, -1, st["hit_bit"])
        new["s"] = torch.where(occupied & ~report,
                               torch.maximum(s_exit, s + _STEP_EPS), s)
        descend = torch.zeros_like(occupied)
    else:
        if mode == "ao_threshold":
            # tmax within this leaf's span: report the entry, bit 0xFF.
            report = (occupied & (s <= st["s_stop"]) & (st["s_stop"] <= s_exit)
                      & (s <= st["s_end"]))
        else:
            report = torch.zeros_like(occupied)
        new["hit_s"] = torch.where(report, s, st["hit_s"])
        new["hit_bit"] = torch.where(report, 255, st["hit_bit"])
        # Corner graze: an exit not measurably past the entry would bounce
        # back to the same s; nudge past it instead of descending.
        graze = occupied & ~report & (s_exit <= s + _STEP_EPS)
        descend = occupied & ~report & ~graze
        new["s"] = torch.where(graze, s + _STEP_EPS, s)
    new["hit_row"] = torch.where(report, v, st["hit_row"])
    new["active"] = st["active"] & ~report

    row = torch.where(descend, v, 0)
    new["mlo"] = torch.where(descend, mask_lo[row], st["mlo"])
    new["mhi"] = torch.where(descend, mask_hi[row], st["mhi"])
    new["row"] = torch.where(descend, row, st["row"])
    s_m = torch.maximum(s, st["s_min"])
    pm = fma(dn, s_m[:, None], o)
    base = cell * 4
    mpos = torch.minimum(torch.maximum(torch.floor(pm).int(), base), base + 3)
    # Zero-direction axes never cross.
    tmax3 = torch.where(dn.abs() < 1e-20, 1e30,
                        (mpos.float() + st["step01"] - o) * rcp)
    d3 = descend[:, None]
    new["mpos"] = torch.where(d3, mpos, st["mpos"])
    new["tmax3"] = torch.where(d3, tmax3, st["tmax3"])
    new["s_exit"] = torch.where(descend, s_exit, st["s_exit"])
    new["in_micro"] = st["in_micro"] | descend
    new["s"] = torch.where(descend, s_m, new["s"])

    # Empty: chebyshev skip to the boundary of the known-empty box.
    dist = torch.clamp(-v, min=1).float()[:, None]
    cf = cell.float()
    _, s_box = _slab(o, rcp, (cf - (dist - 1.0)) * BLOCK_WIDTH,
                     (cf + dist) * BLOCK_WIDTH)
    skip = alive & (v < 0)
    new["s"] = torch.where(skip, torch.maximum(s_box, s + _STEP_EPS),
                           new["s"])
    # Lanes that walked out of the grid or past their range end.
    new["active"] = new["active"] & ~(macro & (~inb | (s >= st["s_end"])))
    return new


def _micro_step(st):
    """One voxel step of every lane inside a block."""
    alive = st["active"] & st["in_micro"]
    m = st["mpos"]
    bit = ((m[:, 0] & 3) << 4) | ((m[:, 1] & 3) << 2) | (m[:, 2] & 3)
    in_lo = bit < 32
    # u32 masks in int32: an arithmetic shift under 32 keeps bit 0 right.
    lo_hit = (st["mlo"] >> torch.where(in_lo, bit, 0)) & 1
    hi_hit = (st["mhi"] >> torch.where(in_lo, 0, bit - 32)) & 1
    occ = torch.where(in_lo, lo_hit, hi_hit) != 0
    s = st["s"]
    hit_now = alive & occ & (s <= st["s_end"])
    dead_far = alive & occ & (s > st["s_end"])

    new = dict(st)
    new["hit_s"] = torch.where(hit_now, s, st["hit_s"])
    new["hit_row"] = torch.where(hit_now, st["row"], st["hit_row"])
    new["hit_bit"] = torch.where(hit_now, bit, st["hit_bit"])
    new["active"] = st["active"] & ~(hit_now | dead_far)

    stepping = alive & ~occ
    tmax3 = st["tmax3"]
    axis = tmax3.argmin(dim=-1)  # the first minimum, as the reference's
    s_next = tmax3.amin(dim=-1)
    exited = stepping & (s_next + _EPS >= st["s_exit"])
    advance = stepping & ~exited
    onehot = torch.nn.functional.one_hot(axis.long(), 3).int()
    a3 = advance[:, None]
    new["mpos"] = torch.where(a3, m + onehot * st["sstep"], m)
    new["tmax3"] = torch.where(a3, tmax3 + onehot.float() * st["tdelta"],
                               tmax3)
    new["s"] = torch.where(
        advance, s_next,
        torch.where(exited, torch.maximum(st["s_exit"], s), s))
    new["in_micro"] = st["in_micro"] & ~exited
    return new


def trace_instance(cell_info, mask_lo, mask_hi, origin, direction, t_min,
                   t_max, mode: str = "precise", max_iters: int = 256):
    """Rays against one model: ``cell_info`` (64, 64, 64) int32, the
    model's leaf masks (L,) int32 holding u32 bits, (N, 3) object-space
    origins and unnormalised directions, (N,) parameter bounds. Returns
    (t, row, bit), t = inf on a miss.

    The lanes advance :data:`SYNC_EVERY` iterations between two host
    reads of whether any is still active; at each read the finished lanes
    leave the arrays. No lane's result depends on this."""
    if mode not in TRACE_MODES:
        raise ValueError(mode)
    n = origin.shape[0]
    dev = origin.device
    dlen = dir_length(direction)
    dn = direction / dlen[:, None]
    rcp = _safe_rcp(dn)
    s_min = t_min * dlen
    s_stop = t_max * dlen
    g0, g1 = _slab(origin, rcp, torch.zeros(3, device=dev),
                   torch.full((3,), GRID_WIDTH, device=dev))
    s = torch.maximum(g0 + _STEP_EPS, s_min)
    s_end = torch.minimum(g1, s_stop)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    st = dict(
        o=origin, dn=dn, rcp=rcp, step01=(dn > 0).float(),
        sstep=torch.where(dn > 0, 1, -1).int(), tdelta=rcp.abs(),
        s_min=s_min, s_stop=s_stop, s_end=s_end,
        active=(g0 < g1) & (s < s_end),
        in_micro=torch.zeros(n, dtype=torch.bool, device=dev), s=s,
        mpos=torch.zeros((n, 3), dtype=torch.int32, device=dev),
        tmax3=torch.zeros((n, 3), device=dev), mlo=zi, mhi=zi, row=zi,
        s_exit=torch.zeros(n, device=dev),
        hit_s=torch.full((n,), float("inf"), device=dev),
        hit_row=zi - 1, hit_bit=zi - 1,
        lane=torch.arange(n, device=dev))
    out_s, out_row, out_bit = (st[k].clone()
                               for k in ("hit_s", "hit_row", "hit_bit"))
    cell_flat = cell_info.reshape(-1)

    def retire(st, done):
        out_s[st["lane"][done]] = st["hit_s"][done]
        out_row[st["lane"][done]] = st["hit_row"][done]
        out_bit[st["lane"][done]] = st["hit_bit"][done]

    sync_every = SYNC_EVERY
    for it in range(1, max_iters + 1):
        st = _micro_step(_macro_step(st, cell_flat, mask_lo, mask_hi, mode))
        if it % sync_every == 0 and it < max_iters:
            keep = st["active"]
            if not bool(keep.any()):
                break
            retire(st, ~keep)
            st = {k: v[keep] for k, v in st.items()}
    retire(st, torch.ones_like(st["active"]))
    return out_s / dlen, out_row, out_bit


def trace_scene(scene, origin, direction, t_min, t_max, mode: str = "precise",
                max_iters: int = 256) -> TraceResult:
    """Closest hit against every instance, in index order, each later
    instance with the best t so far as its far plane (world rays,
    unnormalised directions, world-parameter bounds, scalars or (N,))."""
    n = origin.shape[0]
    dev = origin.device
    t_min = torch.broadcast_to(torch.as_tensor(t_min, dtype=torch.float32,
                                               device=dev), (n,))
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    best_t = torch.full((n,), float("inf"), device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_row, best_bit = best_inst, best_inst
    for i, m in enumerate(scene.inst_model):
        w2o = scene.world_to_obj[i]
        o_obj = dot_point(w2o, origin)
        d_obj = dot_dir(w2o, direction)
        cap0 = torch.minimum(t_max, best_t)
        tn, cap = clip_to_model_aabb(scene, m, o_obj, d_obj, t_min, cap0)
        if mode == "ao_threshold":
            # The AO report plane is the committed tmax: the box clip
            # must not lower it, but still culls box-missing rays.
            cap = torch.where(cap < tn, cap, cap0)
        t, row, bit = trace_instance(
            scene.cell_info[m], scene.mask_lo[m], scene.mask_hi[m], o_obj,
            d_obj, tn, cap, mode=mode, max_iters=max_iters)
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_inst = torch.where(closer, i, best_inst)
        best_row = torch.where(closer, row, best_row)
        best_bit = torch.where(closer, bit, best_bit)
    return TraceResult(t=best_t, inst=best_inst, row=best_row, bit=best_bit)


def trace_scene_tiled(scene, origin, direction, t_min, t_max,
                      mode: str = "precise", tile: int = 16384,
                      max_iters: int = 256) -> TraceResult:
    """:func:`trace_scene` over consecutive runs of ``tile`` rays. Rays do
    not interact, so the tile bounds the memory of one walk and changes
    no result."""
    n = origin.shape[0]
    dev = origin.device
    t_min, t_max = (torch.broadcast_to(torch.as_tensor(
        t, dtype=torch.float32, device=dev), (n,)) for t in (t_min, t_max))
    parts = [trace_scene(scene, origin[a:a + tile], direction[a:a + tile],
                         t_min[a:a + tile], t_max[a:a + tile], mode=mode,
                         max_iters=max_iters)
             for a in range(0, n, tile)]
    return TraceResult(*(torch.cat(x) for x in zip(*parts)))
