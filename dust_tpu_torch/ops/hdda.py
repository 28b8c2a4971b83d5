"""HDDA voxel traversal: tables, plain versions, kernels, scene traces.

Port of the Pallas kernels of :mod:`dust_tpu.ops.pallas_trace`, both
around ``_traverse_core``:

* the batched scene kernel ``_make_scene_kernel``: for every ray, and
  for every instance in sweep order, it transforms the world ray into
  object space, normalises the direction, clips to the model AABB and to
  the closest hit so far, walks the two-level bitmap hierarchy (a 16³ L1
  chebyshev skip field over 16-voxel cells, a 64³ L2 block bitmap with
  popcount ranks), runs the 4×4×4 Amanatides-Woo micro DDA over the
  leaf's 64-bit occupancy mask, and merges the closest hit;
* the single-instance kernel ``_make_kernel``: the walk alone, on
  object-space rays with unit directions and s bounds given.

Four modes, as in the reference: ``precise`` (voxel hits),
``ao_threshold`` (precise plus the AO entry-report quirk), ``rough``
(hit = entry of the first occupied block) and ``ao_fg`` (ao_threshold
below ``t_ao``, rough past it, two accumulators).

The scene traces :func:`trace_scene` and :func:`trace_scene_ao_fg` take
one of the reference's two routes: the batched kernel (the default), or
with ``DUST_PALLAS_SCENE=loop`` in the environment, read at each call,
the per-instance loop over the single-instance kernel with the affine,
box clip and merge in PyTorch.

Three implementations of each kernel's function live here:

* :func:`hdda_plain` / :func:`hdda_instance_plain` — plain PyTorch,
  vectorised over rays with masked
  ``while mask.any()`` loops. Every iteration cap of the TPU kernel is
  a per-lane cap there (a lane steps once per loop iteration), so the
  plain version reproduces them per lane: ``ROUNDS`` rounds,
  ``MARCH_CAP`` march iterations (each one L1 step plus
  ``SUBSTEPS[mode]`` in-cell block sub-steps) and ``MICRO_CAP`` micro
  steps, with the post-loop test of the voxel the micro loop reached.
* ``csrc/hdda.cu`` — the CUDA kernels, one thread per ray, the same
  arithmetic in the same order (compiled with ``-fmad=false``; the few
  fused multiply-adds the reference's XLA build contracts are explicit
  on both sides, see :mod:`dust_tpu_torch.ops.fp`).
* :func:`hdda` / :func:`hdda_instance` — the launch wrappers: the kernel
  for CUDA tensors, the plain version for CPU tensors, nothing else.
  :data:`LIBRARY` (:class:`dust_tpu_torch.csrc.Library`) builds the
  kernels at the first launch and counts each launch in
  :data:`LAUNCHES` or :data:`INSTANCE_LAUNCHES`.

Table layout (flat; the reference tiles the same contents in (8, 128)):

* ``l1`` (M, 512) int32 — L1 chebyshev distance (clamped to 15) of cell
  ``cl = (cx*16 + cy)*16 + cz``, 8 nibbles per word: nibble ``cl & 7``
  of word ``cl >> 3``.
* ``l2`` (M, 4096, 4) int32 — per L1 cell ``cl``: the occupancy words of
  its 64 blocks (block-local index ``(bx&3)<<4 | (by&3)<<2 | bz&3``, w0 =
  blocks 0-31, w1 = 32-63) and their exclusive popcount ranks, so a leaf
  row is ``rank + popcount(word & (bit - 1))``.
* ``mask`` (M, CL*1024, 2) int32 — per leaf row, the 64-voxel occupancy
  mask as (lo, hi) words; ``CL`` is the largest model's count of
  1024-leaf chunks.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from dust_tpu_torch import csrc
from dust_tpu_torch.csrc import check
from dust_tpu_torch.ops.fp import fma as _fma
from dust_tpu_torch.ops.fp import sqrt as _sqrt
from dust_tpu_torch.ops.traverse import (TraceResult, clip_to_model_aabb,
                                         dir_length, xform_dir, xform_point)
from dust_tpu_torch.utils.profiling import trace_annotation

__all__ = ["HDDATables", "build_hdda_tables", "stack_tables", "hdda",
           "hdda_plain", "hdda_instance", "hdda_instance_plain",
           "trace_instance", "trace_instance_ao_fg", "front_to_back_ids",
           "trace_scene", "trace_scene_ao_fg", "LAUNCHES",
           "INSTANCE_LAUNCHES", "MODES"]

_EPS = 1e-3        # micro-DDA exit epsilon (hit.rint:107)
_STEP_EPS = 1e-4   # cell-sampling nudge
ROUNDS = 64        # march + micro rounds per ray and instance
MARCH_CAP = 160    # march iterations per round
MICRO_CAP = 12     # micro-DDA steps per round
# In-cell block sub-steps after each L1 step of the march, per mode.
SUBSTEPS = {"precise": 3, "ao_threshold": 1, "rough": 5, "ao_fg": 2}
# Modes whose cell registers (L2 words, ranks, cell id) persist across
# rounds; the others start every round with none loaded.
_CARRY = ("precise", "ao_fg")
MODES = ("precise", "ao_threshold", "rough", "ao_fg")
_MODE_ID = {m: i for i, m in enumerate(MODES)}

# Kernel launches per mode since the last reset, of the scene kernel and
# of the single-instance kernel (the plain versions count nothing).
LAUNCHES = {m: 0 for m in MODES}
INSTANCE_LAUNCHES = {m: 0 for m in MODES}


# ---------------------------------------------------------------------------
# Tables (host, numpy)
# ---------------------------------------------------------------------------

class HDDATables(NamedTuple):
    """One model's traversal tables (layout in the module docstring), as
    numpy arrays when built, or as tensors (one model's slice of a
    scene's stacked tables) when traced."""

    l1: np.ndarray    # (512,) int32
    l2: np.ndarray    # (4096, 4) int32
    mask: np.ndarray  # (chunks*1024, 2) int32

    @property
    def mask_chunks(self) -> int:
        return self.mask.shape[0] // 1024


def _popcount_u32(words: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(words.astype(np.uint32)).view(np.uint8)
    return np.unpackbits(b.reshape(-1, 4), axis=1).sum(axis=1).astype(
        np.int64)


def build_hdda_tables(flat) -> HDDATables:
    """Tables of one model from a FlatTree whose rows are in hierarchy
    order (which :meth:`VoxTree.flatten` guarantees; the ranks depend on
    it)."""
    from dust_tpu_torch.voxtree.tree import hierarchy_key

    b = flat.leaf_origin >> 2
    key = hierarchy_key(b)
    if not np.all(np.diff(key) > 0):
        raise ValueError("flat rows must be in hierarchy order")

    l2 = np.zeros(8192, dtype=np.uint32)
    np.bitwise_or.at(l2, key >> 5,
                     np.uint32(1) << (key & 31).astype(np.uint32))
    rank = np.zeros(8192, dtype=np.int64)
    np.cumsum(_popcount_u32(l2)[:-1], out=rank[1:])

    # L1 chebyshev skip field over the 16³ cells, clamped to 15.
    cell = b >> 2
    occ16 = np.zeros((16, 16, 16), dtype=bool)
    occ16[cell[:, 0], cell[:, 1], cell[:, 2]] = True
    dist = np.full((16, 16, 16), 15, dtype=np.int64)
    dist[occ16] = 0
    frontier = occ16.copy()
    for dd in range(1, 15):
        if frontier.all():
            break
        p = np.pad(frontier, 1, constant_values=False)
        grown = np.zeros_like(frontier)
        for dx in (0, 1, 2):
            for dy in (0, 1, 2):
                for dz in (0, 1, 2):
                    grown |= p[dx:dx + 16, dy:dy + 16, dz:dz + 16]
        dist[grown & ~frontier] = dd
        frontier = grown
    nib = dist.reshape(512, 8).astype(np.uint32)  # x-major cell order
    l1 = np.bitwise_or.reduce(
        nib << (np.arange(8, dtype=np.uint32) * 4), axis=1)

    n = len(key)
    chunks = max((n + 1023) // 1024, 1)
    mask = np.zeros((chunks * 1024, 2), dtype=np.uint32)
    mask[:n, 0] = flat.mask_lo
    mask[:n, 1] = flat.mask_hi
    l2_tab = np.stack([l2[0::2].view(np.int32), l2[1::2].view(np.int32),
                       rank[0::2].astype(np.int32),
                       rank[1::2].astype(np.int32)], axis=-1)
    return HDDATables(l1=l1.view(np.int32),
                      l2=np.ascontiguousarray(l2_tab),
                      mask=mask.view(np.int32))


def stack_tables(tables: list):
    """Stack per-model tables into (M, ...) arrays; masks are padded to
    the largest chunk count. Returns (l1, l2, mask)."""
    m = len(tables)
    cl = max((t.mask_chunks for t in tables), default=1)
    l1 = np.zeros((m, 512), np.int32)
    l2 = np.zeros((m, 4096, 4), np.int32)
    mask = np.zeros((m, cl * 1024, 2), np.int32)
    for i, t in enumerate(tables):
        l1[i] = t.l1
        l2[i] = t.l2
        mask[i, : t.mask.shape[0]] = t.mask
    return l1, l2, mask


# ---------------------------------------------------------------------------
# The plain version (torch, vectorised over rays)
# ---------------------------------------------------------------------------

def _safe_rcp(v):
    tiny = v.abs() < 1e-20
    big = torch.where(v < 0, -1e20, 1e20).to(v.dtype)
    return torch.where(tiny, big, 1.0 / torch.where(tiny, 1.0, v))


def _slab3(o, r, lo_c, hi_c):
    """Entry/exit of the box [lo_c, hi_c] for origin ``o`` and reciprocal
    direction ``r`` (3-tuples)."""
    t0 = [(lo_c[k] - o[k]) * r[k] for k in range(3)]
    t1 = [(hi_c[k] - o[k]) * r[k] for k in range(3)]
    lo = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                     torch.minimum(t0[1], t1[1])),
                       torch.minimum(t0[2], t1[2]))
    hi = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                     torch.maximum(t0[1], t1[1])),
                       torch.maximum(t0[2], t1[2]))
    return lo, hi


def _bit(word, bit):
    return ((word >> bit) & 1) != 0


def _popcount_below(word, bit):
    """popcount(word & ((1 << bit) - 1)) for 32-bit words held in int32."""
    x = word.long() & ((torch.ones_like(bit, dtype=torch.long) << bit) - 1)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).int()


def _floor_i(x, scale, hi):
    return torch.clamp(torch.floor(x * scale).int(), 0, hi)


def _core(l1, l2, mask, o, d, s_min, s_stop, s_ao, mode, rounds):
    """One instance's traversal for every ray (object space, unit
    directions, s in object units), at most ``rounds`` rounds. Returns
    (hit_s, hit_row, hit_bit), or (ao_s, fg_s, fg_row) in ``ao_fg``
    mode.

    A lane starts only if ``s_min < s_stop``, so the walk runs on those
    lanes alone and the others get the miss outputs: the same results
    (every cap is per lane), without stepping whole arrays for the few
    lanes of an instance that most rays miss."""
    live = s_min < s_stop
    if bool(live.all()):
        return _walk(l1, l2, mask, o, d, s_min, s_stop, s_ao, mode, rounds)
    idx = torch.nonzero(live).flatten()
    outs = _walk(l1, l2, mask, tuple(v[idx] for v in o),
                 tuple(v[idx] for v in d), s_min[idx], s_stop[idx],
                 None if s_ao is None else s_ao[idx], mode, rounds)
    misses = (float("inf"), float("inf"), -1) if mode == "ao_fg" else (
        float("inf"), -1, -1)
    full = []
    for x, miss in zip(outs, misses):
        y = torch.full(live.shape, miss, dtype=x.dtype, device=x.device)
        y[idx] = x
        full.append(y)
    return tuple(full)


def _walk(l1, l2, mask, o, d, s_min, s_stop, s_ao, mode, rounds):
    """The body of :func:`_core`, on every lane given."""
    ox, oy, oz = o
    dx, dy, dz = d
    n = ox.shape[0]
    dev = ox.device
    carry = mode in _CARRY
    rx, ry, rz = _safe_rcp(dx), _safe_rcp(dy), _safe_rcp(dz)
    r = (rx, ry, rz)
    sx, sy, sz = [torch.where(v > 0, 1, -1).int() for v in d]
    p01x, p01y, p01z = [(v > 0).float() for v in d]

    g0, g1 = _slab3(o, r, (0.0, 0.0, 0.0), (256.0, 256.0, 256.0))
    s_end = torch.minimum(g1, s_stop)
    s = torch.maximum(g0 + _STEP_EPS, s_min)
    active = (g0 < g1) & (s < s_end)

    inf = torch.full((n,), float("inf"), device=dev)
    neg1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    zero_i = torch.zeros(n, dtype=torch.int32, device=dev)
    hit_s, hit_row, hit_bit = inf, neg1, neg1
    fg_s = inf                                    # ao_fg only
    hit_word = zero_i                             # rough only
    w0 = w1 = rr0 = rr1 = zero_i
    reg_cl = neg1

    def pos(sv):
        return _fma(dx, sv, ox), _fma(dy, sv, oy), _fma(dz, sv, oz)

    def march(active, s, w0, w1, rr0, rr1, reg_cl):
        cand = torch.zeros(n, dtype=torch.bool, device=dev)
        for _ in range(MARCH_CAP):
            stepping = active & ~cand
            if not bool(stepping.any()):
                break
            se = s + _STEP_EPS
            px, py, pz = pos(se)
            c1x = _floor_i(px, 1.0 / 16.0, 15)
            c1y = _floor_i(py, 1.0 / 16.0, 15)
            c1z = _floor_i(pz, 1.0 / 16.0, 15)
            inb = se < s_end
            cl = (c1x * 16 + c1y) * 16 + c1z
            dist = (l1[(cl >> 3).long()] >> ((cl & 7) * 4)) & 15
            occ1 = (dist == 0) & inb & stepping
            need = occ1 & (cl != reg_cl)
            words = l2[torch.where(need, cl, 0).long()]
            w0 = torch.where(need, words[:, 0], w0)
            w1 = torch.where(need, words[:, 1], w1)
            if carry:
                rr0 = torch.where(need, words[:, 2], rr0)
                rr1 = torch.where(need, words[:, 3], rr1)
            reg_cl = torch.where(need, cl, reg_cl)

            bx = _floor_i(px, 0.25, 63)
            by = _floor_i(py, 0.25, 63)
            bz = _floor_i(pz, 0.25, 63)
            local = ((bx & 3) << 4) | ((by & 3) << 2) | (bz & 3)
            word = torch.where(local < 32, w0, w1)
            newly = _bit(word, local & 31) & occ1
            cand = cand | newly

            # Occupied cell: one block; empty cell at distance d: leave the
            # (2d-1)³ empty box. Only the exit plane of each axis matters.
            df = torch.clamp(dist, min=1).float()
            fb = [torch.where(occ1, b.float() * 4.0,
                              (c.float() - (df - 1.0)) * 16.0)
                  for b, c in ((bx, c1x), (by, c1y), (bz, c1z))]
            wsize = torch.where(occ1, 4.0, (2.0 * df - 1.0) * 16.0)
            e = [((fb[k] + p * wsize - o[k]) * r[k]).abs()
                 for k, p in enumerate((p01x, p01y, p01z))]
            s_next = torch.maximum(torch.minimum(torch.minimum(e[0], e[1]),
                                                 e[2]), s + _STEP_EPS)
            advance = stepping & ~newly
            s = torch.where(advance, s_next, s)
            active = active & ~(advance & (s >= s_end))

            for _ss in range(SUBSTEPS[mode]):
                # In-cell block sub-step for lanes whose next sample stays
                # in the cell whose words are loaded.
                stepping2 = active & ~cand
                se2 = s + _STEP_EPS
                qx, qy, qz = pos(se2)
                bx2 = _floor_i(qx, 0.25, 63)
                by2 = _floor_i(qy, 0.25, 63)
                bz2 = _floor_i(qz, 0.25, 63)
                cl2 = ((bx2 >> 2) * 16 + (by2 >> 2)) * 16 + (bz2 >> 2)
                ok2 = stepping2 & (cl2 == reg_cl) & (se2 < s_end)
                local2 = ((bx2 & 3) << 4) | ((by2 & 3) << 2) | (bz2 & 3)
                word2 = torch.where(local2 < 32, w0, w1)
                newly2 = _bit(word2, local2 & 31) & ok2
                cand = cand | newly2
                adv2 = ok2 & ~newly2
                e2 = [((b.float() * 4.0 + p * 4.0 - o[k]) * r[k]).abs()
                      for k, (b, p) in enumerate(((bx2, p01x), (by2, p01y),
                                                  (bz2, p01z)))]
                s_exit2 = torch.minimum(torch.minimum(e2[0], e2[1]), e2[2])
                s = torch.where(adv2, torch.maximum(s_exit2, s + _STEP_EPS),
                                s)
                active = active & ~(adv2 & (s >= s_end))
        return active, s, cand, w0, w1, rr0, rr1, reg_cl

    def cand_info(s, w0, w1):
        px, py, pz = pos(s + _STEP_EPS)
        c1x = _floor_i(px, 1.0 / 16.0, 15)
        c1y = _floor_i(py, 1.0 / 16.0, 15)
        c1z = _floor_i(pz, 1.0 / 16.0, 15)
        cl = (c1x * 16 + c1y) * 16 + c1z
        bx = _floor_i(px, 0.25, 63)
        by = _floor_i(py, 0.25, 63)
        bz = _floor_i(pz, 0.25, 63)
        local = ((bx & 3) << 4) | ((by & 3) << 2) | (bz & 3)
        word = torch.where(local < 32, w0, w1)
        return word, cl * 2 + (local >> 5), local & 31, (bx, by, bz)

    def block_slab(cb):
        f = [b.float() * 4.0 for b in cb]
        return _slab3(o, r, f, [v + 4.0 for v in f])

    def micro(in_micro, s, cb, row):
        """Micro DDA of candidate blocks; returns (hit lanes, s, bit)."""
        words = mask[torch.where(in_micro, row, 0).long()]
        mlo, mhi = words[:, 0], words[:, 1]
        s_m = torch.maximum(s, s_min)
        pm = pos(s_m)
        mxyz = [torch.clamp(torch.floor(p).int(), b * 4, b * 4 + 3)
                for p, b in zip(pm, cb)]
        tm = [torch.where(dv.abs() < 1e-20, 1e30,
                          (mv.float() + p - ov) * rv)
              for dv, mv, p, ov, rv in zip(d, mxyz, (p01x, p01y, p01z), o, r)]
        _, blk_out = block_slab(cb)
        mx, my, mz = mxyz
        tmx, tmy, tmz = tm

        def occupied(mx, my, mz):
            b = ((mx & 3) << 4) | ((my & 3) << 2) | (mz & 3)
            lo = b < 32
            return torch.where(lo, _bit(mlo, torch.where(lo, b, 0)),
                               _bit(mhi, torch.where(lo, 0, b - 32))), b

        live = in_micro
        for _ in range(MICRO_CAP):
            if not bool(live.any()):
                break
            occ, _b = occupied(mx, my, mz)
            live = live & ~occ          # freeze on the first occupied voxel
            s_next = torch.minimum(torch.minimum(tmx, tmy), tmz)
            exited = live & (s_next + _EPS >= blk_out)
            adv = live & ~exited
            take_x = adv & (tmx <= tmy) & (tmx <= tmz)
            take_y = adv & ~take_x & (tmy <= tmz)
            take_z = adv & ~take_x & ~take_y
            mx = torch.where(take_x, mx + sx, mx)
            my = torch.where(take_y, my + sy, my)
            mz = torch.where(take_z, mz + sz, mz)
            tmx = torch.where(take_x, tmx + rx.abs(), tmx)
            tmy = torch.where(take_y, tmy + ry.abs(), tmy)
            tmz = torch.where(take_z, tmz + rz.abs(), tmz)
            s_m = torch.where(adv, s_next, s_m)
            live = live & ~exited
        # The voxel the walk stopped on: a frozen lane's first occupied
        # voxel, or (at the step cap) one the loop never tested.
        occ_f, bit_f = occupied(mx, my, mz)
        return in_micro & occ_f, s_m, bit_f

    def leaf_row(cwidx, cword, cbit, rr0, rr1, cand):
        if carry:
            rank = torch.where((cwidx & 1) == 0, rr0, rr1)
        else:
            ranks = l2[torch.where(cand, cwidx >> 1, 0).long()]
            rank = torch.where((cwidx & 1) == 0, ranks[:, 2], ranks[:, 3])
        return rank + _popcount_below(cword, cbit)

    for _rnd in range(rounds):
        if not bool(active.any()):
            break
        if not carry:
            w0 = w1 = zero_i
            reg_cl = neg1
        active, s, cand, w0, w1, rr0, rr1, reg_cl = march(
            active, s, w0, w1, rr0, rr1, reg_cl)
        cword, cwidx, cbit, cb = cand_info(s, w0, w1)
        blk_in, blk_out = block_slab(cb)

        if mode == "rough":
            # Hit at the block entry; the leaf row resolves after the loop.
            ok = cand & active & (blk_in >= s_min) & (blk_in <= s_end)
            hit_s = torch.where(ok, torch.clamp(blk_in, min=0.0), hit_s)
            hit_row = torch.where(ok, cwidx, hit_row)
            hit_bit = torch.where(ok, cbit, hit_bit)
            hit_word = torch.where(ok, cword, hit_word)
            active = active & ~ok
            s = torch.where(cand & active,
                            torch.maximum(blk_out, s + _STEP_EPS), s)
            active = active & (s < s_end)
            continue

        row = leaf_row(cwidx, cword, cbit, rr0, rr1, cand)

        if mode == "ao_fg":
            # 1. threshold inside the block: AO entry report, done.
            thr_inside = cand & active & (s <= s_ao) & (s_ao <= blk_out)
            hit_s = torch.where(thr_inside, s, hit_s)
            active = active & ~thr_inside
            # 3. block past the threshold: rough final-gather hit.
            fg_blk = cand & active & (s > s_ao)
            ok_fg = fg_blk & (blk_in >= s_ao) & (blk_in <= s_end)
            fg_s = torch.where(ok_fg, torch.clamp(blk_in, min=0.0), fg_s)
            hit_row = torch.where(ok_fg, row, hit_row)
            active = active & ~ok_fg
            skip = fg_blk & ~ok_fg & active
            s = torch.where(skip, torch.maximum(blk_out, s + _STEP_EPS), s)
            active = active & (s < s_end)
            # 2. block below the threshold: micro DDA, voxel hit = AO.
            in_micro = cand & active & ~thr_inside & ~fg_blk
            if bool(in_micro.any()):
                hit_f, s_f, _ = micro(in_micro, s, cb, row)
                hit_s = torch.where(hit_f, s_f, hit_s)
                active = active & ~hit_f
                resumed = in_micro & active
                s = torch.where(resumed,
                                torch.maximum(blk_out, s + _STEP_EPS), s)
            active = active & (s < s_end)
            continue

        if mode == "ao_threshold":
            # Entry report when the committed tmax lies inside the block.
            ok = cand & active & (s <= s_ao) & (s_ao <= blk_out) & (s <= s_end)
            hit_s = torch.where(ok, s, hit_s)
            hit_row = torch.where(ok, row, hit_row)
            hit_bit = torch.where(ok, 255, hit_bit)
            active = active & ~ok

        in_micro = cand & active
        occ_f, s_f, bit_f = micro(in_micro, s, cb, row)
        hit_now = occ_f & (s_f <= s_end)
        hit_s = torch.where(hit_now, s_f, hit_s)
        hit_row = torch.where(hit_now, row, hit_row)
        hit_bit = torch.where(hit_now, bit_f, hit_bit)
        active = active & ~occ_f          # hit or past range: done
        found = torch.isfinite(hit_s)
        resumed = cand & active & ~found
        s = torch.where(resumed, torch.maximum(blk_out, s + _STEP_EPS), s)
        active = active & (s < s_end) & ~(cand & found)

    if mode == "ao_fg":
        return hit_s, fg_s, hit_row
    if mode == "rough":
        got = hit_row >= 0                 # hit_row holds the word index
        ranks = l2[torch.where(got, hit_row >> 1, 0).long()]
        rank = torch.where((hit_row & 1) == 0, ranks[:, 2], ranks[:, 3])
        row = rank + _popcount_below(hit_word, torch.clamp(hit_bit, min=0))
        return hit_s, torch.where(got, row, neg1), neg1
    return hit_s, hit_row, hit_bit


def hdda_plain(l1, l2, mask, inst_model, inst_ids, aff, aabb,
               origin, direction, t_min, t_max, t_ao, mode: str):
    """The plain version of the kernel: same arguments and outputs as
    :func:`hdda`."""
    fused = mode == "ao_fg"
    n = origin.shape[0]
    dev = origin.device
    ow = origin.unbind(-1)
    dw = direction.unbind(-1)
    inf = torch.full((n,), float("inf"), device=dev)
    neg1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_t, best_i, best_row, best_bit = inf, neg1, neg1, neg1
    fg_t, fg_i = inf, neg1                     # ao_fg: the far accumulator
    for k, (m, oid) in enumerate(zip(inst_model.tolist(), inst_ids.tolist())):
        a = aff[k]
        o = tuple(_fma(a[4 * j + 2], ow[2],
                       _fma(a[4 * j], ow[0], a[4 * j + 1] * ow[1])) + a[4 * j + 3]
                  for j in range(3))
        dv = [_fma(a[4 * j + 2], dw[2],
                   _fma(a[4 * j], dw[0], a[4 * j + 1] * dw[1]))
              for j in range(3)]
        sq = _fma(dv[2], dv[2], _fma(dv[0], dv[0], dv[1] * dv[1]))
        dlen = torch.clamp(_sqrt(sq), min=1e-20)
        inv = 1.0 / dlen
        d = tuple(v * inv for v in dv)
        # Closest-so-far cap; in ao_fg the far accumulator bounds the walk.
        tx = torch.minimum(t_max, fg_t if fused else best_t)
        r = tuple(_safe_rcp(v) for v in d)
        box = aabb[m]
        lo, hi = _slab3(o, r, box[0:3], box[3:6])
        s_min = torch.maximum(t_min * dlen, lo)
        s_stop = torch.minimum(tx * dlen, hi)
        # ao_threshold's quirk plane is the committed tmax, never clipped
        # to the model box.
        s_ao = t_ao * dlen if fused else (tx * dlen if mode == "ao_threshold"
                                          else None)
        out = _core(l1[m], l2[m], mask[m], o, d, s_min, s_stop, s_ao, mode,
                    ROUNDS)
        if fused:
            ao_new, fg_new = out[0] * inv, out[1] * inv
            ao_c = ao_new < best_t
            fg_c = fg_new < fg_t
            best_t = torch.where(ao_c, ao_new, best_t)
            best_i = torch.where(ao_c, oid, best_i)
            fg_t = torch.where(fg_c, fg_new, fg_t)
            fg_i = torch.where(fg_c, oid, fg_i)
            best_row = torch.where(fg_c, out[2], best_row)
        else:
            t_new = out[0] * inv
            closer = t_new < best_t
            best_t = torch.where(closer, t_new, best_t)
            best_i = torch.where(closer, oid, best_i)
            best_row = torch.where(closer, out[1], best_row)
            best_bit = torch.where(closer, out[2], best_bit)
    if fused:
        return best_t, best_i, fg_t, fg_i, best_row
    return best_t, best_i, best_row, best_bit


def hdda_instance_plain(l1, l2, mask, origin, direction, s_min, s_stop,
                        s_ao, mode: str, rounds: int = ROUNDS):
    """The plain version of the single-instance kernel: same arguments
    and outputs as :func:`hdda_instance`."""
    # ao_threshold's quirk plane is s_stop on this route (the reference's
    # s_thr = s_stop when no s_ao is given).
    if mode != "ao_fg":
        s_ao = s_stop if mode == "ao_threshold" else None
    return _core(l1, l2, mask, origin.unbind(-1), direction.unbind(-1),
                 s_min, s_stop, s_ao, mode, rounds)


# ---------------------------------------------------------------------------
# The CUDA kernels' launches
# ---------------------------------------------------------------------------

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIBRARY = csrc.Library("hdda.cu", "hdda", {
    "hdda_launch": ([_ci, _vp, _vp, _vp, _ci, _ci, _vp, _vp, _vp, _vp, _ci,
                     _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                     _ci], LAUNCHES),
    "hdda_instance_launch": ([_ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                              _vp, _vp, _vp, _vp, _ci, _ci],
                             INSTANCE_LAUNCHES)})


def _ptr(t):
    return None if t is None else t.data_ptr()


def hdda(l1, l2, mask, inst_model, inst_ids, aff, aabb,
         origin, direction, t_min, t_max, t_ao=None, mode: str = "precise"):
    """Closest hit of world rays against the instances ``inst_ids``
    (model slots ``inst_model``, world-to-object affines ``aff`` (I, 12)),
    swept in the given order.

    Rays: ``origin``/``direction`` (N, 3) float32 (directions need not be
    unit), ``t_min``/``t_max`` (N,) float32 in world-parameter units; a
    lane with ``t_max < t_min`` is inactive. ``ao_fg`` also takes
    ``t_ao`` (N,). Returns (t, inst, row, bit), or in ``ao_fg`` mode
    (ao_t, ao_inst, fg_t, fg_inst, fg_row); t = inf and ids = -1 on miss.

    CPU tensors run :func:`hdda_plain`; CUDA tensors launch the kernel."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    fused = mode == "ao_fg"
    dev = origin.device
    n = origin.shape[0]
    M = l1.shape[0]
    I = inst_model.shape[0]
    rows = mask.shape[1]
    check("l1", l1, torch.int32, (M, 512), dev)
    check("l2", l2, torch.int32, (M, 4096, 4), dev)
    check("mask", mask, torch.int32, (M, rows, 2), dev)
    check("inst_model", inst_model, torch.int32, (I,), dev)
    check("inst_ids", inst_ids, torch.int32, (I,), dev)
    check("aff", aff, torch.float32, (I, 12), dev)
    check("aabb", aabb, torch.float32, (M, 6), dev)
    check("origin", origin, torch.float32, (n, 3), dev)
    check("direction", direction, torch.float32, (n, 3), dev)
    check("t_min", t_min, torch.float32, (n,), dev)
    check("t_max", t_max, torch.float32, (n,), dev)
    if fused:
        if t_ao is None:
            raise ValueError("mode 'ao_fg' needs t_ao")
        check("t_ao", t_ao, torch.float32, (n,), dev)
    if dev.type == "cpu":
        return hdda_plain(l1, l2, mask, inst_model, inst_ids, aff, aabb,
                          origin, direction, t_min, t_max, t_ao, mode)
    if dev.type != "cuda":
        raise ValueError(f"hdda: unsupported device {dev}")

    t0 = torch.empty(n, dtype=torch.float32, device=dev)
    i0 = torch.empty(n, dtype=torch.int32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    bit = None if fused else torch.empty(n, dtype=torch.int32, device=dev)
    t1 = torch.empty(n, dtype=torch.float32, device=dev) if fused else None
    i1 = torch.empty(n, dtype=torch.int32, device=dev) if fused else None

    LIBRARY.launch(
        "hdda_launch", _MODE_ID[mode], _ptr(l1), _ptr(l2), _ptr(mask), M,
        rows, _ptr(inst_model), _ptr(inst_ids), _ptr(aff), _ptr(aabb), I,
        _ptr(origin), _ptr(direction), _ptr(t_min), _ptr(t_max), _ptr(t_ao),
        _ptr(t0), _ptr(i0), _ptr(t1), _ptr(i1), _ptr(row), _ptr(bit), n,
        device=dev, count=mode)
    if fused:
        return t0, i0, t1, i1, row
    return t0, i0, row, bit


def hdda_instance(l1, l2, mask, origin, direction, s_min, s_stop, s_ao=None,
                  mode: str = "precise", rounds: int = ROUNDS):
    """One model's traversal of object-space rays: ``l1`` (512,), ``l2``
    (4096, 4), ``mask`` (rows, 2) int32; ``origin``/``direction`` (N, 3)
    float32 with unit directions; ``s_min``/``s_stop`` (N,) float32 in s
    units (a lane with ``s_stop <= s_min`` is inactive); ``ao_fg`` also
    takes ``s_ao`` (N,); ``ao_threshold``'s quirk plane is ``s_stop``.
    At most ``rounds`` rounds. Returns (hit_s, row, bit), or in
    ``ao_fg`` mode (ao_s, fg_s, fg_row), in s units (inf and -1 on miss).

    CPU tensors run :func:`hdda_instance_plain`; CUDA tensors launch the
    kernel."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    fused = mode == "ao_fg"
    dev = origin.device
    n = origin.shape[0]
    rows = mask.shape[0]
    check("l1", l1, torch.int32, (512,), dev)
    check("l2", l2, torch.int32, (4096, 4), dev)
    check("mask", mask, torch.int32, (rows, 2), dev)
    check("origin", origin, torch.float32, (n, 3), dev)
    check("direction", direction, torch.float32, (n, 3), dev)
    check("s_min", s_min, torch.float32, (n,), dev)
    check("s_stop", s_stop, torch.float32, (n,), dev)
    if fused:
        if s_ao is None:
            raise ValueError("mode 'ao_fg' needs s_ao")
        check("s_ao", s_ao, torch.float32, (n,), dev)
    if dev.type == "cpu":
        return hdda_instance_plain(l1, l2, mask, origin, direction, s_min,
                                   s_stop, s_ao, mode, rounds)
    if dev.type != "cuda":
        raise ValueError(f"hdda_instance: unsupported device {dev}")

    s0 = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    s1 = torch.empty(n, dtype=torch.float32, device=dev) if fused else None
    bit = None if fused else torch.empty(n, dtype=torch.int32, device=dev)
    LIBRARY.launch(
        "hdda_instance_launch", _MODE_ID[mode], _ptr(l1), _ptr(l2),
        _ptr(mask), _ptr(origin), _ptr(direction), _ptr(s_min), _ptr(s_stop),
        _ptr(s_ao if fused else None), _ptr(s0), _ptr(s1), _ptr(row),
        _ptr(bit), n, rounds, device=dev, count=mode)
    if fused:
        return s0, s1, row
    return s0, row, bit


# ---------------------------------------------------------------------------
# Single-instance entry points (the contracts of trace_instance_pallas and
# trace_instance_pallas_ao_fg)
# ---------------------------------------------------------------------------

def _per_ray(x, n, dev):
    return torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32,
                                              device=dev), (n,)).contiguous()


def _instance_rays(origin, direction, *ts):
    """Unit directions, the direction lengths, and each per-ray t bound
    times the length (s units)."""
    n = origin.shape[0]
    dev = origin.device
    dlen = dir_length(direction)
    dn = (direction / dlen[:, None]).contiguous()
    return (origin.contiguous(), dn, dlen,
            *(_per_ray(t, n, dev) * dlen for t in ts))


def trace_instance(tables: HDDATables, origin, direction, t_min, t_max,
                   mode: str = "precise", rounds: int = ROUNDS):
    """Trace rays against one model (``tables`` as tensors): object-space
    rays, unnormalised directions, parameter-space t bounds. Returns
    (t, row, bit) with t = inf on miss. Unlike the scene kernel, which
    multiplies by 1/|d|, the results are divided by |d|, as the
    reference does on this route."""
    o, dn, dlen, s_min, s_stop = _instance_rays(origin, direction, t_min,
                                                t_max)
    hit_s, row, bit = hdda_instance(tables.l1, tables.l2, tables.mask, o, dn,
                                    s_min, s_stop, mode=mode, rounds=rounds)
    return hit_s / dlen, row, bit


def trace_instance_ao_fg(tables: HDDATables, origin, direction, t_min, t_ao,
                         t_max, rounds: int = ROUNDS):
    """Fused AO + final-gather trace against one model. ``t_ao`` may
    exceed ``t_max``: the quirk plane then never fires. Returns (ao_t,
    fg_t, fg_row) with t = inf on miss."""
    o, dn, dlen, s_min, s_ao, s_stop = _instance_rays(
        origin, direction, t_min, t_ao, t_max)
    ao_s, fg_s, fg_row = hdda_instance(tables.l1, tables.l2, tables.mask, o,
                                       dn, s_min, s_stop, s_ao, mode="ao_fg",
                                       rounds=rounds)
    return ao_s / dlen, fg_s / dlen, fg_row


# ---------------------------------------------------------------------------
# Scene-level entry points (the contracts of trace_scene_pallas and
# trace_scene_pallas_ao_fg)
# ---------------------------------------------------------------------------

def _loop_route() -> bool:
    """The reference's switch between its two scene-trace routes."""
    return os.environ.get("DUST_PALLAS_SCENE") == "loop"


def _model_order(scene):
    """Instance indices sorted by model slot (stable)."""
    return sorted(range(scene.num_instances),
                  key=lambda i: scene.inst_model[i])


def front_to_back_ids(scene, origin):
    """The batched route's sweep order at more than 2 instances: model
    groups in model order, and within each group the instances sorted by
    the squared distance from the mean ray origin (miss lanes included,
    as in the reference) to the instance's world-space box centre.
    Returns (ids (I,) int32, world-to-object affines (I, 12)). Device
    ops only: no value comes back to the host.

    The kernel's merge keeps the first of two equal hits (strict ``<``),
    so the order decides which instance wins an exact tie; keeping the
    reference's order keeps ``inst`` exact."""
    order = _model_order(scene)
    dev = origin.device
    idx = torch.tensor(order, dtype=torch.long, device=dev)
    models = torch.tensor([scene.inst_model[i] for i in order],
                          dtype=torch.long, device=dev)
    center_m = 0.5 * (scene.model_aabb_min + scene.model_aabb_max)
    c = center_m[models]                                        # (I, 3)
    o2w = scene.obj_to_world[idx]
    cw = (o2w[:, :, :3] * c[:, None, :]).sum(dim=-1) + o2w[:, :, 3]
    mo = origin.float().mean(dim=0)
    dist = ((cw - mo[None, :]) ** 2).sum(dim=-1)                # (I,)
    parts = []
    start = 0
    for m in range(scene.num_models):
        cnt = sum(1 for im in scene.inst_model if im == m)
        if cnt == 0:
            continue
        seg = idx[start:start + cnt]
        if cnt > 1:
            seg = seg[torch.argsort(dist[start:start + cnt], stable=True)]
        parts.append(seg)
        start += cnt
    ids = torch.cat(parts)
    aff = scene.world_to_obj.reshape(-1, 12)[ids].contiguous()
    return ids.int(), aff


def _scene_args(scene, origin=None):
    """The batched kernel's sweep: instance model slots, ids and affines,
    plus the model AABBs. Model order, as the reference sweeps; at more
    than 2 instances near to far within each model group
    (:func:`front_to_back_ids`, which needs the rays' ``origin``)."""
    I = scene.num_instances
    dev = scene.device
    order = _model_order(scene)
    # The model of each sweep slot is fixed by the grouping alone.
    models = torch.tensor([scene.inst_model[i] for i in order],
                          dtype=torch.int32, device=dev)
    if I > 2:
        ids, aff = front_to_back_ids(scene, origin)
    else:
        idx = torch.tensor(order, dtype=torch.long, device=dev)
        ids = idx.int()
        aff = scene.world_to_obj[idx].reshape(I, 12).contiguous()
    aabb = torch.cat([scene.model_aabb_min, scene.model_aabb_max],
                     dim=-1).contiguous()
    return models, ids, aff, aabb


def _instance_tables(scene, m) -> HDDATables:
    return HDDATables(l1=scene.hdda_l1[m], l2=scene.hdda_l2[m],
                      mask=scene.hdda_mask[m])


def trace_scene(scene, origin, direction, t_min, t_max,
                mode: str = "precise") -> TraceResult:
    """Closest hit against every instance (world rays, unnormalised
    directions, world-parameter t bounds). The pass runs in the span
    ``dust.hdda.<mode>``."""
    with trace_annotation(f"dust.hdda.{mode}"):
        n = origin.shape[0]
        dev = origin.device
        if _loop_route():
            return _trace_scene_loop(scene, origin, direction,
                                     _per_ray(t_min, n, dev),
                                     _per_ray(t_max, n, dev), mode)
        models, ids, aff, aabb = _scene_args(scene, origin)
        t, inst, row, bit = hdda(
            scene.hdda_l1, scene.hdda_l2, scene.hdda_mask, models, ids, aff,
            aabb, origin.contiguous(), direction.contiguous(),
            _per_ray(t_min, n, dev), _per_ray(t_max, n, dev), mode=mode)
        return TraceResult(t=t, inst=inst, row=row, bit=bit)


def _trace_scene_loop(scene, origin, direction, t_min, t_max, mode):
    """The loop route of :func:`trace_scene`: instances in index order,
    each through the single-instance kernel."""
    n = origin.shape[0]
    dev = origin.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_row, best_bit = best_inst, best_inst
    for i, m in enumerate(scene.inst_model):
        w2o = scene.world_to_obj[i]
        o_obj = xform_point(w2o, origin)
        d_obj = xform_dir(w2o, direction)
        cap0 = torch.minimum(t_max, best_t)
        tn, cap = clip_to_model_aabb(scene, m, o_obj, d_obj, t_min, cap0)
        if mode == "ao_threshold":
            # The quirk plane is s_stop in the instance kernel: keep it at
            # the committed tmax; the box clip still culls misses.
            cap = torch.where(cap < tn, cap, cap0)
        t, row, bit = trace_instance(_instance_tables(scene, m), o_obj, d_obj,
                                     tn, cap, mode=mode)
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_inst = torch.where(closer, i, best_inst)
        best_row = torch.where(closer, row, best_row)
        best_bit = torch.where(closer, bit, best_bit)
    return TraceResult(t=best_t, inst=best_inst, row=best_row, bit=best_bit)


def trace_scene_ao_fg(scene, origin, direction, t_min, t_ao, t_max):
    """Fused AO + final-gather walk over every instance: precise voxel
    hits with the AO entry report below ``t_ao``, rough block hits past
    it. Returns two TraceResults (ao, fg); ao carries only t and inst.
    The pass runs in the span ``dust.hdda.ao_fg``."""
    with trace_annotation("dust.hdda.ao_fg"):
        n = origin.shape[0]
        dev = origin.device
        neg1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
        t_min, t_ao, t_max = (_per_ray(t, n, dev)
                              for t in (t_min, t_ao, t_max))
        if _loop_route():
            ao_t, ao_i, fg_t, fg_i, fg_row = _trace_scene_ao_fg_loop(
                scene, origin, direction, t_min, t_ao, t_max)
        else:
            models, ids, aff, aabb = _scene_args(scene, origin)
            ao_t, ao_i, fg_t, fg_i, fg_row = hdda(
                scene.hdda_l1, scene.hdda_l2, scene.hdda_mask, models, ids,
                aff, aabb, origin.contiguous(), direction.contiguous(), t_min,
                t_max, t_ao=t_ao, mode="ao_fg")
        return (TraceResult(t=ao_t, inst=ao_i, row=neg1, bit=neg1),
                TraceResult(t=fg_t, inst=fg_i, row=fg_row, bit=neg1))


def _trace_scene_ao_fg_loop(scene, origin, direction, t_min, t_ao, t_max):
    """The loop route of :func:`trace_scene_ao_fg`. Returns (ao_t, ao_inst,
    fg_t, fg_inst, fg_row)."""
    n = origin.shape[0]
    dev = origin.device
    ao_t = torch.full((n,), float("inf"), device=dev)
    fg_t = ao_t
    ao_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    fg_inst, fg_row = ao_inst, ao_inst
    for i, m in enumerate(scene.inst_model):
        w2o = scene.world_to_obj[i]
        o_obj = xform_point(w2o, origin)
        d_obj = xform_dir(w2o, direction)
        # fg hits lie past t_ao, so capping by the best fg so far never
        # clips the AO range; t_ao passes through unclipped.
        cap = torch.minimum(t_max, fg_t)
        tn, cap = clip_to_model_aabb(scene, m, o_obj, d_obj, t_min, cap)
        a_t, f_t, f_row = trace_instance_ao_fg(
            _instance_tables(scene, m), o_obj, d_obj, tn, t_ao, cap)
        a_closer = a_t < ao_t
        ao_t = torch.where(a_closer, a_t, ao_t)
        ao_inst = torch.where(a_closer, i, ao_inst)
        f_closer = f_t < fg_t
        fg_t = torch.where(f_closer, f_t, fg_t)
        fg_inst = torch.where(f_closer, i, fg_inst)
        fg_row = torch.where(f_closer, f_row, fg_row)
    return ao_t, ao_inst, fg_t, fg_inst, fg_row
