"""Spatial-hash GI radiance cache (port of :mod:`dust_tpu.ops.spatial_hash`).

A 3-probe open-addressed hash keyed by (quantised leaf centre, cube face
id), after ``spatial_hash.glsl``: pcg-chained location hash,
xxhash32-chained fingerprint, LogLuv-packed radiance, LRU eviction by the
frame of the last insert, and a running mean capped at 404 samples.

Storage is one ``(capacity/4, 16)`` int32 table of 64-byte probe-group
rows, four slots of ``[fingerprint, LogLuv radiance, last_frame,
sample_count]`` each. A key's base slot is aligned to its group, so a
get is one row gather and an insert a read-modify-write of whole rows.

Inserts are deterministic, as in the reference: the batch is sorted by
group, each run of one (group, fingerprint) is summed by a segmented scan
paired as ``jax.lax.associative_scan`` pairs it (so the float32 sums are
the reference's), the first run of each group applies, and the new rows
replace the old in one row copy. Unsigned 32-bit hashing runs in int64
masked to 32 bits (torch's ``uint32`` lacks multiply and shifts on many
backends).

The frame's two uses have kernels in ``csrc/spatial_hash.cu``:
:func:`probe_working_set` (the working set's probe and packing) and
:func:`hash_insert`. On CPU tensors they run their plain versions,
:func:`probe_working_set_plain` and :func:`hash_insert_plain` (this
module's torch code); on CUDA tensors they launch the kernels, and on
any other device they raise. :data:`LIBRARY`
(:class:`dust_tpu_torch.csrc.Library`) builds them at the first launch
and counts each launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from dust_tpu_torch import csrc
from dust_tpu_torch.csrc import check, f32_recip, on_cuda
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops import packing as pk
from dust_tpu_torch.ops.fp import as_i32, as_u32, fma
from dust_tpu_torch.ops.packing import decode_logluv, encode_logluv
from dust_tpu_torch.utils import color as colorlib

__all__ = ["SpatialHash", "make_spatial_hash", "hash_get", "hash_insert",
           "hash_insert_plain", "probe_working_set",
           "probe_working_set_plain", "spatial_hash_key", "key_fingerprint",
           "key_location", "logluv", "LIBRARY", "LAUNCHES",
           "MAX_SAMPLE_COUNT"]

MAX_SAMPLE_COUNT = 404
_M32 = 0xFFFFFFFF

# Keys a scan block of the insert's suffix sums (kScanBlock in the source).
_SCAN_BLOCK = 1024

# Launches of each kernel (spatial_hash_<name>_kernel) since the last
# reset; the plain versions count nothing.
LAUNCHES = {"probe": 0, "keys": 0, "scan_up": 0, "scan_blocks": 0,
            "scan": 0, "apply": 0, "logluv": 0}


class SpatialHash(NamedTuple):
    """One (C/4, 16) int32 table of probe-group rows (module doc)."""

    table: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.table.shape[0] * 4

    # Slot-major field views, for tests and inspection; the 32-bit words
    # as int64 in [0, 2^32).
    @property
    def fingerprint(self) -> torch.Tensor:
        return as_u32(self.table.reshape(-1, 4)[:, 0])

    @property
    def radiance(self) -> torch.Tensor:
        return as_u32(self.table.reshape(-1, 4)[:, 1])

    @property
    def last_frame(self) -> torch.Tensor:
        return self.table.reshape(-1, 4)[:, 2]

    @property
    def sample_count(self) -> torch.Tensor:
        return self.table.reshape(-1, 4)[:, 3]


def make_spatial_hash(capacity: int, device) -> SpatialHash:
    if capacity % 4:
        raise ValueError("spatial hash capacity must be a multiple of 4")
    return SpatialHash(table=torch.zeros((capacity // 4, 16),
                                         dtype=torch.int32, device=device))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for ``a`` in [0, 2^32) (int64): two partial
    products, neither past 2^48, so nothing overflows int64."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _pcg(v: torch.Tensor) -> torch.Tensor:
    """pcg (spatial_hash.glsl:105-111) on int64 words in [0, 2^32)."""
    state = (_mul32(v, 747796405) + 2891336453) & _M32
    word = _mul32(((state >> ((state >> 28) + 4)) ^ state) & _M32, 277803737)
    return (word >> 22) ^ word


def _xxhash32(p: torch.Tensor) -> torch.Tensor:
    """xxhash32 (spatial_hash.glsl:115-126) on int64 words in [0, 2^32)."""
    h = (p + 374761393) & _M32
    h = _mul32(((h << 17) & _M32) | (h >> 15), 668265263)
    h = _mul32(h ^ (h >> 15), 2246822519)
    h = _mul32(h ^ (h >> 13), 3266489917)
    return h ^ (h >> 16)


def spatial_hash_key(world_pos: torch.Tensor, face_id: torch.Tensor,
                     cell_size: float = 4.0):
    """(qpos, face) of a leaf centre: ``trunc(world_pos / cell_size)``
    as int32 (GLSL ``ivec3()`` truncates toward zero)."""
    return (torch.trunc(world_pos / cell_size).int(), face_id.int())


def key_fingerprint(qpos: torch.Tensor, face_id: torch.Tensor) -> torch.Tensor:
    """The key's nonzero 32-bit fingerprint, int64 in [1, 2^32)."""
    h = _xxhash32(as_u32(qpos[..., 0]))
    h = _xxhash32((as_u32(qpos[..., 1]) + h) & _M32)
    h = _xxhash32((as_u32(qpos[..., 2]) + h) & _M32)
    h = _xxhash32((as_u32(face_id) + h) & _M32)
    return torch.clamp(h, min=1)


def key_location(qpos: torch.Tensor, face_id: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """The key's base slot (int64), aligned to its 4-slot group."""
    h = _pcg(as_u32(qpos[..., 0]))
    h = _pcg((as_u32(qpos[..., 1]) + h) & _M32)
    h = _pcg((as_u32(qpos[..., 2]) + h) & _M32)
    h = _pcg((as_u32(face_id) + h) & _M32)
    return (h % (capacity // 4)) * 4


def _word(rows: torch.Tensor, i) -> torch.Tensor:
    """Word ``i`` (an int or a per-row int64 tensor) of each 16-word row."""
    if isinstance(i, int):
        return rows[:, i]
    return torch.gather(rows, 1, i[:, None])[:, 0]


def hash_get(hash_: SpatialHash, qpos: torch.Tensor, face_id: torch.Tensor):
    """SpatialHashGet (spatial_hash.glsl:200-220) of keys ``qpos`` (N, 3),
    ``face_id`` (N,). Returns (found, radiance_acescg (N, 3), count)."""
    fingerprint = key_fingerprint(qpos, face_id)
    group = hash_.table[key_location(qpos, face_id, hash_.capacity) >> 2]
    fp0, fp1, fp2 = (as_u32(group[:, k]) for k in (0, 4, 8))
    # Probe i is reached only past occupied non-matches.
    me0 = (fp0 == fingerprint) | (fp0 == 0)
    me1 = (fp1 == fingerprint) | (fp1 == 0)
    hit0 = fp0 == fingerprint
    hit1 = (fp1 == fingerprint) & ~me0
    hit2 = (fp2 == fingerprint) & ~me0 & ~me1
    found = hit0 | hit1 | hit2
    probe = torch.where(hit0, 0, torch.where(hit1, 1, 2))
    radiance = decode_logluv(_word(group, probe * 4 + 1))
    count = _word(group, probe * 4 + 3)
    return (found, torch.where(found[:, None], radiance, 0.0),
            torch.where(found, count, 0))


def _segmented_suffix_sums(start: torch.Tensor, values: torch.Tensor):
    """Per element, the sum of ``values`` from it to the end of its run
    (runs begin where ``start`` is set), computed on the reversed arrays
    with ``jax.lax.associative_scan``'s pairing of the segmented-sum
    operator, so each float32 sum adds in the reference's order."""
    flags = torch.cat([start.new_ones(1), start.flip(0)[:-1]])
    _, sums = _scan(flags, values.flip(0))
    return sums.flip(0)


def _combine(af, av, bf, bv):
    return af | bf, torch.where(bf[:, None], bv, av + bv)


def _scan(f, v):
    """Inclusive scan of the segmented-sum operator: pairs of neighbours
    combine, the half-length scan recurses, and the even positions take
    the odd results combined with their own element."""
    n = f.shape[0]
    if n < 2:
        return f, v
    odd_f, odd_v = _scan(*_combine(f[0:-1:2], v[0:-1:2], f[1::2], v[1::2]))
    if n % 2 == 0:
        even_f, even_v = _combine(odd_f[:-1], odd_v[:-1], f[2::2], v[2::2])
    else:
        even_f, even_v = _combine(odd_f, odd_v, f[2::2], v[2::2])
    out_f = torch.empty_like(f)
    out_v = torch.empty_like(v)
    out_f[0], out_v[0] = f[0], v[0]
    out_f[2::2], out_v[2::2] = even_f, even_v
    out_f[1::2], out_v[1::2] = odd_f, odd_v
    return out_f, out_v


def hash_insert(hash_: SpatialHash, qpos: torch.Tensor, face_id: torch.Tensor,
                value: torch.Tensor, frame_index: int, valid=None,
                max_updates: int | None = None) -> SpatialHash:
    """SpatialHashInsert (spatial_hash.glsl:147-195), batched and
    deterministic: ACEScg ``value`` (N, 3) at keys ``qpos`` (N, 3),
    ``face_id`` (N,), where ``valid`` (N,) is set. Of the groups that
    apply, the first ``max_updates`` in group order are written and the
    rest wait for a later batch. Returns a new table; the old one is kept.

    CPU tensors run :func:`hash_insert_plain`; any other launch the
    kernels (:func:`_insert_kernels`)."""
    if qpos.device.type == "cpu":
        return hash_insert_plain(hash_, qpos, face_id, value, frame_index,
                                 valid, max_updates)
    return _insert_kernels(hash_, qpos, face_id, value, frame_index, valid,
                           max_updates)


def hash_insert_plain(hash_: SpatialHash, qpos: torch.Tensor,
                      face_id: torch.Tensor, value: torch.Tensor,
                      frame_index: int, valid=None,
                      max_updates: int | None = None) -> SpatialHash:
    """:func:`hash_insert` in torch ops on any device."""
    qpos = qpos.reshape(-1, 3)
    face_id = face_id.reshape(-1)
    value = value.reshape(-1, 3)
    n = qpos.shape[0]
    dev = qpos.device
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
             else valid.reshape(-1))
    table = hash_.table
    ngroups = table.shape[0]
    fingerprint = key_fingerprint(qpos, face_id)
    group = key_location(qpos, face_id, hash_.capacity) >> 2

    # ---- batch duplicates: one run per (group, fingerprint) -----------
    order = torch.argsort(torch.where(valid, group, ngroups), stable=True)
    s_group = torch.where(valid, group, ngroups)[order]
    s_fp = fingerprint[order]
    s_valid = valid[order]
    new_group = s_group[1:] != s_group[:-1]
    first = torch.cat([s_valid.new_ones(1),
                       new_group | (s_fp[1:] != s_fp[:-1])]) & s_valid
    contrib = torch.cat([torch.where(s_valid[:, None], value[order], 0.0),
                         s_valid.float()[:, None]], dim=-1)
    totals = _segmented_suffix_sums(first, contrib)
    gsum, gcnt = totals[:, :3], totals[:, 3]

    # One representative per group: the first fingerprint's run.
    grp_first = torch.cat([s_valid.new_ones(1), new_group])
    apply_mask = first & grp_first & (s_group < ngroups)
    k = torch.where(apply_mask, gcnt, 0.0)
    vbar = gsum / torch.clamp(gcnt, min=1.0)[:, None]

    # ---- read-modify-write of the unique group rows --------------------
    tgt = torch.where(apply_mask, s_group, ngroups - 1)
    cur = table[tgt]
    fp0, fp1, fp2 = (as_u32(cur[:, w]) for w in (0, 4, 8))
    me0 = (fp0 == s_fp) | (fp0 == 0)
    me1 = (fp1 == s_fp) | (fp1 == 0)
    me2 = (fp2 == s_fp) | (fp2 == 0)
    lf0, lf1, lf2 = cur[:, 2], cur[:, 6], cur[:, 10]
    lru = torch.where(lf0 <= torch.minimum(lf1, lf2), 0,
                      torch.where(lf1 <= lf2, 1, 2))
    probe = torch.where(me0, 0, torch.where(me1, 1, torch.where(me2, 2, lru)))

    same = as_u32(_word(cur, probe * 4)) == s_fp
    c0 = torch.where(same, _word(cur, probe * 4 + 3), 0).float()
    c0 = torch.clamp(c0, max=MAX_SAMPLE_COUNT - 1)
    r0 = torch.where(same[:, None], decode_logluv(_word(cur, probe * 4 + 1)),
                     0.0)
    new_cnt = torch.clamp(c0 + k, max=MAX_SAMPLE_COUNT)
    new_rad = (fma(r0, c0[:, None], vbar * k[:, None])
               / torch.clamp(c0 + k, min=1.0)[:, None])
    fields = torch.stack([as_i32(s_fp), as_i32(encode_logluv(new_rad)),
                          torch.full_like(tgt, int(frame_index)).int(),
                          new_cnt.int()], dim=-1)
    word_slot = torch.arange(16, device=dev) >> 2
    new_rows = torch.where(word_slot == probe[:, None], fields.repeat(1, 4),
                           cur)

    # The first max_updates applied rows in sorted order write (the
    # reference's stable applied-first partition); the rest drop. Dropped
    # rows go to a spare row past the table, which is then cut off.
    if max_updates is not None and max_updates < n:
        apply_mask = apply_mask & (torch.cumsum(apply_mask, 0) <= max_updates)
    upd = torch.where(apply_mask, tgt, ngroups)
    out = torch.empty((ngroups + 1, 16), dtype=table.dtype, device=dev)
    out[:ngroups] = table
    out.index_copy_(0, upd, new_rows)
    return SpatialHash(table=out[:ngroups])


# ---------------------------------------------------------------------------
# The working set


def probe_working_set(hash_: SpatialHash, centers: torch.Tensor,
                      valid_cells: torch.Tensor, cell_size: float,
                      albedo: torch.Tensor | None = None,
                      ws: torch.Tensor | None = None, lo: int = 0,
                      hi: int | None = None) -> torch.Tensor:
    """The hash frame's working set: one :func:`hash_get` per key of
    (face, cell), at row ``face * cells + cell``, of the world-space leaf
    centres ``centers`` (cells, 3), packed into dense-cache rows
    (:func:`~dust_tpu_torch.ops.gi_cache.pack_working_set_rows`); a cell
    that is not in ``valid_cells`` (cells,) reads count 0. Without ``ws``
    every row, with the albedo words ``albedo`` (rows,) as its third word;
    with ``ws``, the last working set's (rows, 3) table, a copy of it in
    which the rows ``[lo, hi)`` are probed again and keep their albedo.

    CPU tensors run :func:`probe_working_set_plain`; any other launch
    ``spatial_hash_probe_kernel``."""
    if centers.device.type == "cpu":
        return probe_working_set_plain(hash_, centers, valid_cells,
                                       cell_size, albedo, ws, lo, hi)
    return _probe_kernel(hash_, centers, valid_cells, cell_size, albedo, ws,
                         lo, hi)


def probe_working_set_plain(hash_: SpatialHash, centers: torch.Tensor,
                            valid_cells: torch.Tensor, cell_size: float,
                            albedo: torch.Tensor | None = None,
                            ws: torch.Tensor | None = None, lo: int = 0,
                            hi: int | None = None) -> torch.Tensor:
    """:func:`probe_working_set` in torch ops on any device."""
    cells = centers.shape[0]
    face6 = torch.arange(6, dtype=torch.int32,
                         device=centers.device)[:, None].expand(6, cells)
    qpos6, face6 = spatial_hash_key(centers.repeat(6, 1), face6.reshape(-1),
                                    cell_size)
    valid6 = valid_cells.repeat(6)
    if ws is not None:
        window = slice(lo, 6 * cells if hi is None else hi)
        found, rad, cnt = hash_get(hash_, qpos6[window], face6[window])
        cnt = torch.where(found & valid6[window], cnt, 0)
        table = ws.clone()
        table[window] = gilib.pack_working_set_rows(rad, cnt,
                                                    table[window, 2:3])
        return table
    found, rad, cnt = hash_get(hash_, qpos6, face6)
    cnt = torch.where(found & valid6, cnt, 0)
    return gilib.pack_working_set_rows(rad, cnt, albedo[:, None])


# ---------------------------------------------------------------------------
# The kernels' launches

_vp, _ci, _ll, _cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)


class _LogLuv(ctypes.Structure):
    _fields_ = [("acescg_to_xyz", _cf * 9), ("xyz_to_acescg", _cf * 9),
                ("inv_409_6", _cf), ("ln2", _cf), ("inv_ln2", _cf),
                ("u4", _cf), ("u6", _cf), ("u9", _cf), ("u16", _cf)]


class _ProbeArgs(ctypes.Structure):
    _fields_ = [("table", _vp), ("centers", _vp), ("valid_cells", _vp),
                ("albedo", _vp), ("out", _vp), ("cells", _ll), ("lo", _ll),
                ("hi", _ll), ("ngroups", _ll), ("inv_cell", _cf),
                ("luv", _LogLuv)]


class _InsertArgs(ctypes.Structure):
    _fields_ = [(name, _vp) for name in (
        "table", "out", "qpos", "face", "valid", "value", "gkey", "fp",
        "s_gkey", "order", "tree_v", "tree_f", "block_fold", "block_count",
        "block_before", "applied", "sums", "rank")] + [
        ("n", _ll), ("ngroups", _ll), ("cap", _ll), ("frame_index", _ci),
        ("luv", _LogLuv)]


class _LogLuvArgs(ctypes.Structure):
    _fields_ = [("words", _vp), ("rgb", _vp), ("out_words", _vp),
                ("n", _ll), ("luv", _LogLuv)]


def _f32(x: float) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def _logluv_constants() -> _LogLuv:
    """packing.py's LogLuv constants, as its torch code applies them: the
    division by ``_LN2`` is a multiply by its float32 reciprocal on the
    card (a tensor divided by a Python number)."""
    def mat(m):
        return (_cf * 9)(*[_f32(m[i][j]) for i in range(3) for j in range(3)])

    return _LogLuv(acescg_to_xyz=mat(colorlib.ACESCG_TO_XYZ),
                   xyz_to_acescg=mat(colorlib.XYZ_TO_ACESCG),
                   inv_409_6=pk._INV_409_6, ln2=pk._LN2,
                   inv_ln2=f32_recip(pk._LN2), u4=pk._U_SCALE[4],
                   u6=pk._U_SCALE[6], u9=pk._U_SCALE[9],
                   u16=pk._U_SCALE[16])


LIBRARY = csrc.Library("spatial_hash.cu", "spatial_hash", {
    "spatial_hash_probe_launch": ([_vp], LAUNCHES),
    "spatial_hash_insert_launch": ([_vp, _ci], LAUNCHES),
    "spatial_hash_logluv_launch": ([_vp], LAUNCHES)})


def _table(hash_: SpatialHash, dev):
    table = hash_.table
    ngroups = table.shape[0]
    check("table", table, torch.int32, (ngroups, 16), dev)
    if ngroups >= 2 ** 31:
        raise ValueError(f"table: {ngroups} groups, more than int32 holds")
    return table, ngroups


def _probe_kernel(hash_, centers, valid_cells, cell_size, albedo, ws, lo,
                  hi):
    """Launch ``spatial_hash_probe_kernel`` (contract of
    :func:`probe_working_set`)."""
    dev = centers.device
    cells = centers.shape[0]
    rows = 6 * cells
    hi = rows if hi is None else hi
    on_cuda("spatial_hash_probe", dev, rows, "keys")
    if not 0 <= lo <= hi <= rows:
        raise ValueError(f"probe rows [{lo}, {hi}) outside [0, {rows})")
    table, ngroups = _table(hash_, dev)
    check("centers", centers, torch.float32, (cells, 3), dev)
    check("valid_cells", valid_cells, torch.bool, (cells,), dev)
    if ws is None:
        check("albedo", albedo, torch.int32, (rows,), dev)
        out = torch.empty((rows, 3), dtype=torch.int32, device=dev)
    else:
        check("ws", ws, torch.int32, (rows, 3), dev)
        out = ws.clone()
    args = _ProbeArgs(
        table=table.data_ptr(), centers=centers.data_ptr(),
        valid_cells=valid_cells.data_ptr(),
        albedo=None if ws is not None else albedo.data_ptr(),
        out=out.data_ptr(), cells=cells, lo=lo, hi=hi, ngroups=ngroups,
        inv_cell=f32_recip(cell_size), luv=_logluv_constants())
    LIBRARY.launch("spatial_hash_probe_launch", ctypes.addressof(args),
                   device=dev, count="probe")
    return out


def _insert_kernels(hash_, qpos, face_id, value, frame_index, valid,
                    max_updates):
    """The insert's kernels (contract of :func:`hash_insert`): the keys,
    the stable sort (torch), the three scan launches and the apply, into a
    torch copy of the table."""
    args, out = _insert_args(hash_, qpos, face_id, value, frame_index, valid,
                             max_updates)
    if args is not None:
        _insert_run(args, qpos.device)
    return SpatialHash(table=out)


def _insert_args(hash_, qpos, face_id, value, frame_index, valid,
                 max_updates):
    """The checked launch arguments of the insert and the table's copy
    they write, with their scratch allocated; (None, copy) without keys."""
    qpos = qpos.reshape(-1, 3).contiguous()
    face_id = face_id.reshape(-1).contiguous()
    value = value.reshape(-1, 3).contiguous()
    n = qpos.shape[0]
    dev = qpos.device
    on_cuda("spatial_hash_insert", dev, n, "keys")
    table, ngroups = _table(hash_, dev)
    check("qpos", qpos, torch.int32, (n, 3), dev)
    check("face_id", face_id, torch.int32, (n,), dev)
    check("value", value, torch.float32, (n, 3), dev)
    if valid is not None:
        valid = valid.reshape(-1).contiguous()
        check("valid", valid, torch.bool, (n,), dev)
    out = table.clone()
    if n == 0:
        return None, out

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    nfull = n // _SCAN_BLOCK
    keep = dict(
        qpos=qpos, face=face_id, value=value, valid=valid, gkey=empty(n),
        fp=empty(n), tree_v=empty(max(2 * nfull, 1), 4, dtype=torch.float32),
        tree_f=empty(max(2 * nfull, 1), dtype=torch.uint8),
        block_fold=empty(max(nfull, 1), 4, dtype=torch.float32),
        block_count=empty(-(-n // _SCAN_BLOCK)),
        block_before=empty(-(-n // _SCAN_BLOCK)), applied=empty(1),
        sums=empty(n, 4, dtype=torch.float32), rank=empty(n))
    args = _InsertArgs(
        table=table.data_ptr(), out=out.data_ptr(), n=n, ngroups=ngroups,
        cap=-1 if max_updates is None or max_updates >= n else max_updates,
        frame_index=(int(frame_index) + 2 ** 31) % 2 ** 32 - 2 ** 31,
        luv=_logluv_constants(),
        **{k: None if t is None else t.data_ptr() for k, t in keep.items()})
    args.keep = keep  # alive as long as the arguments point into it
    return args, out


def _insert_run(args, dev):
    """The insert's launches on ``args`` (:func:`_insert_args`): the keys,
    the sort by group, the scans and the apply."""
    _insert_step(args, dev, 0)
    s_gkey, order = torch.sort(args.keep["gkey"], stable=True)
    args.keep.update(s_gkey=s_gkey, order=order)
    args.s_gkey, args.order = s_gkey.data_ptr(), order.data_ptr()
    for step in range(1, 5):
        _insert_step(args, dev, step)


_INSERT_STEPS = ("keys", "scan_up", "scan_blocks", "scan", "apply")


def _insert_step(args, dev, step: int):
    """Launch the insert's kernel ``step`` (0-4: keys, scan_up,
    scan_blocks, scan, apply) with the arguments ``args``."""
    LIBRARY.launch("spatial_hash_insert_launch", ctypes.addressof(args), step,
                   device=dev, count=_INSERT_STEPS[step])


def logluv(x: torch.Tensor) -> torch.Tensor:
    """``spatial_hash_logluv_kernel`` on a CUDA tensor: int32 LogLuv words
    (N,) decoded to ACEScg (N, 3) float32, or (N, 3) float32 encoded to
    int32 words (N,); the kernels' own codec, held to
    :func:`~dust_tpu_torch.ops.packing.decode_logluv` and
    :func:`~dust_tpu_torch.ops.packing.encode_logluv` by the tests."""
    x = x.contiguous()
    dev = x.device
    n = x.shape[0]
    on_cuda("spatial_hash_logluv", dev, n, "keys")
    if x.dtype == torch.int32:
        check("words", x, torch.int32, (n,), dev)
        out = torch.empty((n, 3), dtype=torch.float32, device=dev)
        args = _LogLuvArgs(words=x.data_ptr(), rgb=out.data_ptr(),
                           out_words=None, n=n, luv=_logluv_constants())
    else:
        check("rgb", x, torch.float32, (n, 3), dev)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        args = _LogLuvArgs(words=None, rgb=x.data_ptr(),
                           out_words=out.data_ptr(), n=n,
                           luv=_logluv_constants())
    LIBRARY.launch("spatial_hash_logluv_launch", ctypes.addressof(args),
                   device=dev, count="logluv")
    return out
