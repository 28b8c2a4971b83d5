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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ops.fp import as_i32, as_u32, fma
from benchmark.reference.ops.packing import decode_logluv, encode_logluv

__all__ = ["SpatialHash", "make_spatial_hash", "hash_get", "hash_insert",
           "spatial_hash_key", "key_fingerprint", "key_location",
           "MAX_SAMPLE_COUNT"]

MAX_SAMPLE_COUNT = 404
_M32 = 0xFFFFFFFF


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
    rest wait for a later batch. Returns a new table; the old one is kept."""
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
