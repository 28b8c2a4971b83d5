"""The least time of a frame's spatial-hash work on the card: the
yardstick of ``hash_roofline``. Frozen here, like ``benchmark.work``, so
that a change to the kernels or to the tensors the port passes them
leaves the count as it is while the work is the same.

It counts only what the cell's shape fixes, at 3.35 TB/s:

* each probed working-set key (one per face of each (instance, leaf)
  cell of the dense-cache layout) reads its 64-byte group row and the
  4-byte albedo word of its row, and writes its 12-byte working-set row;
  each cell's centre (three float32) and validity (one byte) are read
  once for its six keys;
* each inserted key (one per surfel of the pool, or of the frame's slice
  under a refresh budget) reads its key (three int32 and the face,
  int32), its value (three float32) and its validity (one byte).

The stable sort's passes, the applied rows' writes (their count depends
on the data, at most ``insert_cap``) and the copy of the table are left
out, so the figure is a floor.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet.
MEM_BYTES_PER_S = 3.35e12
# Every kernel of the hash's (``csrc/spatial_hash.cu``) holds this in its
# name.
KERNEL_MARK = "spatial_hash_"

# The castle-hash scene's working set (the castle and the teapot):
# cells of the dense-cache layout, padded as the reference pads it
# (``benchmark.reference.ops.gi_cache.dense_cells``), six keys each.
# ``benchmark/tests/test_harness_hashwork.py`` derives it again.
CASTLE_HASH_CELLS = 30_208
CASTLE_HASH_KEYS = 6 * CASTLE_HASH_CELLS

PROBE_KEY_BYTES = 64 + 4 + 12
PROBE_CELL_BYTES = 3 * 4 + 1
INSERT_KEY_BYTES = 4 * 4 + 3 * 4 + 1


def probe_bytes(keys: int, cells: int) -> int:
    """Bytes the working-set probe must move for ``keys`` keys over
    ``cells`` cells."""
    return keys * PROBE_KEY_BYTES + cells * PROBE_CELL_BYTES


def insert_bytes(keys: int) -> int:
    """Bytes the insert must read for ``keys`` keys."""
    return keys * INSERT_KEY_BYTES


def least_time_s(config: dict) -> float:
    """The least time of one frame's probe and insert of the castle-hash
    configuration ``config`` (its file's ``render`` entries)."""
    render = config["render"]
    if render["gi_cache"] != "hash":
        raise ValueError("the hash's work of a frame without the hash")
    slices = render["spatial_hash"].get("ws_refresh_slices", 1)
    keys = -(-CASTLE_HASH_KEYS // slices)
    cells = min(CASTLE_HASH_CELLS, keys)
    pool = render["surfels"]["pool_size"]
    budget = render["surfels"].get("pool_refresh_budget", 0)
    inserted = min(pool, budget) if budget else pool
    return (probe_bytes(keys, cells) + insert_bytes(inserted)) \
        / MEM_BYTES_PER_S


def device_s(trace) -> float | None:
    """Seconds of the hash's kernels in a traced slice
    (``devtrace.Slice``), or None when none ran."""
    times = [s for name, s in trace.device_ops.items() if KERNEL_MARK in name]
    return sum(times) if times else None
