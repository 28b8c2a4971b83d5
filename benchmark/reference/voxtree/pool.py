"""u32-indexed object pool with an intrusive freelist.

Reference: ``crates/vdb/src/pool.rs`` — an untyped chunked pool where a
freed slot stores the next-free index in its first 4 bytes, and the doc
test (pool.rs:26-42) pins the alloc/free/reuse order:

* fresh allocations come from the bump ``top`` in increasing order,
* ``free`` pushes onto the freelist head,
* subsequent ``alloc`` pops the most recently freed slot (LIFO).

Here a pool is a growable numpy structured array. The intrusive freelist
is kept by storing the next-free index in field 0 of a freed row, exactly
like the reference, so tests can verify the same reuse order.

The port's copy of :mod:`dust_tpu.voxtree.pool`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Pool"]

_NIL = np.uint32(0xFFFFFFFF)


class Pool:
    """Typed object pool with u32 indices and LIFO slot reuse."""

    def __init__(self, dtype: np.dtype, chunk_size_log2: int = 12):
        self.dtype = np.dtype(dtype)
        if self.dtype.itemsize < 4:
            raise ValueError("pool items must be at least 4 bytes (freelist link)")
        self._chunk = 1 << chunk_size_log2
        self.data = np.zeros(0, dtype=self.dtype)
        self._head = _NIL  # freelist head
        self._top = 0  # bump allocator top
        self.count = 0  # live objects

    # -- freelist link access: first 4 bytes of the row ------------------
    def _get_link(self, index: int) -> np.uint32:
        return self.data[index : index + 1].view(np.uint32)[0]

    def _set_link(self, index: int, value: np.uint32) -> None:
        self.data[index : index + 1].view(np.uint32)[0] = value

    def alloc(self) -> int:
        """Allocate a slot; returns its u32 index. The slot is zeroed."""
        self.count += 1
        if self._head != _NIL:
            index = int(self._head)
            self._head = self._get_link(index)
            self.data[index] = np.zeros(1, dtype=self.dtype)[0]
            return index
        if self._top >= len(self.data):
            grow = np.zeros(max(self._chunk, len(self.data)), dtype=self.dtype)
            self.data = np.concatenate([self.data, grow])
        index = self._top
        self._top += 1
        return index

    def free(self, index: int) -> None:
        """Return a slot to the pool (LIFO reuse order)."""
        if not (0 <= index < self._top):
            raise IndexError(f"free of out-of-range slot {index}")
        self._set_link(index, self._head)
        self._head = np.uint32(index)
        self.count -= 1

    def alloc_contiguous(self, n: int) -> int:
        """Bulk-allocate ``n`` fresh rows from the bump top (fast path for
        vectorised tree builds; bypasses the freelist)."""
        if self._top + n > len(self.data):
            need = self._top + n - len(self.data)
            grow = np.zeros(max(need, self._chunk, len(self.data)), dtype=self.dtype)
            self.data = np.concatenate([self.data, grow])
        start = self._top
        self._top += n
        self.count += n
        return start

    @property
    def top(self) -> int:
        return self._top

    def __len__(self) -> int:
        return self.count
