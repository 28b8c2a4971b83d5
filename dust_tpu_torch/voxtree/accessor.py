"""Cached-path point accessor.

Reference: ``crates/vdb/src/accessor.rs`` — instead of re-entering the tree
from the root for every query, keep the pointer path of the previous query
and re-enter at the lowest common ancestor (LCA), found by XOR-ing the old
and new coordinates and comparing against per-level extent masks
(accessor.rs:15-30). The unit test at accessor.rs:147-198 (randomised
set/get round-trip through the cached accessor) is mirrored in
``tests/test_voxtree.py`` (TestAccessor).
"""

from __future__ import annotations

import numpy as np

from dust_tpu_torch.voxtree import tree as _t

__all__ = ["Accessor", "lowest_common_ancestor_level"]

# Extent log2 of each level's node: leaf covers 4, internal 16, root 256.
_LEVEL_EXTENT_LOG2 = (2, 4, 8)


def lowest_common_ancestor_level(a, b) -> int:
    """Level at which paths to voxels ``a`` and ``b`` diverge.

    0 = same leaf, 1 = same internal node, 2 = same root cell or beyond
    (re-enter from the root directory).
    """
    diff = (int(a[0]) ^ int(b[0])) | (int(a[1]) ^ int(b[1])) | (int(a[2]) ^ int(b[2]))
    for level, log2 in enumerate(_LEVEL_EXTENT_LOG2[:-1]):
        if diff < (1 << log2):
            return level
    return 2


class Accessor:
    """Read/write accessor over a :class:`~dust_tpu_torch.voxtree.tree.VoxTree`
    with an LCA-cached path."""

    def __init__(self, tree: _t.VoxTree):
        self.tree = tree
        self._last: tuple[int, int, int] | None = None
        self._int_ptr: int = -1
        self._leaf_ptr: int = -1

    def _descend(self, coords, create: bool) -> int:
        """Refresh the cached path for ``coords``; returns leaf ptr or -1."""
        x, y, z = coords
        level = 2 if self._last is None else lowest_common_ancestor_level(self._last, coords)
        self._last = coords

        if level >= 2 or self._int_ptr < 0:
            ri = _t._root_index(coords)
            ptr = int(self.tree.root[ri])
            if ptr == _t._NIL:
                if not create:
                    self._int_ptr = -1
                    self._leaf_ptr = -1
                    return -1
                ptr = self.tree.internal_pool.alloc()
                self.tree.internal_pool.data[ptr]["child_ptrs"][:] = _t._NIL
                self.tree.root[ri] = ptr
            self._int_ptr = ptr
            level = 1

        if level >= 1 or self._leaf_ptr < 0:
            node = self.tree.internal_pool.data[self._int_ptr]
            ii = _t._internal_index(coords)
            ptr = int(node["child_ptrs"][ii])
            if ptr == _t._NIL:
                if not create:
                    self._leaf_ptr = -1
                    return -1
                ptr = self.tree.leaf_pool.alloc()
                node["child_ptrs"][ii] = ptr
                node["child_mask"] = np.uint64(int(node["child_mask"]) | (1 << ii))
            self._leaf_ptr = ptr
        return self._leaf_ptr

    def get(self, coords) -> bool | None:
        coords = tuple(int(c) for c in coords)
        _t.VoxTree._check_bounds(*coords)
        leaf_ptr = self._descend(coords, create=False)
        if leaf_ptr < 0:
            return None
        leaf = self.tree.leaf_pool.data[leaf_ptr]
        bit = _t.leaf_bit_index(*coords)
        if not (int(leaf["occupancy"]) >> bit) & 1:
            return None
        return bool((int(leaf["active"]) >> bit) & 1)

    def set(self, coords, value: bool | None) -> None:
        coords = tuple(int(c) for c in coords)
        _t.VoxTree._check_bounds(*coords)
        leaf_ptr = self._descend(coords, create=value is not None)
        if leaf_ptr < 0:
            return
        leaf = self.tree.leaf_pool.data[leaf_ptr]
        bit = _t.leaf_bit_index(*coords)
        occ = int(leaf["occupancy"])
        act = int(leaf["active"])
        if value is None:
            occ &= ~(1 << bit)
        else:
            occ |= 1 << bit
            act = (act | (1 << bit)) if value else (act & ~(1 << bit))
        leaf["occupancy"] = np.uint64(occ)
        leaf["active"] = np.uint64(act)
