"""Generic tree hierarchies + the unbounded root.

Reference: the ``hierarchy!`` macro (``crates/vdb/src/node/mod.rs:113-127``)
instantiates a tree type from a list of per-level log2 fanouts, and
``RootNode`` (``crates/vdb/src/node/root.rs:28``) is an infinite hashmap of
top-level children so worlds are unbounded. The renderer's production tree
(:class:`dust_tpu_torch.voxtree.tree.VoxTree`) is the fixed ``(4,2,2)``
instantiation — its fixed 256³ shape is what the TPU acceleration tables
(dense cell grid, L1/L2 bitmaps, rank tables) are built around, exactly as
the reference's importer fixes ``hierarchy!(4,2,2)``
(``crates/vox/src/lib.rs:19``).

This module supplies the two generalisations TPU-first rather than as a
macro:

* :class:`GenericTree` — any level spec, pooled nodes, tri-state voxels
  (occupancy/active masks, ``leaf.rs:83-109`` semantics). It is the
  *generality seam*: the (4,2,2) instantiation is tested equivalent to the
  specialized ``VoxTree``.
* :class:`UnboundedRoot` — an infinite hashmap of 256³ **tiles** over
  signed world coordinates. Instead of teaching the traversal kernel an
  unbounded address space (which would wreck its VMEM-resident tables),
  each tile IS a renderable ≤256³ model and :meth:`UnboundedRoot.to_scene`
  emits the standard instanced scene — the scene graph plays the role of
  the reference's root hashmap, and the existing TLAS-style per-instance
  loop renders a world of any size.
"""

from __future__ import annotations

import numpy as np

__all__ = ["GenericTree", "UnboundedRoot", "TILE", "tile_of", "local_of"]

TILE = 256  # tile extent: one (4,2,2) model per tile


class _Level:
    """One pooled level: per-node child mask (python int, arbitrary
    width) + child pointer list."""

    __slots__ = ("masks", "ptrs")

    def __init__(self):
        self.masks: list[int] = []
        self.ptrs: list[list[int]] = []

    def alloc(self, fanout3: int) -> int:
        self.masks.append(0)
        self.ptrs.append([0] * fanout3)
        return len(self.masks) - 1


class GenericTree:
    """``hierarchy!(levels...)``: ``levels[i]`` is level i's log2 fanout
    per axis; the last level is the leaf extent. Extent = 2**sum(levels).

    Voxel tri-state (leaf.rs:83-109): ``None`` when the occupancy bit is
    clear, else ``bool(active bit)``."""

    def __init__(self, levels=(4, 2, 2)):
        if len(levels) < 2 or any(l < 1 for l in levels):
            raise ValueError("need >=2 levels of log2 fanout >=1")
        self.levels = tuple(int(l) for l in levels)
        self.extent = 1 << sum(self.levels)
        # Shift of each level's index field within a coordinate.
        shifts = []
        acc = 0
        for l in reversed(self.levels):
            shifts.append(acc)
            acc += l
        self._shifts = tuple(reversed(shifts))  # per level, high to low
        # Internal levels 0..k-2 (level 0 = single root node).
        self._internals = [_Level() for _ in range(len(self.levels) - 1)]
        self._internals[0].alloc(self._fanout3(0))
        # Leaves: occupancy/active masks as python ints (fanout³ bits).
        self._leaf_occ: list[int] = []
        self._leaf_act: list[int] = []

    def _fanout3(self, lvl: int) -> int:
        return 1 << (3 * self.levels[lvl])

    def _child_index(self, lvl: int, x: int, y: int, z: int) -> int:
        """Bit index of (x,y,z) within its level-``lvl`` node — the
        generic form of ``(x<<4)|(y<<2)|z``."""
        l = self.levels[lvl]
        s = self._shifts[lvl]
        m = (1 << l) - 1
        return ((((x >> s) & m) << (2 * l))
                | (((y >> s) & m) << l)
                | ((z >> s) & m))

    def _walk(self, coords, create: bool):
        """Descend to the leaf holding ``coords``; returns leaf pool index
        or None. Allocates the path when ``create``."""
        x, y, z = (int(c) for c in coords)
        if not (0 <= x < self.extent and 0 <= y < self.extent
                and 0 <= z < self.extent):
            raise IndexError(f"({x},{y},{z}) outside extent {self.extent}")
        node = 0
        k = len(self.levels)
        for lvl in range(k - 1):
            lev = self._internals[lvl]
            ci = self._child_index(lvl, x, y, z)
            if not (lev.masks[node] >> ci) & 1:
                if not create:
                    return None
                if lvl + 1 < k - 1:
                    child = self._internals[lvl + 1].alloc(
                        self._fanout3(lvl + 1))
                else:
                    child = len(self._leaf_occ)
                    self._leaf_occ.append(0)
                    self._leaf_act.append(0)
                lev.masks[node] |= 1 << ci
                lev.ptrs[node][ci] = child
            node = lev.ptrs[node][ci]
        return node

    def set_value(self, coords, value: bool | None) -> None:
        leaf = self._walk(coords, create=value is not None)
        if leaf is None:
            return
        bit = self._child_index(len(self.levels) - 1, *map(int, coords))
        if value is None:
            self._leaf_occ[leaf] &= ~(1 << bit)
            self._leaf_act[leaf] &= ~(1 << bit)
        else:
            self._leaf_occ[leaf] |= 1 << bit
            if value:
                self._leaf_act[leaf] |= 1 << bit
            else:
                self._leaf_act[leaf] &= ~(1 << bit)

    def get_value(self, coords) -> bool | None:
        leaf = self._walk(coords, create=False)
        if leaf is None:
            return None
        bit = self._child_index(len(self.levels) - 1, *map(int, coords))
        if not (self._leaf_occ[leaf] >> bit) & 1:
            return None
        return bool((self._leaf_act[leaf] >> bit) & 1)

    def iter_leaf(self):
        """Yield (leaf_origin (3,), occupancy int, active int) in
        depth-first child-index order (the reference's iteration order)."""
        k = len(self.levels)

        def rec(lvl, node, ox, oy, oz):
            lev = self._internals[lvl]
            l = self.levels[lvl]
            s = self._shifts[lvl]
            mask = lev.masks[node]
            ci = 0
            fan = 1 << l
            for cx in range(fan):
                for cy in range(fan):
                    for cz in range(fan):
                        ci = (cx << (2 * l)) | (cy << l) | cz
                        if not (mask >> ci) & 1:
                            continue
                        child = lev.ptrs[node][ci]
                        nox = ox + (cx << s)
                        noy = oy + (cy << s)
                        noz = oz + (cz << s)
                        if lvl + 1 < k - 1:
                            yield from rec(lvl + 1, child, nox, noy, noz)
                        else:
                            yield (np.array([nox, noy, noz]),
                                   self._leaf_occ[child],
                                   self._leaf_act[child])

        yield from rec(0, 0, 0, 0, 0)


def tile_of(xyz) -> tuple[int, int, int]:
    """Tile coordinate of a signed world voxel (floor division)."""
    return tuple(int(np.floor(c / TILE)) for c in xyz)


def local_of(xyz) -> tuple[int, int, int]:
    return tuple(int(c) - int(np.floor(c / TILE)) * TILE for c in xyz)


class UnboundedRoot:
    """Infinite hashmap root over 256³ tiles (root.rs:28 semantics, signed
    coordinates included). Each tile stores voxels as ``{local: palette
    idx}``; :meth:`to_scene` turns the live tiles into an instanced
    VoxScene renderable by the standard pipeline."""

    def __init__(self):
        self.tiles: dict[tuple[int, int, int], dict] = {}

    def set_voxel(self, xyz, palette_idx: int | None) -> None:
        tk = tile_of(xyz)
        if palette_idx is None:
            t = self.tiles.get(tk)
            if t is not None:
                t.pop(local_of(xyz), None)
                if not t:
                    del self.tiles[tk]  # root hashmap frees empty children
            return
        self.tiles.setdefault(tk, {})[local_of(xyz)] = int(palette_idx)

    def get_voxel(self, xyz) -> int | None:
        t = self.tiles.get(tile_of(xyz))
        return None if t is None else t.get(local_of(xyz))

    def set_box(self, lo, hi, palette_idx: int) -> None:
        """Fill an axis-aligned box [lo, hi) — bulk helper for tests and
        world building."""
        for x in range(int(lo[0]), int(hi[0])):
            for y in range(int(lo[1]), int(hi[1])):
                for z in range(int(lo[2]), int(hi[2])):
                    self.set_voxel((x, y, z), palette_idx)

    @property
    def num_tiles(self) -> int:
        return len(self.tiles)

    def to_scene(self, palette: np.ndarray):
        """Build a VoxScene: one model + one translated instance per live
        tile. The scene graph IS the infinite root — the renderer's
        per-instance TLAS loop covers any world size while every kernel
        table stays a fixed ≤256³ shape."""
        from dust_tpu_torch.vox.collector import collect_material_indices
        from dust_tpu_torch.vox.geometry import build_geometry
        from dust_tpu_torch.vox.loader import VoxInstance, VoxScene
        from dust_tpu_torch.voxtree.tree import VoxTree

        geometries = {}
        instances = []
        for mid, (tk, vox) in enumerate(sorted(self.tiles.items())):
            if vox:
                coords = np.array(list(vox.keys()), dtype=np.int64)
                idx = np.array(list(vox.values()), dtype=np.uint8)
            else:
                coords = np.zeros((0, 3), np.int64)
                idx = np.zeros((0,), np.uint8)
            tree = VoxTree.from_voxels(coords)
            mats, block_ptr = collect_material_indices(coords, idx)
            geometries[mid] = build_geometry(
                tree, mats, block_ptr, palette, (TILE, TILE, TILE))
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = np.array(tk, np.float32) * TILE
            instances.append(VoxInstance(model_id=mid, transform=t))
        return VoxScene(geometries=geometries, palette=palette,
                        instances=instances)
