"""The sparse voxel tree: host-side pooled build + flat device arrays.

Reference: ``crates/vdb`` with the ``hierarchy!(4,2,2)`` instantiation used
by the voxel importer (``crates/vox/src/lib.rs:19``):

* root  — 16×16×16 children, each covering 16³ voxels (dense directory here;
  the reference's infinite ``RootNode`` hashmap is only needed for unbounded
  scenes, and every ``.vox`` model is ≤256³, ``crates/vox/src/loader.rs:4-6``),
* internal — 4×4×4 children, each covering 4³ voxels
  (``crates/vdb/src/node/internal.rs``),
* leaf  — 4×4×4 voxels: a 64-bit ``occupancy`` mask + 64-bit ``active``
  (surface) mask + ``material_ptr`` (``crates/vdb/src/node/leaf.rs:15-24``).

Voxel tri-state semantics (leaf.rs:83-109): a voxel is ``None`` when its
occupancy bit is clear, else ``bool(active bit)``.

Bit index within a leaf = ``(x<<4)|(y<<2)|z`` — identical to the GLSL DDA's
``encode_index`` (``assets/shaders/primary/hit.rint:30-32``), so the flat
masks feed the traversal kernel without any remapping.

The flat form (:class:`FlatTree`) is the TPU acceleration structure: the
dense 64³ ``leaf_grid`` (block coord → leaf row) replaces the Vulkan
BLAS/TLAS; leaf payloads live in row-major pooled arrays.

The port's copy of :mod:`dust_tpu.voxtree.tree`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.voxtree.pool import Pool

__all__ = ["VoxTree", "FlatTree"]

_NIL = 0xFFFFFFFF

# hierarchy!(4,2,2): root fanout 16 (log2=4), internal fanout 4 (log2=2),
# leaf extent 4 (log2=2). Total extent 256.
ROOT_LOG2 = 4
INT_LOG2 = 2
LEAF_LOG2 = 2
EXTENT = 1 << (ROOT_LOG2 + INT_LOG2 + LEAF_LOG2)  # 256
BLOCKS_PER_AXIS = EXTENT >> LEAF_LOG2  # 64

LEAF_DTYPE = np.dtype(
    [("occupancy", np.uint64), ("active", np.uint64), ("material_ptr", np.uint32)]
)
# internal: child mask (64 bits) + 64 child pointers (u32 pool index, NIL=air)
INTERNAL_DTYPE = np.dtype([("child_mask", np.uint64), ("child_ptrs", np.uint32, (64,))])


def hierarchy_key(b: np.ndarray) -> np.ndarray:
    """Canonical flat-row sort key for block coords ``b`` (N,3): L1 cell
    index (x-major) * 64 + local block index within the cell — the
    reference's tree iteration order and the order the Pallas rank table
    assumes."""
    cell = b >> 2
    local = ((b[:, 0] & 3) << 4) | ((b[:, 1] & 3) << 2) | (b[:, 2] & 3)
    cl = (cell[:, 0].astype(np.int64) * 16 + cell[:, 1]) * 16 + cell[:, 2]
    return (cl << 6) | local


def leaf_bit_index(x, y, z):
    """Bit position of voxel (x,y,z) within its 4³ leaf: (x<<4)|(y<<2)|z."""
    return ((x & 3) << 4) | ((y & 3) << 2) | (z & 3)


def _root_index(v):
    return ((v[0] >> 4) << 8) | ((v[1] >> 4) << 4) | (v[2] >> 4)


def _internal_index(v):
    return (((v[0] >> 2) & 3) << 4) | (((v[1] >> 2) & 3) << 2) | ((v[2] >> 2) & 3)


class VoxTree:
    """Host-side pooled sparse voxel tree, extent 256³.

    Mirrors ``Tree<hierarchy!(4,2,2)>`` (``crates/vdb/src/tree.rs``): one
    :class:`Pool` per level plus a dense root directory. Point ops
    (:meth:`set_value`/:meth:`get_value`) match the vdb doc-test semantics;
    :meth:`from_voxels` is the vectorised bulk-build fast path used by the
    ``.vox`` importer (the reference's per-voxel hot loop,
    ``crates/vox/src/loader.rs:251-263``).
    """

    def __init__(self):
        self.leaf_pool = Pool(LEAF_DTYPE)
        self.internal_pool = Pool(INTERNAL_DTYPE)
        # Dense 16³ root directory of internal-pool pointers.
        self.root = np.full(4096, _NIL, dtype=np.uint32)

    # ------------------------------------------------------------------
    # Point access
    # ------------------------------------------------------------------
    def set_value(self, coords, value: bool | None) -> None:
        """Set the tri-state voxel at ``coords``.

        ``None`` clears occupancy; ``True``/``False`` sets occupancy with the
        given active flag (leaf.rs:96-109). Like the reference (whose
        ``InternalNode::clear`` is unimplemented, internal.rs:126), clearing
        never frees nodes upward.
        """
        x, y, z = (int(c) for c in coords)
        self._check_bounds(x, y, z)
        ri = _root_index((x, y, z))
        int_ptr = int(self.root[ri])
        if int_ptr == _NIL:
            if value is None:
                return
            int_ptr = self.internal_pool.alloc()
            self.internal_pool.data[int_ptr]["child_ptrs"][:] = _NIL
            self.root[ri] = int_ptr

        node = self.internal_pool.data[int_ptr]
        ii = _internal_index((x, y, z))
        leaf_ptr = int(node["child_ptrs"][ii])
        if leaf_ptr == _NIL:
            if value is None:
                return
            leaf_ptr = self.leaf_pool.alloc()
            node["child_ptrs"][ii] = leaf_ptr
            node["child_mask"] = np.uint64(int(node["child_mask"]) | (1 << ii))

        leaf = self.leaf_pool.data[leaf_ptr]
        bit = leaf_bit_index(x, y, z)
        occ = int(leaf["occupancy"])
        act = int(leaf["active"])
        if value is None:
            occ &= ~(1 << bit)
        else:
            occ |= 1 << bit
            act = (act | (1 << bit)) if value else (act & ~(1 << bit))
        leaf["occupancy"] = np.uint64(occ)
        leaf["active"] = np.uint64(act)

    def get_value(self, coords) -> bool | None:
        x, y, z = (int(c) for c in coords)
        self._check_bounds(x, y, z)
        int_ptr = int(self.root[_root_index((x, y, z))])
        if int_ptr == _NIL:
            return None
        node = self.internal_pool.data[int_ptr]
        leaf_ptr = int(node["child_ptrs"][_internal_index((x, y, z))])
        if leaf_ptr == _NIL:
            return None
        leaf = self.leaf_pool.data[leaf_ptr]
        bit = leaf_bit_index(x, y, z)
        if not (int(leaf["occupancy"]) >> bit) & 1:
            return None
        return bool((int(leaf["active"]) >> bit) & 1)

    # ------------------------------------------------------------------
    # Bulk build
    # ------------------------------------------------------------------
    @classmethod
    def from_voxels(cls, coords: np.ndarray, active: np.ndarray | None = None) -> "VoxTree":
        """Vectorised build from an (N,3) integer coordinate array.

        Equivalent to calling ``set_value(c, True)`` for every row (the
        importer marks every stored voxel occupied+active,
        loader.rs:260). ``active`` optionally gives per-voxel surface flags.
        """
        tree = cls()
        coords = np.asarray(coords, dtype=np.int64)
        if coords.size == 0:
            return tree
        if coords.min() < 0 or coords.max() >= EXTENT:
            raise ValueError("voxel coordinates out of the 256^3 extent")
        x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
        if active is None:
            act_bits = np.ones(len(coords), dtype=bool)
        else:
            act_bits = np.asarray(active, dtype=bool)

        # Hierarchy sort key: (root index << 6) | internal index. Allocating
        # leaves in this order makes pool order == tree iteration order.
        root_idx = ((x >> 4) << 8) | ((y >> 4) << 4) | (z >> 4)
        int_idx = (((x >> 2) & 3) << 4) | (((y >> 2) & 3) << 2) | ((z >> 2) & 3)
        hkey = (root_idx.astype(np.int64) << 6) | int_idx
        bit = leaf_bit_index(x, y, z)

        uniq_keys, inv = np.unique(hkey, return_inverse=True)
        n_leaves = len(uniq_keys)
        base = tree.leaf_pool.alloc_contiguous(n_leaves)
        assert base == 0

        occ = np.zeros(n_leaves, dtype=np.uint64)
        actm = np.zeros(n_leaves, dtype=np.uint64)
        np.bitwise_or.at(occ, inv, np.uint64(1) << bit.astype(np.uint64))
        np.bitwise_or.at(
            actm, inv, np.where(act_bits, np.uint64(1) << bit.astype(np.uint64), np.uint64(0))
        )
        tree.leaf_pool.data["occupancy"][:n_leaves] = occ
        tree.leaf_pool.data["active"][:n_leaves] = actm

        # Internal nodes: unique root cells among the unique leaves.
        leaf_root = (uniq_keys >> 6).astype(np.int64)
        leaf_int = (uniq_keys & 63).astype(np.int64)
        uniq_roots, root_inv = np.unique(leaf_root, return_inverse=True)
        n_internal = len(uniq_roots)
        ibase = tree.internal_pool.alloc_contiguous(n_internal)
        assert ibase == 0
        idata = tree.internal_pool.data
        idata["child_ptrs"][:n_internal] = _NIL
        mask = np.zeros(n_internal, dtype=np.uint64)
        np.bitwise_or.at(mask, root_inv, np.uint64(1) << leaf_int.astype(np.uint64))
        idata["child_mask"][:n_internal] = mask
        idata["child_ptrs"][root_inv, leaf_int] = np.arange(n_leaves, dtype=np.uint32)
        tree.root[uniq_roots] = np.arange(n_internal, dtype=np.uint32)
        return tree

    # ------------------------------------------------------------------
    # Iteration / flatten
    # ------------------------------------------------------------------
    def iter_leaf(self):
        """Yield ``(origin_xyz, leaf_row)`` in tree order: root cells in
        x-major index order, then children in x-major bit order — the same
        order as the reference's nested iterators (tree.rs doc test at
        91-103)."""
        for ri in np.flatnonzero(self.root != _NIL):
            rx, ry, rz = (ri >> 8) & 15, (ri >> 4) & 15, ri & 15
            node = self.internal_pool.data[int(self.root[ri])]
            cmask = int(node["child_mask"])
            ptrs = node["child_ptrs"]
            m = cmask
            while m:
                low = m & -m
                ii = low.bit_length() - 1
                m ^= low
                ix, iy, iz = (ii >> 4) & 3, (ii >> 2) & 3, ii & 3
                origin = (
                    (rx << 4) | (ix << 2),
                    (ry << 4) | (iy << 2),
                    (rz << 4) | (iz << 2),
                )
                yield origin, self.leaf_pool.data[int(ptrs[ii])]

    def leaf_ptr_of_block(self, bx: int, by: int, bz: int) -> int | None:
        """Leaf-pool index for block (4³ region) coords, or None."""
        v = (bx << 2, by << 2, bz << 2)
        int_ptr = int(self.root[_root_index(v)])
        if int_ptr == _NIL:
            return None
        ptr = int(self.internal_pool.data[int_ptr]["child_ptrs"][_internal_index(v)])
        return None if ptr == _NIL else ptr

    def set_material_ptrs(self, block_lin_to_ptr: np.ndarray) -> None:
        """Assign ``material_ptr`` per leaf from a dense 64³ array indexed by
        the collector's linear block order ``bx + by*64 + bz*64*64``
        (reference loader.rs:265-273)."""
        for (ox, oy, oz), leaf in self.iter_leaf():
            lin = (ox >> 2) + (oy >> 2) * 64 + (oz >> 2) * 64 * 64
            leaf["material_ptr"] = np.uint32(block_lin_to_ptr[lin])

    def flatten(self) -> "FlatTree":
        """Flatten into device-ready arrays + dense 64³ block→row grid.

        Row order is the **hierarchy order** — 16³ L1 cell (x-major),
        then 4³ block within the cell — i.e. exactly the reference's tree
        iteration order (root index, then internal index). The Pallas
        traversal derives a leaf row from a popcount prefix over a
        cell-grouped block bitmap, which requires exactly this ordering;
        any consistent order is equivalent for shading."""
        origins, occ, act, mat = [], [], [], []
        for origin, leaf in self.iter_leaf():
            o = int(leaf["occupancy"])
            if o == 0:
                continue  # fully-cleared leaves drop out of the flat form
            origins.append(origin)
            occ.append(o)
            act.append(int(leaf["active"]))
            mat.append(int(leaf["material_ptr"]))
        n = len(origins)
        origins = np.asarray(origins, dtype=np.int32).reshape(n, 3)
        occ = np.asarray(occ, dtype=np.uint64)
        act = np.asarray(act, dtype=np.uint64)
        mat = np.asarray(mat, dtype=np.uint32)
        if n:
            order = np.argsort(hierarchy_key(origins >> LEAF_LOG2))
            origins, occ, act, mat = origins[order], occ[order], act[order], mat[order]

        grid = np.full((BLOCKS_PER_AXIS,) * 3, -1, dtype=np.int32)
        if n:
            b = origins >> LEAF_LOG2
            grid[b[:, 0], b[:, 1], b[:, 2]] = np.arange(n, dtype=np.int32)
        return FlatTree(
            leaf_origin=origins,
            mask_lo=(occ & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            mask_hi=(occ >> np.uint64(32)).astype(np.uint32),
            active_lo=(act & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            active_hi=(act >> np.uint64(32)).astype(np.uint32),
            material_ptr=mat,
            leaf_grid=grid,
        )

    @staticmethod
    def _check_bounds(x, y, z):
        if not (0 <= x < EXTENT and 0 <= y < EXTENT and 0 <= z < EXTENT):
            raise IndexError(f"voxel ({x},{y},{z}) outside {EXTENT}^3 tree")


@dataclasses.dataclass
class FlatTree:
    """Flattened tree: the TPU-side scene representation of one model.

    ``leaf_grid`` (dense 64³ int32, −1 = empty) is the traversal
    acceleration structure — the role Vulkan BLAS played for leaf AABBs in
    the reference (``crates/render/src/accel_struct/blas.rs``). Leaf masks
    are split into lo/hi u32 words because TPUs have no 64-bit integers —
    the same split the GLSL takes when ``SHADER_INT_64`` is off
    (``primary/hit.rint:13-16``).
    """

    leaf_origin: np.ndarray  # (L,3) int32, voxel coords (multiples of 4)
    mask_lo: np.ndarray  # (L,) uint32
    mask_hi: np.ndarray  # (L,) uint32
    active_lo: np.ndarray  # (L,) uint32
    active_hi: np.ndarray  # (L,) uint32
    material_ptr: np.ndarray  # (L,) uint32
    leaf_grid: np.ndarray  # (64,64,64) int32 → leaf row or -1

    @classmethod
    def from_dense_pools(cls, occupancy: np.ndarray, material_ptr: np.ndarray,
                         active: np.ndarray | None = None) -> "FlatTree":
        """Build directly from dense 64³ per-block arrays (the native
        voxcore fast path): ``occupancy`` u64 masks, ``material_ptr`` the
        collector prefix sums. Rows come out block-linear ordered, same
        as :meth:`VoxTree.flatten`."""
        occupancy = occupancy.reshape(-1)
        nz = np.flatnonzero(occupancy)
        # Dense pools use the collector's linear order bx + by*64 + bz*64²
        # (collector.rs:33-40); decode, then sort rows into the canonical
        # x-major block-linear order.
        bx = nz & 63
        by = (nz >> 6) & 63
        bz = nz >> 12
        order = np.argsort(hierarchy_key(np.stack([bx, by, bz], axis=1)))
        nz = nz[order]
        bx, by, bz = bx[order], by[order], bz[order]
        occ = occupancy[nz]
        act = occ if active is None else active.reshape(-1)[nz]
        origins = (np.stack([bx, by, bz], axis=1) << LEAF_LOG2).astype(np.int32)
        grid = np.full((BLOCKS_PER_AXIS,) * 3, -1, dtype=np.int32)
        grid[bx, by, bz] = np.arange(len(nz), dtype=np.int32)
        return cls(
            leaf_origin=origins,
            mask_lo=(occ & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            mask_hi=(occ >> np.uint64(32)).astype(np.uint32),
            active_lo=(act & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            active_hi=(act >> np.uint64(32)).astype(np.uint32),
            material_ptr=material_ptr.reshape(-1)[nz].astype(np.uint32),
            leaf_grid=grid,
        )

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_origin)

    def occupancy_u64(self) -> np.ndarray:
        return self.mask_lo.astype(np.uint64) | (self.mask_hi.astype(np.uint64) << np.uint64(32))
