"""Dynamic scene edits and acceleration-structure refit (port of
:mod:`dust_tpu.render.edits`).

Reference: ``VoxGeometry::set`` (``crates/vox/src/geometry.rs:180-186``)
mutates tree voxels, and the BLAS/TLAS then rebuilds (BASELINE config #4:
"per-frame voxel leaf edits + tree/acceleration refit with GI
re-render"). Clears are supported as well as sets.

The editor owns the host-side voxel state per model: a dense 256^3 grid
of one-based palette indices (``uint16``, 0 = empty, 32 MiB a model) in
the native scene build's cell order, ``(block << 6) | bit`` with
``block = bx + by*64 + bz*64^2`` (``native/voxcore.cpp``), so a leaf's 64
cells are contiguous. Edits go to an overlay of pending voxels; a refit
scatters the overlay into the grid and reads a touched leaf's 64 cells,
so the host work on the caller's thread is O(edits), not O(model). A
refit takes the cheapest of three tiers:

* **leaf**: every pending edit lands in an existing leaf that stays
  non-empty, so the leaf set is unchanged and only the touched leaves'
  rows are scattered (:func:`~dust_tpu_torch.render.scene.apply_leaf_patch`);
* **splice**: the edited models' geometry is rebuilt on the host and
  their rows are replaced in the device scene
  (:func:`~dust_tpu_torch.render.scene.splice_model`);
* **rebuild**: an edit outgrew the scene's padding (leaf rows, mask
  chunks or material capacity), so the whole scene is built again, with
  the live instance transforms kept.

Dense GI: the cache keys rows by (instance, leaf_row, face) and carries
each row's albedo word. Pass the caller's ``FrameState`` to
:meth:`SceneEditor.refit` to keep it consistent: the leaf tier patches
the touched rows' albedo words, a splice refreshes every albedo word
(``gi_cache.refresh_dense_albedo``), and a rebuild, which changes the row
count, re-creates the cache empty. The hash frame's persistent working
set (``gi_ws``) is keyed the same way and follows the same rules.

Under a mesh (``SceneEditor(..., mesh=mesh)``, the ray-sharded frame of
:mod:`dust_tpu_torch.parallel`) every rank makes the same edits, so the
host build is the same on every rank; the dense table is row-sharded, so
each rank patches and refreshes only the rows it holds, and after a
splice or a rebuild the scene is broadcast again from rank 0.

Every device upload and scatter runs on the caller's thread; the staged
refit (:meth:`SceneEditor.refit_async`) runs only the host geometry
build on a worker thread.

Spans (``utils.profiling.trace_annotation``, a no-op with no profiler
running): ``dust.edit.set`` (a ``set_voxel`` / ``set_voxels`` call),
``dust.edit.refit`` (a ``refit``, ``refit_async`` or ``poll_refit``
call), and inside it on the caller's thread ``dust.edit.merge`` (the
overlay folded in), ``dust.edit.patch`` (the leaf tier's rows, scatters
and uploads), ``dust.edit.rebuild`` (a model's host geometry build; on
the worker thread for a staged refit) and ``dust.edit.splice`` (the
splice or scene rebuild, and the GI tables' re-keying).
:data:`REFITS` counts the refits that land, by tier; :data:`CELLS` the
grid cells the caller's thread writes in merges and reads in the leaf
tier.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np

from dust_tpu_torch import parallel
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.render.scene import (DeviceScene, apply_leaf_patch,
                                         build_device_scene, material_layout,
                                         patch_gi_albedo, splice_model)
from dust_tpu_torch.utils import color as colorlib
from dust_tpu_torch.utils.profiling import trace_annotation
from dust_tpu_torch.vox.geometry import pack_avg_albedo
from dust_tpu_torch.vox.loader import (VoxScene, build_model_geometry,
                                       build_model_geometry_plain)

__all__ = ["SceneEditor", "REFITS", "CELLS"]

# Refits landed, by tier (the value ``last_refit_mode`` takes): a no-op
# refit counts nothing, a staged one counts when ``poll_refit`` lands it.
REFITS = {"leaf": 0, "splice": 0, "rebuild": 0}
# Grid cells touched on the caller's thread: written by merges (one a
# pending edit) and read by the leaf tier (64 a touched leaf).
CELLS = {"merge": 0, "leaf": 0}

_GRID_CELLS = 1 << 24  # 256^3


def _span(name: str):
    """Run the decorated method inside the span ``name``."""
    def wrap(method):
        @functools.wraps(method)
        def spanned(*args, **kwargs):
            with trace_annotation(name):
                return method(*args, **kwargs)
        return spanned
    return wrap


def _pool_voxels(geo):
    """Every voxel of a model's flat pools, in (leaf row, bit) order: its
    leaf row, its bit in the leaf and its palette index (uint8)."""
    flat = geo.flat
    occ = flat.occupancy_u64()
    bits = ((occ[:, None] >> np.arange(64, dtype=np.uint64))
            & np.uint64(1)).astype(bool)                    # (L, 64)
    rank = np.cumsum(bits, axis=1) - 1                       # within-leaf k
    rows, bit = np.nonzero(bits)
    midx = geo.materials[flat.material_ptr[rows].astype(np.int64)
                         + rank[rows, bit]].astype(np.uint8)
    return rows, bit, midx


def geometry_voxels(geo):
    """A model's voxels decoded from its flat pools: coords (N, 3) int64
    in (leaf row, bit) order and palette indices (N,) uint8."""
    if not geo.flat.num_leaves:
        return np.zeros((0, 3), np.int64), np.zeros((0,), np.uint8)
    rows, bit, midx = _pool_voxels(geo)
    off = np.stack([bit >> 4, (bit >> 2) & 3, bit & 3], 1)
    return geo.flat.leaf_origin[rows].astype(np.int64) + off, midx


def _block(b: np.ndarray) -> np.ndarray:
    """The grid's block of leaf coordinates ``b`` (..., 3)."""
    return b[..., 0] | (b[..., 1] << 6) | (b[..., 2] << 12)


def _cells(coords: np.ndarray) -> np.ndarray:
    """The grid cells of voxel coordinates (N, 3) int64."""
    bit = ((coords[:, 0] & 3) << 4) | ((coords[:, 1] & 3) << 2) \
        | (coords[:, 2] & 3)
    return (_block(coords >> 2) << 6) | bit


def _model_grid(geo) -> np.ndarray:
    """A model's grid, filled from its flat pools."""
    grid = np.zeros(_GRID_CELLS, np.uint16)
    if geo.flat.num_leaves:
        rows, bit, midx = _pool_voxels(geo)
        block = _block(geo.flat.leaf_origin.astype(np.int64) >> 2)
        grid[(block[rows] << 6) | bit] = midx.astype(np.uint16) + 1
    return grid


def _grid_voxels(grid: np.ndarray):
    """The voxels of a grid in cell order: coords (N, 3) int32 and
    palette indices (N,) uint8 (the occupied blocks first, then their
    cells)."""
    leaves = grid.reshape(-1, 64)
    blocks = np.flatnonzero(leaves.any(axis=1)).astype(np.int32)
    vals = leaves[blocks]                                    # (L, 64)
    k, bit = np.nonzero(vals)
    block, bit = blocks[k], bit.astype(np.int32)
    coords = np.empty((len(k), 3), np.int32)
    coords[:, 0] = ((block & 63) << 2) | (bit >> 4)
    coords[:, 1] = (((block >> 6) & 63) << 2) | ((bit >> 2) & 3)
    coords[:, 2] = ((block >> 12) << 2) | (bit & 3)
    return coords, (vals[k, bit] - 1).astype(np.uint8)


class SceneEditor:
    """Holds editable host state for a loaded scene and refits the device
    scene after voxel mutations."""

    def __init__(self, vox_scene: VoxScene, device_scene: DeviceScene,
                 mesh: parallel.Mesh | None = None):
        self.vox_scene = vox_scene
        self.device = device_scene
        self.mesh = mesh
        self._model_ids = sorted(vox_scene.geometries)
        # Editable voxel state per model: the grid (module docstring),
        # filled from the flat pools, plus an overlay of pending edits.
        # Nothing writes a grid while a staged refit is in flight: its
        # worker decodes the grids of the models it rebuilds, and
        # refit / refit_async, the only callers of a merge, raise then.
        self._grid: dict[int, np.ndarray] = {}
        self._pending: dict[int, dict[tuple[int, int, int], int | None]] = {}
        for mid in self._model_ids:
            self._grid[mid] = _model_grid(vox_scene.geometries[mid])
            self._pending[mid] = {}
        self._dirty: set[int] = set()
        # Models whose merged edits the device does not have yet (a
        # rebuild in flight, or one that failed): only a splice or a
        # rebuild may refit them.
        self._stale: set[int] = set()
        # Material-pool capacities pinned at build time (a splice keeps
        # every other model's segment in place).
        geos = [vox_scene.geometries[m] for m in self._model_ids]
        _, self._mat_cap = material_layout(geos)
        # How the last refit was applied: "leaf", "splice" or "rebuild".
        self.last_refit_mode: str | None = None
        # The staged refit (refit_async / poll_refit).
        self._worker: threading.Thread | None = None
        self._worker_out: dict = {}
        self._worker_error: Exception | None = None
        self._worker_dirty: list = []

    @_span("dust.edit.set")
    def set_voxel(self, model_id: int, coords, palette_idx: int | None) -> None:
        """Set (palette index) or clear (None) one voxel."""
        key = tuple(int(c) for c in coords)
        if not all(0 <= c < 256 for c in key):
            raise IndexError(f"voxel coord out of range [0,256): {key}")
        self._pending[model_id][key] = (
            None if palette_idx is None else int(palette_idx))
        self._dirty.add(model_id)

    @_span("dust.edit.set")
    def set_voxels(self, model_id: int, coords: np.ndarray, palette_idx) -> None:
        """Bulk set; ``palette_idx`` scalar or per voxel; None clears."""
        coords = np.asarray(coords, dtype=np.int64)
        if len(coords) and (coords.min() < 0 or coords.max() > 255):
            raise IndexError("voxel coords out of range [0,256)")
        pend = self._pending[model_id]
        if palette_idx is None:
            for c in coords:
                pend[tuple(int(v) for v in c)] = None
        else:
            pis = np.broadcast_to(np.asarray(palette_idx), (len(coords),))
            for c, pi in zip(coords, pis):
                pend[tuple(int(v) for v in c)] = int(pi)
        self._dirty.add(model_id)

    def voxels(self, model_id: int):
        """The model's voxels as the grid holds them (pending edits not
        included), in cell order: coords (N, 3) int64 and palette indices
        (N,) uint8. Walks the whole grid: for tests and tools."""
        coords, idx = _grid_voxels(self._grid[model_id])
        return coords.astype(np.int64), idx

    @_span("dust.edit.merge")
    def _merge_pending(self, mid: int) -> None:
        """Scatter the overlay into the model's grid."""
        pend = self._pending[mid]
        if not pend:
            return
        cells = _cells(np.array(list(pend), np.int64))
        self._grid[mid][cells] = np.array(
            [0 if v is None else v + 1 for v in pend.values()], np.uint16)
        CELLS["merge"] += len(cells)
        pend.clear()

    @_span("dust.edit.refit")
    def refit(self, frame_state=None):
        """Apply the pending edits to the device scene.

        Returns the new ``DeviceScene``, or ``(device, new_state)`` when
        the caller's ``FrameState`` is passed (see the module docstring for
        what happens to its GI tables)."""
        if self._worker is not None:
            raise RuntimeError("a staged refit is in flight; poll_refit()")
        fast = self._try_leaf_patch(frame_state)
        if fast is not None:
            return fast
        if frame_state is None:
            return self._refit()
        rows_before = gilib.dense_rows(self.device)
        device = self._refit()
        return device, self._refresh_state(frame_state, device, rows_before)

    def _gi_rows(self, rows: int) -> slice:
        """The rows of a dense table of ``rows`` that this process holds:
        its chunk under a mesh, else all."""
        if self.mesh is None:
            return slice(0, rows)
        return slice(*parallel.ray_sharding(self.mesh, rows))

    @_span("dust.edit.splice")
    def _refresh_state(self, frame_state, device, rows_before: int):
        """Re-key a FrameState's dense GI tables after a splice or
        rebuild (from a scene of ``rows_before`` dense rows)."""
        rows = gilib.dense_rows(device)

        def refreshed(cache, held):
            if rows_before == rows:
                return gilib.refresh_dense_albedo(cache, device, held)
            # The row count changed.
            return gilib.DenseGICache(
                table=gilib.make_dense_gi_cache(device).table[held])

        if isinstance(frame_state.gi, gilib.DenseGICache):
            frame_state = dataclasses.replace(
                frame_state, gi=refreshed(frame_state.gi, self._gi_rows(rows)))
        if frame_state.gi_ws is not None:
            frame_state = dataclasses.replace(
                frame_state, gi_ws=refreshed(frame_state.gi_ws,
                                             slice(0, rows)))
        return frame_state

    @_span("dust.edit.refit")
    def refit_async(self, frame_state=None):
        """Non-blocking refit: the reference's async BLAS batch build
        (``crates/render/src/accel_struct/blas.rs:125``).

        The leaf tier applies at once and returns what :meth:`refit`
        returns. Otherwise the host geometry rebuild is staged on a worker
        thread, the caller keeps rendering from the old scene, and this
        returns None; call :meth:`poll_refit` once per frame to splice and
        swap when the rebuild has landed. Edits made while a rebuild is in
        flight stay pending for the next refit."""
        if self._worker is not None:
            raise RuntimeError("a staged refit is already in flight")
        fast = self._try_leaf_patch(frame_state)
        if fast is not None:
            return fast
        if not self._dirty:
            return (self.device, frame_state) if frame_state is not None \
                else self.device
        # Merge on the caller's thread; the worker decodes the merged
        # grids, which nothing writes until the next merge (one refit is
        # in flight at a time).
        dirty = sorted(self._dirty)
        for mid in dirty:
            self._merge_pending(mid)
        self._stale.update(dirty)
        self._dirty.clear()
        self._worker_out = {}
        self._worker_error = None
        self._worker_dirty = dirty

        def work():
            try:
                for mid in dirty:
                    self._worker_out[mid] = self._rebuild_geometry(mid)
            except Exception as e:  # re-raised by poll_refit
                self._worker_error = e

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()
        return None

    @property
    def refit_in_flight(self) -> bool:
        return self._worker is not None

    @_span("dust.edit.refit")
    def poll_refit(self, frame_state=None, block=False):
        """None while a staged rebuild is running; what :meth:`refit`
        returns once it has landed (the splice itself, uploads and
        scatters, runs on the calling thread, at the caller's frame
        boundary). An exception raised by the rebuild is raised here."""
        if self._worker is None:
            return None
        if not block and self._worker.is_alive():
            return None
        self._worker.join()
        self._worker = None
        error, self._worker_error = self._worker_error, None
        if error is not None:
            # The edits are merged but not on the device: the models stay
            # dirty and stale, so the next refit rebuilds them.
            self._dirty.update(self._worker_dirty)
            self._worker_dirty = []
            self._worker_out = {}
            raise error
        for mid in self._worker_dirty:
            self.vox_scene.geometries[mid] = self._worker_out[mid]
        rows_before = gilib.dense_rows(self.device)
        device = self._apply_splice(self._worker_dirty)
        self._worker_dirty = []
        self._worker_out = {}
        if frame_state is None:
            return device
        return device, self._refresh_state(frame_state, device, rows_before)

    def _try_leaf_patch(self, frame_state=None):
        """The leaf tier (BASELINE config #4's per-frame edit): when every
        pending edit lands in an existing leaf that stays non-empty, the
        leaf set, and with it the hierarchy row order, the HDDA L1/L2
        tables and the cell grid, is unchanged, so the refit scatters the
        touched leaves' mask, albedo and voxel rows. Host work is
        O(edited leaves); every index comes from host state, so nothing is
        read back from the device.

        Returns what :meth:`refit` returns, or None when the edits are not
        eligible (the caller goes on to the splice tier)."""
        if not self._dirty or self._stale:
            return None

        # ---- eligibility and each leaf's new content (nothing changed yet)
        leaves = []  # (slot, row, {bit: palette_idx})
        for mid in sorted(self._dirty):
            pend = self._pending[mid]
            if not pend:
                return None  # dirty without an overlay: unknown edit source
            leaf_grid = self.vox_scene.geometries[mid].flat.leaf_grid
            grid = self._grid[mid]
            slot = self._model_ids.index(mid)
            by_leaf: dict[tuple, dict] = {}
            for (x, y, z), pi in pend.items():
                by_leaf.setdefault((x >> 2, y >> 2, z >> 2), {})[
                    ((x & 3) << 4) | ((y & 3) << 2) | (z & 3)] = pi
            for (bx, by, bz), edits in by_leaf.items():
                row = int(leaf_grid[bx, by, bz])
                if row < 0:
                    return None  # a new leaf changes the row order
                block = bx | (by << 6) | (bz << 12)
                cells = grid[block << 6:(block + 1) << 6]
                CELLS["leaf"] += 64
                content = {int(b): int(cells[b]) - 1
                           for b in np.flatnonzero(cells)}
                for bit, pi in edits.items():
                    if pi is None:
                        content.pop(bit, None)
                    else:
                        content[bit] = pi
                if not content:
                    return None  # the leaf dies: the block set changes
                leaves.append((slot, row, content))
        return self._patch_leaves(leaves, frame_state)

    @_span("dust.edit.patch")
    def _patch_leaves(self, leaves, frame_state):
        """The leaf tier once every edit is eligible: each touched leaf's
        ``(slot, row, {bit: palette_idx})`` scattered into the
        device scene and, given a ``FrameState``, into its GI albedo
        rows. Returns what :meth:`refit` returns."""
        palette = self.vox_scene.palette  # (256, 4) uint8
        inst_model = self.device.inst_model

        # ---- the K patch rows -----------------------------------------
        K = len(leaves)
        models = np.zeros(K, np.int32)
        rows = np.zeros(K, np.int32)
        mlo = np.zeros(K, np.uint32)
        mhi = np.zeros(K, np.uint32)
        albs = np.zeros(K, np.uint32)
        vox = np.zeros((K, 4, 16), np.int32)
        for k, (slot, row, content) in enumerate(leaves):
            models[k], rows[k] = slot, row
            bits = np.fromiter(sorted(content), np.int64)
            pis = np.fromiter((content[b] for b in sorted(content)), np.int64)
            m64 = np.bitwise_or.reduce(np.uint64(1) << bits.astype(np.uint64))
            mlo[k] = np.uint32(m64 & np.uint64(0xFFFFFFFF))
            mhi[k] = np.uint32(m64 >> np.uint64(32))
            rgba8 = palette[pis].astype(np.uint32)
            words = (rgba8[:, 0] | (rgba8[:, 1] << 8) | (rgba8[:, 2] << 16)
                     | (pis.astype(np.uint32) << 24))
            vox[k].reshape(64)[bits] = words.view(np.int32)
            # The leaf's average albedo, as build_geometry_from_flat
            # computes it.
            avg = palette[pis].astype(np.float64).sum(0) / (len(pis) * 255.0)
            avg[:3] = colorlib.srgb_oetf_np(avg[:3])
            albs[k] = pack_avg_albedo(avg[None])[0]

        # ---- dense-GI albedo rows of the touched leaves ----------------
        gi = frame_state.gi if frame_state is not None else None
        dense = isinstance(gi, gilib.DenseGICache)
        ws = frame_state.gi_ws if frame_state is not None else None
        gi_rows = gi_alb = None
        if dense or ws is not None:
            cbases, ccaps, _ = gilib.cell_layout(self.device)
            Cd = gilib.dense_cells(self.device)
            per_model = {m: [i for i, im in enumerate(inst_model) if im == m]
                         for m in set(models.tolist())}
            width = max(len(v) for v in per_model.values()) * 6
            gi_rows = np.full((K, width), -1, np.int32)
            gi_alb = np.zeros((K, width), np.int32)
            for k in range(K):
                # Rows past an instance's pinned cell cap have no cache
                # cell (dense_index sends them to the padding tail).
                cells = [f * Cd + cbases[i] + int(rows[k])
                         for i in per_model[int(models[k])]
                         if int(rows[k]) < ccaps[i] for f in range(6)]
                gi_rows[k, :len(cells)] = cells
                gi_alb[k, :len(cells)] = albs[k:k + 1].view(np.int32)[0]

        device = apply_leaf_patch(self.device, models, rows, mlo, mhi, albs,
                                  vox)
        self.device = device
        for mid in sorted(self._dirty):
            self._merge_pending(mid)
        self._dirty.clear()
        self.last_refit_mode = "leaf"
        REFITS["leaf"] += 1
        if frame_state is None:
            return device
        # The hash frame's working set carries the same albedo words as
        # the dense cache (the hash table itself is keyed by world cells
        # and needs no refresh).
        if dense:
            # Under a mesh the table holds the rows of this rank's chunk.
            held = self._gi_rows(gilib.dense_rows(device))
            mine = (gi_rows >= held.start) & (gi_rows < held.stop)
            frame_state = dataclasses.replace(
                frame_state, gi=gilib.DenseGICache(table=patch_gi_albedo(
                    gi.table, np.where(mine, gi_rows - held.start, -1),
                    gi_alb)))
        if ws is not None:
            frame_state = dataclasses.replace(
                frame_state, gi_ws=gilib.DenseGICache(
                    table=patch_gi_albedo(ws.table, gi_rows, gi_alb)))
        return device, frame_state

    @_span("dust.edit.rebuild")
    def _rebuild_geometry(self, mid: int):
        """Host geometry rebuild of one model from its (merged) grid: the
        costly part of the splice tier, safe to run off the render thread
        (it only reads the grid, which nothing writes while a staged
        refit is in flight; the native build releases the interpreter
        lock). The build does not depend on the order of its voxels."""
        coords, idx = _grid_voxels(self._grid[mid])
        geo_old = self.vox_scene.geometries[mid]
        args = (coords, idx, self.vox_scene.palette, geo_old.size,
                geo_old.unit_size)
        if len(coords):
            return build_model_geometry(*args)
        # A model emptied by its edits: the reference builds it with the
        # tree, not the native pass (a rule about the data, not a fallback).
        return build_model_geometry_plain(*args)

    def _refit(self) -> DeviceScene:
        if not self._dirty:
            return self.device
        dirty = sorted(self._dirty)
        for mid in dirty:
            self._merge_pending(mid)
            self._stale.add(mid)
            self.vox_scene.geometries[mid] = self._rebuild_geometry(mid)
        self._dirty.clear()
        return self._apply_splice(dirty)

    @_span("dust.edit.splice")
    def _apply_splice(self, dirty) -> DeviceScene:
        """Splice the (rebuilt) dirty models' rows into the device scene,
        or rebuild the whole scene when one no longer fits its padding."""
        self._stale.difference_update(dirty)
        device = self.device
        for mid in dirty:
            slot = self._model_ids.index(mid)
            device = splice_model(device, slot, self.vox_scene.geometries[mid],
                                  self._mat_cap[slot], self.vox_scene.palette)
            if device is None:
                break
        if device is not None:
            self.last_refit_mode = "splice"
            self.device = self._replicated(device)
            REFITS["splice"] += 1
            return self.device

        self.last_refit_mode = "rebuild"
        new = build_device_scene(self.vox_scene, self.device.device)
        new = dataclasses.replace(
            new, obj_to_world=self.device.obj_to_world,
            world_to_obj=self.device.world_to_obj,
            prev_obj_to_world=self.device.prev_obj_to_world)
        # Re-pin the material layout to the rebuilt pool.
        geos = [self.vox_scene.geometries[m] for m in self._model_ids]
        _, self._mat_cap = material_layout(geos)
        self.device = self._replicated(new)
        REFITS["rebuild"] += 1
        return self.device

    def _replicated(self, device: DeviceScene) -> DeviceScene:
        """Under a mesh, the scene broadcast again from rank 0."""
        if self.mesh is None:
            return device
        return parallel.replicate_scene(device, self.mesh)
