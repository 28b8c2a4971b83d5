"""``.vox`` scene loading: traversal, coordinate fix-up, tree build.

Reference: ``crates/vox/src/loader.rs``. The pipeline per model
(loader.rs:238-305):

1. swizzle voxel coords from MagicaVoxel's z-up to the engine's y-up:
   ``(x, y, z) -> (x, z, size.y - 1 - y)`` (loader.rs:249-254),
2. build the sparse tree (all voxels occupied+active),
3. compact palette indices per leaf (collector prefix sum),
4. flatten into device geometry (AABBs/GPUVoxNodes ≙ FlatTree arrays).

Scene-graph traversal (loader.rs:60-200): Transform nodes accumulate
translation (rotation is *not* composed down the chain, matching the
reference, which passes only the node's own rotation — see the commented
``// reverse?`` at loader.rs:117); Group nodes spawn an intermediate
transform; Shape nodes become instances. ``to_transform``
(loader.rs:176-204) converts translation/rotation/size into a y-up affine
with the model-center pivot and odd-size half-voxel offset.

The benchmark's frozen copy builds every model with the plain numpy
build (:meth:`VoxTree.from_voxels`, :func:`collect_material_indices`,
:func:`build_geometry`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.vox import parser as vp
from benchmark.reference.vox.collector import collect_material_indices
from benchmark.reference.vox.geometry import VoxGeometry, build_geometry
from benchmark.reference.voxtree.tree import VoxTree

__all__ = ["VoxScene", "VoxInstance", "load_vox_scene", "to_transform",
           "build_model_geometry"]

# Change of basis C: vox (x,y,z) -> engine (x, z, -y). det(C) = +1.
_C = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], dtype=np.float64)


@dataclasses.dataclass
class VoxInstance:
    model_id: int
    transform: np.ndarray  # (4,4) float32 model->world affine
    name: str | None = None


@dataclasses.dataclass
class VoxScene:
    geometries: dict[int, VoxGeometry]
    palette: np.ndarray  # (256,4) uint8
    instances: list[VoxInstance]


def _signed_perm_to_rot_scale(m: np.ndarray):
    """Split a signed permutation into (proper rotation, scale signs) with
    the scale applied before rotation: m = R @ diag(s)."""
    det = round(float(np.linalg.det(m)))
    s = np.array([det, 1.0, 1.0])
    r = m @ np.diag(s)  # det(r) = +1
    return r, s


def to_transform(translation, rotation, size) -> np.ndarray:
    """Reference ``to_transform`` (loader.rs:176-204) as a 4×4 affine.

    ``translation``/``rotation`` are in vox space; ``size`` is the model's
    file-order size (or (0,0,0) for group nodes). Returns the model→world
    affine for points in *engine-oriented model space* (i.e. after the
    voxel swizzle).
    """
    t = np.asarray(translation, dtype=np.float64)
    tv = np.array([t[0], t[2], -t[1]])  # translation.xzy, z *= -1

    r_vox, s_vox = _signed_perm_to_rot_scale(np.asarray(rotation, dtype=np.float64))
    rw = _C @ r_vox @ _C.T  # world-frame proper rotation
    sw = np.array([s_vox[0], s_vox[2], s_vox[1]])  # scale.xzy

    sx, sy, sz = int(size[0]), int(size[1]), int(size[2])
    offset = np.array(
        [
            0.0 if sx % 2 == 0 else 0.5,
            0.0 if sz % 2 == 0 else 0.5,
            0.0 if sy % 2 == 0 else -0.5,
        ]
    )
    offset = rw @ offset
    center = rw @ (np.array([sx, sz, sy], dtype=np.float64) / 2.0)
    trans = tv - center * sw + offset

    a = np.eye(4)
    a[:3, :3] = rw @ np.diag(sw)
    a[:3, 3] = trans
    return a


def build_model_geometry(coords: np.ndarray, palette_idx: np.ndarray,
                               palette: np.ndarray, size,
                               unit_size: float = 1.0) -> VoxGeometry:
    """One model's flat geometry from its voxel list (engine orientation;
    duplicates last write wins), in numpy: :meth:`VoxTree.from_voxels`,
    :func:`collect_material_indices` and :func:`build_geometry`."""
    materials, block_ptr = collect_material_indices(coords, palette_idx)
    return build_geometry(VoxTree.from_voxels(coords), materials, block_ptr,
                          palette, size, unit_size)


def load_vox_scene(data: bytes, unit_size: float = 1.0) -> VoxScene:
    """Parse + build a complete scene from ``.vox`` bytes."""
    f = vp.parse_vox(data)
    instances: list[tuple[int, np.ndarray, str | None]] = []

    if not f.scenes:
        # No scene graph: single model at identity (loader.rs:67-85).
        if f.models and len(f.models[0].voxels):
            instances.append((0, np.eye(4), None))
    else:
        def traverse(nid: int, parent: np.ndarray, translation, rotation, name):
            node = f.scenes[nid]
            if isinstance(node, vp.TransformNode):
                tr = tuple(
                    int(a) + int(b) for a, b in zip(translation, node.translation)
                )
                traverse(node.child, parent, tr, node.rotation, node.name or name)
            elif isinstance(node, vp.GroupNode):
                local = to_transform(translation, rotation, (0, 0, 0))
                world = parent @ local
                for child in node.children:
                    traverse(child, world, (0, 0, 0), np.eye(3, dtype=np.int32), None)
            elif isinstance(node, vp.ShapeNode):
                if len(node.model_ids) != 1:
                    raise NotImplementedError("multiple models per Shape node")
                mid = node.model_ids[0]
                model = f.models[mid]
                if len(model.voxels) == 0:
                    return
                local = to_transform(translation, rotation, model.size)
                instances.append((mid, parent @ local, name))

        traverse(f.root, np.eye(4), (0, 0, 0), np.eye(3, dtype=np.int32), None)

    geometries: dict[int, VoxGeometry] = {}
    for mid in sorted({i for i, _, _ in instances}):
        model = f.models[mid]
        if model.size[0] > 256 or model.size[1] > 256 or model.size[2] > 256:
            raise ValueError(".vox models must be <= 256^3")
        v = model.voxels.astype(np.int64)
        # Engine-orientation swizzle (loader.rs:249-254).
        coords = np.stack(
            [v[:, 0], v[:, 2], model.size[1] - 1 - v[:, 1]], axis=1
        )
        size = (model.size[0], model.size[2], model.size[1])
        geometries[mid] = build_model_geometry(coords, v[:, 3], f.palette,
                                               size, unit_size)

    return VoxScene(
        geometries=geometries,
        palette=f.palette,
        instances=[
            VoxInstance(model_id=m, transform=t.astype(np.float32), name=n)
            for m, t, n in instances
        ],
    )
