"""What a run renders, made by the benchmark from the configuration, the
traffic mix and the seed: the scene's ``.vox`` bytes, the blue-noise
tables, the camera path, the animated instance's transforms and the edit
stream. The port receives only these.

Frozen here, so that a later change to the port cannot move the
yardstick: the camera poses and orbit of the port's bench (``EYE``,
``TARGET``, 0.05 rad a frame about the target), the teapot's bob and
spin, and the edit steps of its edit bench (a palette change of an
existing voxel; a voxel placed in a leaf the model lacks).
"""

from __future__ import annotations

import dataclasses
import math
import pathlib

import numpy as np

from benchmark.reference.vox import parser as vp
from benchmark.reference.vox import procgen

# The port's bench camera: every pose looks at the origin.
EYE = (122.0, 300.61, 54.45)
TARGET = (0.0, 0.0, 0.0)
# Procedural models by name (vox orientation, z up).
MODELS = {"castle": procgen.make_castle_vox, "teapot": procgen.make_teapot_vox}
# The teapot's animation runs at 30 Hz (``teapot_motion``'s rate).
ANIM_RATE = 1.0 / 30.0
# Seeds draw the teapot's phase from one period of its spin.
ANIM_PERIOD_FRAMES = int(2.0 * math.pi / ANIM_RATE)
# And the frame index's offset into the 64-layer blue noise.
NOISE_LAYERS = 64


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of ``seed`` (any integer)."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


def scene_bytes(config: dict) -> bytes:
    """The configuration's scene as one ``.vox`` file: each model of
    ``scene.models`` (procedural, by name) under its own transform node,
    with its ``translation`` in vox space."""
    models, scenes = [], {0: vp.TransformNode(child=1, name="root")}
    entries = config["scene"]["models"]
    scenes[1] = vp.GroupNode(children=[2 + 2 * k for k in range(len(entries))])
    for k, entry in enumerate(entries):
        grid = MODELS[entry["procgen"]]()
        x, y, z = np.nonzero(grid)
        voxels = np.stack([x, y, z, grid[x, y, z]], axis=1).astype(np.uint8)
        models.append(vp.VoxModel(size=grid.shape, voxels=voxels))
        scenes[2 + 2 * k] = vp.TransformNode(
            child=3 + 2 * k, name=entry["name"],
            translation=tuple(entry.get("translation", (0, 0, 0))))
        scenes[3 + 2 * k] = vp.ShapeNode(model_ids=[k])
    return vp.write_vox(vp.VoxFile(models=models, palette=procgen._palette(),
                                   scenes=scenes))


def model_voxels(config: dict, name: str) -> tuple[np.ndarray, np.ndarray]:
    """One model's voxels in engine orientation (the loader's swizzle):
    coords (N, 3) int64 and palette indices (N,) int64."""
    entry = next(e for e in config["scene"]["models"] if e["name"] == name)
    grid = MODELS[entry["procgen"]]()
    x, y, z = np.nonzero(grid)
    coords = np.stack([x, z, grid.shape[1] - 1 - y], axis=1).astype(np.int64)
    return coords, grid[x, y, z].astype(np.int64)


def blue_noise_tables() -> tuple[np.ndarray, np.ndarray]:
    """The frame's (64, 128, 128, 3) cosine and (64, 128, 128, 1) scalar
    blue-noise tables, from the spatio-temporal blue noise's ranks."""
    rank = np.load(pathlib.Path(__file__).resolve().parent / "reference"
                   / "assets" / "stbn128x64.npy")
    u = (rank.astype(np.float64) + 0.5) / (128 * 128)
    u0 = u.astype(np.float32)
    u1 = np.roll(u, (17, 37, 73), axis=(0, 1, 2)).astype(np.float32)
    theta = 2.0 * np.pi * u1
    cz = np.sqrt(np.maximum(1.0 - u0, 0.0))
    cr = np.sqrt(u0)
    cosine = np.stack([cr * np.cos(theta), cr * np.sin(theta), cz],
                      axis=-1) * 0.5 + 0.5
    return cosine.astype(np.float32), u0[..., None]


@dataclasses.dataclass
class Motion:
    """The camera and the animated instance of a run, frame by frame."""

    traffic: dict
    seed: int

    def __post_init__(self):
        r = rng_for(self.seed, 0)
        self.angle0 = float(r.uniform(0.0, 2.0 * math.pi))
        self.anim0 = int(r.integers(0, ANIM_PERIOD_FRAMES))
        self.noise0 = int(r.integers(0, NOISE_LAYERS))

    def eye(self, frame: int) -> tuple[float, float, float]:
        cam = self.traffic["camera"]
        if cam["path"] == "still":
            return EYE
        ang = self.angle0 + frame * cam["rad_per_frame"]
        r = math.dist((EYE[0], EYE[2]), (TARGET[0], TARGET[2]))
        return (TARGET[0] + r * math.sin(ang), EYE[1],
                TARGET[2] + r * math.cos(ang))

    def animated(self) -> bool:
        return self.traffic["teapot"] == "animated"

    def obj_to_world(self, base: np.ndarray, inst: int,
                     frame: int) -> np.ndarray:
        """``base`` (I, 3, 4) with instance ``inst`` bobbing and spinning
        at ``frame`` (the upstream example's teapot motion)."""
        t = (self.anim0 + frame) * ANIM_RATE
        o2w = base.copy()
        c, s = math.cos(t), math.sin(t)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        o2w[inst, :3, :3] = rot @ base[inst, :3, :3]
        o2w[inst, :3, 3] = base[inst, :3, 3] + np.asarray(
            [0.0, 5.0 * math.sin(t * 2.0), 0.0], np.float32)
        return o2w


@dataclasses.dataclass(frozen=True)
class Edit:
    """One voxel edit of model ``model``: ``coord`` (engine orientation)
    set to palette index ``palette``; ``splice`` when it lies in a leaf
    the model lacks."""

    model: int
    coord: tuple[int, int, int]
    palette: int
    splice: bool


class EditStream:
    """The traffic's edits, drawn from the seed: a palette change of an
    existing voxel of the edited model for every frame (the brush), and a
    voxel in a new leaf whenever the loop asks for one (a placed block):
    in a leaf at ``splice_y`` that the model lacks, in a seeded order.
    The stream is a function of the seed and the call order alone."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        spec = traffic["edits"]
        names = [m["name"] for m in config["scene"]["models"]]
        self.model = names.index(spec["model_name"])
        coords, _idx = model_voxels(config, spec["model_name"])
        r = rng_for(seed, 1)
        self.brush = coords[r.permutation(len(coords))]
        self.brush_palette = r.integers(1, 256, size=len(coords))
        have = set(map(tuple, (coords >> 2).tolist()))
        y = spec["splice_y"]
        leaves = [(bx, y >> 2, bz) for bx in range(64) for bz in range(64)
                  if (bx, y >> 2, bz) not in have]
        order = r.permutation(len(leaves))
        off = r.integers(0, 4, size=(len(leaves), 3))
        off[:, 1] = y & 3
        self.blocks = [tuple(int(4 * v + o) for v, o in zip(leaves[i], off[k]))
                       for k, i in enumerate(order)]
        self.block_palette = r.integers(1, 256, size=len(self.blocks))
        self._n_block = 0

    def brush_edit(self, frame: int) -> Edit:
        k = frame % len(self.brush)
        return Edit(self.model, tuple(int(v) for v in self.brush[k]),
                    int(self.brush_palette[k]), False)

    def block_edit(self) -> Edit:
        k = self._n_block
        self._n_block += 1
        return Edit(self.model, self.blocks[k], int(self.block_palette[k]),
                    True)
