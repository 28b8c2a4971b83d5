"""Minimal MagicaVoxel ``.vox`` chunk parser + writer (no dependencies).

Plays the role of the ``dot_vox`` crate in the reference
(``crates/vox/src/loader.rs:334``). Supports the chunks the reference
consumes: SIZE/XYZI model pairs, RGBA palette, and the nTRN/nGRP/nSHP
scene graph. Unknown chunks (MATL, LAYR, rOBJ, ...) are skipped.

Conventions (documented because the 1-based palette indexing of the format
is a classic trap): ``palette`` is a (256,4) uint8 array arranged so that
``palette[voxel.i]`` is the voxel's RGBA — i.e. entry 0 is a placeholder
and file RGBA entry ``j`` lands at ``palette[j+1]``, matching how dot_vox
presents it to the reference loader.

The port's copy of :mod:`dust_tpu.vox.parser`.
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np

__all__ = ["VoxFile", "VoxModel", "TransformNode", "GroupNode", "ShapeNode",
           "parse_vox", "write_vox", "DEFAULT_PALETTE", "rotation_from_byte",
           "rotation_to_byte"]


@dataclasses.dataclass
class VoxModel:
    size: tuple[int, int, int]  # file-order (x, y, z); z is "up" in MV
    voxels: np.ndarray  # (N,4) uint8: x, y, z, color index i


@dataclasses.dataclass
class TransformNode:
    child: int
    translation: tuple[int, int, int] = (0, 0, 0)
    rotation: np.ndarray = None  # (3,3) int signed-permutation
    name: str | None = None
    layer: int = -1

    def __post_init__(self):
        if self.rotation is None:
            self.rotation = np.eye(3, dtype=np.int32)


@dataclasses.dataclass
class GroupNode:
    children: list[int]


@dataclasses.dataclass
class ShapeNode:
    model_ids: list[int]


@dataclasses.dataclass
class VoxFile:
    models: list[VoxModel]
    palette: np.ndarray  # (256,4) uint8, palette[i] == color of voxel index i
    scenes: dict[int, object]  # node id -> Transform/Group/Shape node
    root: int = 0


def rotation_from_byte(b: int) -> np.ndarray:
    """Decode the packed ``_r`` rotation byte into a signed permutation.

    Format: bits 0-1 = column index of the 1 in row 0, bits 2-3 = column
    index in row 1 (row 2 is the remaining column), bits 4/5/6 = sign of
    rows 0/1/2.
    """
    i0 = b & 3
    i1 = (b >> 2) & 3
    i2 = 3 - i0 - i1
    m = np.zeros((3, 3), dtype=np.int32)
    m[0, i0] = -1 if (b >> 4) & 1 else 1
    m[1, i1] = -1 if (b >> 5) & 1 else 1
    m[2, i2] = -1 if (b >> 6) & 1 else 1
    return m


def rotation_to_byte(m: np.ndarray) -> int:
    i0 = int(np.flatnonzero(m[0])[0])
    i1 = int(np.flatnonzero(m[1])[0])
    b = i0 | (i1 << 2)
    if m[0, i0] < 0:
        b |= 1 << 4
    if m[1, i1] < 0:
        b |= 1 << 5
    i2 = 3 - i0 - i1
    if m[2, i2] < 0:
        b |= 1 << 6
    return b


def _read_dict(buf: io.BytesIO) -> dict[str, str]:
    (n,) = struct.unpack("<i", buf.read(4))
    out = {}
    for _ in range(n):
        (klen,) = struct.unpack("<i", buf.read(4))
        k = buf.read(klen).decode("utf-8")
        (vlen,) = struct.unpack("<i", buf.read(4))
        v = buf.read(vlen).decode("utf-8")
        out[k] = v
    return out


def parse_vox(data: bytes) -> VoxFile:
    if data[:4] != b"VOX ":
        raise ValueError("not a .vox file (missing 'VOX ' magic)")
    buf = io.BytesIO(data)
    buf.read(8)  # magic + version

    models: list[VoxModel] = []
    sizes: list[tuple[int, int, int]] = []
    palette = DEFAULT_PALETTE.copy()
    scenes: dict[int, object] = {}

    def read_chunk():
        header = buf.read(12)
        if len(header) < 12:
            return None
        cid, content_len, children_len = struct.unpack("<4sii", header)
        content = buf.read(content_len)
        return cid, content, children_len

    top = read_chunk()
    if top is None or top[0] != b"MAIN":
        raise ValueError("missing MAIN chunk")

    while True:
        chunk = read_chunk()
        if chunk is None:
            break
        cid, content, _ = chunk
        c = io.BytesIO(content)
        if cid == b"SIZE":
            sizes.append(struct.unpack("<iii", c.read(12)))
        elif cid == b"XYZI":
            (n,) = struct.unpack("<i", c.read(4))
            vox = np.frombuffer(c.read(4 * n), dtype=np.uint8).reshape(n, 4).copy()
            size = sizes[len(models)] if len(models) < len(sizes) else (256, 256, 256)
            models.append(VoxModel(size=size, voxels=vox))
        elif cid == b"RGBA":
            rgba = np.frombuffer(c.read(4 * 256), dtype=np.uint8).reshape(256, 4)
            # File entry j is the color of voxel index j+1.
            palette = np.zeros((256, 4), dtype=np.uint8)
            palette[1:] = rgba[:255]
        elif cid == b"nTRN":
            (nid,) = struct.unpack("<i", c.read(4))
            attrs = _read_dict(c)
            child, _res, layer, nframes = struct.unpack("<iiii", c.read(16))
            trans = (0, 0, 0)
            rot = np.eye(3, dtype=np.int32)
            for _ in range(max(nframes, 1)):
                fattrs = _read_dict(c)
                if "_t" in fattrs:
                    trans = tuple(int(x) for x in fattrs["_t"].split())
                if "_r" in fattrs:
                    rot = rotation_from_byte(int(fattrs["_r"]))
                break  # like the reference, only frame 0 (loader.rs:103-105)
            scenes[nid] = TransformNode(
                child=child, translation=trans, rotation=rot,
                name=attrs.get("_name"), layer=layer,
            )
        elif cid == b"nGRP":
            (nid,) = struct.unpack("<i", c.read(4))
            _read_dict(c)
            (n,) = struct.unpack("<i", c.read(4))
            scenes[nid] = GroupNode(children=list(struct.unpack(f"<{n}i", c.read(4 * n))))
        elif cid == b"nSHP":
            (nid,) = struct.unpack("<i", c.read(4))
            _read_dict(c)
            (n,) = struct.unpack("<i", c.read(4))
            ids = []
            for _ in range(n):
                (mid,) = struct.unpack("<i", c.read(4))
                _read_dict(c)  # model attributes
                ids.append(mid)
            scenes[nid] = ShapeNode(model_ids=ids)
        # else: skip unknown chunk

    return VoxFile(models=models, palette=palette, scenes=scenes, root=0)


def write_vox(f: VoxFile) -> bytes:
    """Serialise a VoxFile (used by procgen + round-trip tests)."""

    def chunk(cid: bytes, content: bytes, children: bytes = b"") -> bytes:
        return struct.pack("<4sii", cid, len(content), len(children)) + content + children

    def wdict(d: dict[str, str]) -> bytes:
        out = struct.pack("<i", len(d))
        for k, v in d.items():
            kb, vb = k.encode(), v.encode()
            out += struct.pack("<i", len(kb)) + kb + struct.pack("<i", len(vb)) + vb
        return out

    body = b""
    for m in f.models:
        body += chunk(b"SIZE", struct.pack("<iii", *m.size))
        body += chunk(
            b"XYZI",
            struct.pack("<i", len(m.voxels)) + m.voxels.astype(np.uint8).tobytes(),
        )
    rgba = np.zeros((256, 4), dtype=np.uint8)
    rgba[:255] = f.palette[1:]
    body += chunk(b"RGBA", rgba.tobytes())
    for nid in sorted(f.scenes):
        node = f.scenes[nid]
        if isinstance(node, TransformNode):
            fattrs = {"_t": " ".join(str(int(t)) for t in node.translation)}
            if not np.array_equal(node.rotation, np.eye(3, dtype=np.int32)):
                fattrs["_r"] = str(rotation_to_byte(node.rotation))
            content = (
                struct.pack("<i", nid)
                + wdict({"_name": node.name} if node.name else {})
                + struct.pack("<iiii", node.child, -1, node.layer, 1)
                + wdict(fattrs)
            )
            body += chunk(b"nTRN", content)
        elif isinstance(node, GroupNode):
            content = (
                struct.pack("<i", nid)
                + wdict({})
                + struct.pack("<i", len(node.children))
                + struct.pack(f"<{len(node.children)}i", *node.children)
            )
            body += chunk(b"nGRP", content)
        elif isinstance(node, ShapeNode):
            content = struct.pack("<i", nid) + wdict({}) + struct.pack("<i", len(node.model_ids))
            for mid in node.model_ids:
                content += struct.pack("<i", mid) + wdict({})
            body += chunk(b"nSHP", content)
    main = struct.pack("<4sii", b"MAIN", 0, len(body)) + body
    return b"VOX " + struct.pack("<i", 150) + main


def _default_palette() -> np.ndarray:
    """A deterministic fallback palette for files without an RGBA chunk
    (hue ramp; MagicaVoxel's real default differs but nothing here
    depends on it)."""
    p = np.zeros((256, 4), dtype=np.uint8)
    idx = np.arange(1, 256)
    p[1:, 0] = (idx * 53) % 256
    p[1:, 1] = (idx * 101) % 256
    p[1:, 2] = (idx * 197) % 256
    p[1:, 3] = 255
    return p


DEFAULT_PALETTE = _default_palette()
