"""ctypes bindings for the native scene-build kernels (``voxcore.cpp``):
the port's counterpart of :mod:`dust_tpu.native`, built from its own copy
of the source.

The library is compiled with ``g++`` at first use by
:func:`dust_tpu_torch.csrc.build`, which builds the CUDA kernels too,
into ``build/dust_tpu_torch/`` under a name hashed from the source and
the flags; importing builds nothing. A missing compiler or a failed
compile raises ``RuntimeError`` with the compiler's message: nothing
falls back to numpy. The plain versions that the tests hold these against are
:meth:`VoxTree.from_voxels` with :func:`collect_material_indices`
(``build_leaves`` with :meth:`FlatTree.from_dense_pools`) and
``render.scene._chebyshev_plain`` (``chebyshev``).

A ``ctypes.CDLL`` call releases the interpreter lock, so the editor's
staged rebuild runs beside the render thread.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from dust_tpu_torch import csrc

__all__ = ["available", "build_library", "build_leaves", "chebyshev"]

CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_SOURCE = Path(__file__).resolve().parent / "voxcore.cpp"
_BLOCKS = 64 ** 3
_LIB = None
_LOCK = threading.Lock()


def build_library() -> Path:
    """Compile ``voxcore.cpp`` with :data:`CXX` and :data:`CXX_FLAGS`
    (:func:`dust_tpu_torch.csrc.build`)."""
    return csrc.build(_SOURCE, "voxcore", CXX, CXX_FLAGS)


def _library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            vp = ctypes.c_void_p
            lib.voxcore_build_leaves.restype = ctypes.c_int64
            lib.voxcore_build_leaves.argtypes = [vp, vp, ctypes.c_int64,
                                                 vp, vp, vp]
            lib.voxcore_chebyshev.restype = None
            lib.voxcore_chebyshev.argtypes = [vp, vp, ctypes.c_int32]
            _LIB = lib
    return _LIB


def available() -> bool:
    """Build and load the library (at the first call) and report whether
    that worked. Only tools and tests read it: the loader, the editor and
    the skip field call the library and raise when it does not build."""
    try:
        _library()
    except (RuntimeError, OSError):
        return False
    return True


def build_leaves(coords: np.ndarray, palette_idx: np.ndarray):
    """Per-block occupancy and compacted materials of a voxel list
    (engine orientation, duplicates last write wins).

    Returns (occupancy u64 (262144,), block_ptr u32 (262144,): the
    exclusive prefix sum of the blocks' voxel counts, materials u8
    (n_unique,) in (block, bit) order); blocks in the collector's linear
    order ``bx + by*64 + bz*64^2``. Raises ``ValueError`` on a coordinate
    outside the 256^3 extent."""
    coords = np.asarray(coords)
    palette_idx = np.ascontiguousarray(palette_idx, dtype=np.uint8)
    n = len(coords)
    if coords.ndim != 2 or coords.shape[1] != 3 or palette_idx.shape != (n,):
        raise ValueError(f"coords (N, 3) and palette_idx (N,): got "
                         f"{coords.shape} and {palette_idx.shape}")
    c32 = np.ascontiguousarray(coords, dtype=np.int32)
    if c32.dtype != coords.dtype and not np.array_equal(c32, coords):
        raise ValueError("voxel coordinates out of the 256^3 extent")
    occupancy = np.zeros(_BLOCKS, dtype=np.uint64)
    block_ptr = np.zeros(_BLOCKS, dtype=np.uint32)
    materials = np.zeros(max(n, 1), dtype=np.uint8)
    m = _library().voxcore_build_leaves(
        c32.ctypes.data, palette_idx.ctypes.data, n, occupancy.ctypes.data,
        block_ptr.ctypes.data, materials.ctypes.data)
    if m < 0:
        raise ValueError("voxel coordinates out of the 256^3 extent")
    return occupancy, block_ptr, materials[:m].copy()


def chebyshev(occupied: np.ndarray, max_dist: int = 63) -> np.ndarray:
    """Chebyshev (L-infinity) distance to the nearest occupied cell of a
    (64, 64, 64) field, clamped to ``max_dist``; occupied cells get 0.
    Returns int32 (64, 64, 64)."""
    if occupied.shape != (64, 64, 64):
        raise ValueError(f"a (64, 64, 64) field, got {occupied.shape}")
    occ = np.ascontiguousarray(occupied.reshape(-1), dtype=bool)
    dist = np.zeros(_BLOCKS, dtype=np.int32)
    _library().voxcore_chebyshev(occ.ctypes.data, dist.ctypes.data,
                                 max_dist)
    return dist.reshape(64, 64, 64)
