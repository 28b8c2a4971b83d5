"""MagicaVoxel ``.vox`` import: the port's copy of :mod:`dust_tpu.vox`
(numpy, host side), plus leaf attribute unpacking on tensors.

* :mod:`~dust_tpu_torch.vox.parser` — chunk-level ``.vox`` reader/writer.
* :mod:`~dust_tpu_torch.vox.collector` — per-leaf material compaction.
* :mod:`~dust_tpu_torch.vox.loader` — scene-graph traversal, coordinate
  fix-up, tree build (numpy only).
* :mod:`~dust_tpu_torch.vox.geometry` — flat per-model geometry, and
  ``unpack_r10g10b10a2`` on tensors.
* :mod:`~dust_tpu_torch.vox.procgen` — the procedural castle, teapot and
  stress scenes.
"""

from dust_tpu_torch.vox.parser import VoxFile, parse_vox, write_vox  # noqa: F401
from dust_tpu_torch.vox.loader import load_vox_scene, VoxScene, VoxInstance  # noqa: F401
from dust_tpu_torch.vox.geometry import VoxGeometry, build_geometry  # noqa: F401
