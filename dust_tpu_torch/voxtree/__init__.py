"""Sparse voxel tree, host side: the port's copy of :mod:`dust_tpu.voxtree`
(numpy): ``tree.py`` and ``pool.py`` (the build the loader uses),
``bitmask.py``, ``accessor.py`` (the cached-path point accessor) and
``generic.py`` (``GenericTree``, ``UnboundedRoot``)."""

from dust_tpu_torch.voxtree.bitmask import BitMask  # noqa: F401
from dust_tpu_torch.voxtree.pool import Pool  # noqa: F401
from dust_tpu_torch.voxtree.tree import VoxTree, FlatTree  # noqa: F401
from dust_tpu_torch.voxtree.accessor import Accessor  # noqa: F401
