"""Sparse voxel tree, host side: the port's copy of :mod:`dust_tpu.voxtree`
(numpy): ``tree.py`` and ``pool.py`` (the build the loader uses),
``bitmask.py``, ``accessor.py`` (the cached-path point accessor) and
``generic.py`` (``GenericTree``, ``UnboundedRoot``)."""
