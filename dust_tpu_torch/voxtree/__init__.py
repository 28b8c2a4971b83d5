"""Sparse voxel tree, host build side: the port's copy of
:mod:`dust_tpu.voxtree` ``tree.py`` and ``pool.py`` (numpy)."""
