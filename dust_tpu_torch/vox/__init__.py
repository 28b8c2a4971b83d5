"""Device-side voxel attribute unpacking (torch). The host-side importer
is :mod:`dust_tpu.vox`, reused as it is."""
