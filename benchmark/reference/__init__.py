"""The benchmark's plain reference: a frozen copy of the port's host
scene build (``.vox`` parsing, the numpy voxel tree, the device scene's
tables) and of its frame without a mesh, in plain PyTorch and numpy.
Every trace runs the plain walk (:mod:`benchmark.reference.ops.hdda`);
nothing here builds or launches a kernel or imports the port, so a later
change to the port cannot move what the benchmark compares it with."""
