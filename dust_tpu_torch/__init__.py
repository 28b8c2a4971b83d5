"""dust_tpu_torch: the dust_tpu renderer ported to PyTorch and CUDA.

The JAX package :mod:`dust_tpu` is the reference; this package keeps its
module names (``ops/camera.py``, ``ops/shade.py``, ``render/pipeline.py``
...) so every function has an obvious counterpart. It imports ``torch``
and never ``jax``. Host-side code that never touched jax (the ``.vox``
importer, the voxel tree, the config dataclasses, the assets) is reused
from :mod:`dust_tpu` as it is.

The one TPU kernel on the headline frame, the batched HDDA scene
traversal, is the hand-written CUDA kernel in ``csrc/hdda.cu`` (see
:mod:`dust_tpu_torch.ops.hdda`), built with ``nvcc`` at first use.
"""

__all__ = ["app", "ops", "render", "utils", "vox"]
