"""dust_tpu_torch: the dust_tpu renderer ported to PyTorch and CUDA.

The JAX package :mod:`dust_tpu` is the reference; this package keeps its
module names (``ops/camera.py``, ``ops/shade.py``, ``render/pipeline.py``
...) so every function has an obvious counterpart. It imports ``torch``
and never ``jax``, and nothing of :mod:`dust_tpu`: the host-side code it
needs (the config dataclasses in ``config.py``, the ``.vox`` importer in
``vox/``, the voxel tree in ``voxtree/``, the PNG writer in
``utils/image.py``, the colour constants, the assets) is a copy under the
same module names.

The TPU kernels (the HDDA traversal's scene and single-instance kernels)
are hand-written CUDA kernels in ``csrc/hdda.cu`` (see
:mod:`dust_tpu_torch.ops.hdda`), built with ``nvcc`` at first use. The
reference's tools are ported in :mod:`dust_tpu_torch.tools`, one module
each (``python -m dust_tpu_torch.tools.<name>``).

Importing the package builds nothing and touches no device.
"""

__version__ = "0.1.0"

from dust_tpu_torch.config import (  # noqa: F401
    RenderSettings,
    ExposureSettings,
    DenoiserSettings,
    SpatialHashSettings,
    SunlightSettings,
)
