"""Multi-device sharding of the frame (port of :mod:`dust_tpu.parallel`):
rays tile-sharded over a 1-D mesh of ``torch.distributed`` ranks, one
process per device, the scene replicated (:mod:`.mesh`). ``python -m
dust_tpu_torch.parallel.dryrun`` runs the reference's multi-device dry
run on N ranks."""

from dust_tpu_torch.parallel.mesh import (  # noqa: F401
    RAY_AXIS, Mesh, all_reduce_sum, gather_image, gather_rows,
    init_process_group, make_mesh, pad_rays, ray_sharding, replicate_scene,
    shard_frame_state)
