"""The ray-sharded mesh (port of :mod:`dust_tpu.parallel.mesh`), on
``torch.distributed``.

Plain SPMD: one process per device, each holding its own shard as local
tensors, with explicit collectives. The backend follows the device:
NCCL for CUDA, gloo for the CPU; nothing picks one for the other.

* A flat axis of ``length`` (rays, table rows, image rows) splits in
  chunks of ``c = ceil(length / N)``: rank ``r`` owns ``[r·c, min(length,
  (r+1)·c))``, so the last rank may own fewer, or none
  (:func:`ray_sharding`). This is the split ``jax.shard_map`` gets when
  the reference pads an axis to ``N·c``.
* The scene is replicated (:func:`replicate_scene`): tracing needs no
  communication.
* The frame state (:func:`shard_frame_state`) keeps the rank's chunk of
  rows of the denoiser history and of the dense GI table; the spatial
  hash, the surfel pool and the scalars are replicated.

Every collective goes through this module and adds to its mesh's
``counts``: ``calls``, and ``bytes``, the size of what each collective
leaves on the rank (a gather's whole output, a reduction's tensor).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["RAY_AXIS", "Mesh", "init_process_group", "make_mesh",
           "ray_sharding", "replicate_scene", "shard_frame_state",
           "gather_rows", "gather_image", "all_reduce_sum", "pad_rays"]

RAY_AXIS = "rays"

# The backend of each device type.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# Seconds a collective may wait for the other ranks before it fails.
TIMEOUT_S = 120


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ray axis: this process's ``rank`` of ``size``,
    its ``device``, and the process ``group`` (None: the default
    group)."""

    group: object
    rank: int
    size: int
    device: torch.device
    counts: dict = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0}, compare=False)

    def chunk(self, length: int) -> int:
        """Rows per rank of an axis of ``length``."""
        return -(-length // self.size)

    def _count(self, t: torch.Tensor):
        self.counts["calls"] += 1
        self.counts["bytes"] += t.numel() * t.element_size()


def init_process_group(rank: int, world_size: int, device, store) -> None:
    """Joins the default process group on the backend of ``device``'s
    type (NCCL for ``cuda``, gloo for ``cpu``) through ``store`` (a
    ``torch.distributed.FileStore`` needs no network), with a timeout of
    ``TIMEOUT_S`` on every collective."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no collective backend for device {device}")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device")
        torch.cuda.set_device(_local_rank(rank))
    dist.init_process_group(
        backend=BACKENDS[kind], store=store, rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _local_rank(rank: int) -> int:
    local = int(os.environ.get("LOCAL_RANK", rank))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank}: local rank {local} has no CUDA "
                           f"device ({torch.cuda.device_count()} present)")
    return local


def make_mesh(group=None) -> Mesh:
    """The mesh of this process in ``group`` (None: the default group,
    which must be initialised). The device is ``cuda:<local rank>``
    under NCCL and the CPU under gloo."""
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    backend = dist.get_backend(group)
    if backend == "nccl":
        device = torch.device("cuda", _local_rank(rank))
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"backend {backend!r}: the mesh runs on nccl "
                         f"(CUDA) or gloo (CPU)")
    return Mesh(group=group, rank=rank, size=size, device=device)


def ray_sharding(mesh: Mesh, length: int) -> tuple[int, int]:
    """This rank's ``[start, stop)`` of a flat axis of ``length``."""
    c = mesh.chunk(length)
    return min(length, mesh.rank * c), min(length, (mesh.rank + 1) * c)


def pad_rays(mesh: Mesh, length: int, origin, direction, t_min, t_max):
    """This rank's rays of a ray axis of ``length`` (its chunk: (m, 3)
    origins and directions, per-ray or scalar t bounds), padded to the
    chunk size with inactive rays: origin 0, direction 1, t_min 0, t_max
    -1, as the reference pads before ``shard_map``. The t bounds come
    back per ray."""
    m = origin.shape[0]
    t_min, t_max = (torch.broadcast_to(torch.as_tensor(
        t, dtype=torch.float32, device=origin.device), (m,))
        for t in (t_min, t_max))
    pad = mesh.chunk(length) - m
    if pad <= 0:
        return origin, direction, t_min, t_max
    return (torch.cat([origin, origin.new_zeros((pad, 3))]),
            torch.cat([direction, direction.new_ones((pad, 3))]),
            torch.cat([t_min, t_min.new_zeros(pad)]),
            torch.cat([t_max, t_max.new_full((pad,), -1.0)]))


def _broadcast(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A copy of rank 0's ``t`` on every rank."""
    t = t.to(mesh.device, copy=True).contiguous()
    dist.broadcast(t, src=_global_rank(mesh, 0), group=mesh.group)
    mesh._count(t)
    return t


def _global_rank(mesh: Mesh, rank: int) -> int:
    if mesh.group is None:
        return rank
    return dist.get_global_rank(mesh.group, rank)


def replicate_scene(scene, mesh: Mesh):
    """The scene with every tensor broadcast from rank 0."""
    return dataclasses.replace(scene, **{
        f.name: _broadcast(mesh, getattr(scene, f.name))
        for f in dataclasses.fields(scene)
        if isinstance(getattr(scene, f.name), torch.Tensor)})


def shard_frame_state(state, mesh: Mesh):
    """The rank's part of a whole-frame ``FrameState``: its chunk of the
    denoiser history's rows and of the dense GI table's rows; every other
    tensor broadcast from rank 0."""
    from dust_tpu_torch.ops import denoise as denoiselib
    from dust_tpu_torch.ops import gi_cache as gilib
    from dust_tpu_torch.ops import spatial_hash as sh

    def rows(t):
        a, b = ray_sharding(mesh, t.shape[0])
        return t[a:b].to(mesh.device, copy=True).contiguous()

    gi = state.gi
    if isinstance(gi, gilib.DenseGICache):
        gi = gilib.DenseGICache(table=rows(gi.table))
    else:
        gi = sh.SpatialHash(table=_broadcast(mesh, gi.table))
    gi_ws = state.gi_ws
    if gi_ws is not None:
        gi_ws = gilib.DenseGICache(table=_broadcast(mesh, gi_ws.table))
    return dataclasses.replace(
        state, gi=gi, gi_ws=gi_ws,
        surfels=_broadcast(mesh, state.surfels),
        denoiser=denoiselib.DenoiserState(history=rows(
            state.denoiser.history)),
        exposure_avg=_broadcast(mesh, state.exposure_avg),
        prev_view_proj=_broadcast(mesh, state.prev_view_proj))


def gather_rows(mesh: Mesh, x: torch.Tensor, length: int) -> torch.Tensor:
    """The whole axis of ``length`` from every rank's chunk ``x`` (its
    rows of :func:`ray_sharding`), in order, on every rank: one
    all-gather."""
    if x.dtype == torch.bool:
        return gather_rows(mesh, x.to(torch.uint8), length).bool()
    c = mesh.chunk(length)
    pad = c - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = torch.cat(parts)[:length]
    mesh._count(out)
    return out


def gather_image(mesh: Mesh, rows: torch.Tensor, height: int) -> torch.Tensor:
    """The whole (height, ...) image from every rank's rows of
    :func:`ray_sharding` over ``height`` (what the sharded frame
    returns)."""
    return gather_rows(mesh, rows, height)


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    mesh._count(x)
    return x
