"""The work of a frame's HDDA launches, counted from what the walk needs,
and the least time the card could take for it: the yardstick of
``hdda_roofline``. Frozen here, so that a change to the kernel or to the
tensors the port passes it leaves the count as it is while the walk's
work is the same.

Per launch: each ray reads its origin and direction and its t range in
float32 (and, in ``ao_fg``, its AO threshold) and writes one hit record
(t, instance, row, bit; ``ao_fg`` writes the AO hit's t and instance and
the gather hit's t, instance and row); the traversal tables of every
instance's model (L1 words, L2 words and ranks, one (lo, hi) mask per
leaf, at the leaf count of the plain build) are read once. Operations:
the set-up of each ray for each instance (affine, normalisation,
reciprocals, box clip, range scaling: 61 float operations, an FMA
counting 2); the walk's own steps depend on the data and are not
counted, so the count is a floor. The rays of each pass come from the
frozen ray accounting (:func:`~benchmark.reference.render.pipeline.
frame_ray_count`).

Under a mesh of N ranks the count is rank 0's: each pass at its padded
chunk of that pass's rays, ceil(rays / N) (every rank traces as many,
the last padding with inactive rays), and reference-mode sun shadows as
the two launches the sharded frame takes in place of the fused one,
ao_threshold then rough.
"""

from __future__ import annotations

from benchmark.reference.render.pipeline import frame_ray_count

# NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit.
MEM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SETUP_FLOPS = 61
L1_BYTES = 512 * 4
L2_BYTES = 4096 * 4 * 4
LEAF_BYTES = 8


def hdda_passes(scene, settings,
                ranks: int | None = None) -> list[tuple[str, int]]:
    """(mode, rays) of each HDDA launch of one frame, in frame order;
    with ``ranks``, of rank 0's launches under a mesh of that many ranks
    (module docstring)."""
    n = settings.width * settings.height

    def chunk(rays: int) -> int:
        return rays if ranks is None else -(-rays // ranks)

    passes = [("precise", chunk(n))]
    if settings.contribution_direct:
        if settings.shadow_mode == "precise":
            passes.append(("precise", chunk(n)))
        elif ranks is None:
            passes.append(("ao_fg", n))
        else:
            passes += [("ao_threshold", chunk(n)), ("rough", chunk(n))]
    total = frame_ray_count(scene, settings)
    gi_rays = total - 4 * n
    if gi_rays > 0:
        passes += [("ao_threshold", chunk(n)), ("rough", chunk(n))]
        surfel = chunk(gi_rays // 2)
        if settings.contribution_secondary_sunlight:
            passes.append(("rough", surfel))
        passes.append(("rough", surfel))
    return passes


def launch_bytes(mode: str, rays: int, table_bytes: int) -> int:
    fused = mode == "ao_fg"
    return rays * ((36 if fused else 32) + (20 if fused else 16)) + table_bytes


def table_bytes(model_leaves: list[int]) -> int:
    """Bytes of the tables one launch reads: each traced model's, at its
    leaf count."""
    return sum(L1_BYTES + L2_BYTES + LEAF_BYTES * n for n in model_leaves)


def least_time_s(passes, model_leaves: list[int],
                 instances: int) -> tuple[float, str]:
    """The least time of a frame's launches on the card, and what bounds
    most of it ("bytes" or "operations")."""
    tb = table_bytes(model_leaves)
    inst = instances
    total, by_bytes = 0.0, 0.0
    for mode, rays in passes:
        b = launch_bytes(mode, rays, tb) / MEM_BYTES_PER_S
        f = SETUP_FLOPS * rays * inst / F32_FLOPS_PER_S
        total += max(b, f)
        by_bytes += b if b >= f else 0.0
    return total, "bytes" if by_bytes >= total / 2 else "operations"


def model_leaves(scene) -> list[int]:
    """The leaf count of each model an instance uses, from a scene's
    masks."""
    valid = ((scene.mask_lo | scene.mask_hi) != 0).sum(dim=1).tolist()
    return [int(valid[m]) for m in sorted(set(scene.inst_model))]
