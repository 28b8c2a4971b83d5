"""Configuration dataclasses for the engine.

The reference has no config system — configuration is Rust plugin structs and
ECS resources (SURVEY §5.6: ``RenderPlugin``, ``Sunlight`` at
``crates/render/src/pipeline/sky.rs:6``, ``ExposureSettings`` at
``crates/render/src/pipeline/auto_exposure.rs:228``, GLSL ``#define`` /
specialization constants). Here they are explicit, hashable dataclasses so
they can be closed over by ``jax.jit`` as static configuration.

The port's copy of :mod:`dust_tpu.config`.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SunlightSettings:
    """Sun + sky configuration.

    Reference: ``Sunlight`` resource, ``crates/render/src/pipeline/sky.rs:6-23``.
    ``direction`` points from the eye toward the sun and must be normalised.
    """

    turbidity: float = 1.0
    albedo: tuple[float, float, float] = (0.2, 0.2, 0.2)
    direction: tuple[float, float, float] = (0.0, 0.80114365, -0.5984721)

    # Solar angular radius used by the solar-disc term; the reference bakes
    # (0.51 deg)/2 into SkyModelState.sunlight_intensity.w (sky.rs:129).
    solar_radius: float = (0.51 * math.pi / 180.0) / 2.0


@dataclasses.dataclass(frozen=True)
class ExposureSettings:
    """Histogram auto-exposure parameters.

    Reference: ``ExposureSettings`` + the two compute passes in
    ``crates/render/src/pipeline/auto_exposure.rs`` /
    ``assets/shaders/auto_exposure.comp``.
    """

    min_log_luminance: float = -6.0
    max_log_luminance: float = 8.5
    time_coefficient: float = 0.2  # fraction of the distance to move per frame
    num_bins: int = 256

    @property
    def log_luminance_range(self) -> float:
        return self.max_log_luminance - self.min_log_luminance


@dataclasses.dataclass(frozen=True)
class DenoiserSettings:
    """Temporal accumulation + à-trous spatial filter.

    Replaces the closed-source NRD REBLUR integration
    (``crates/render/src/pipeline/nrd.rs``) with an open, TPU-friendly
    reimplementation: motion-vector temporal reprojection with
    depth/normal validity tests, then ``atrous_iterations`` of an
    edge-aware à-trous wavelet filter guided by hit distance.
    """

    max_accumulated_frames: int = 30
    atrous_iterations: int = 4
    depth_sigma: float = 0.7
    normal_sigma: float = 32.0
    luminance_sigma: float = 4.0
    # Normalised-hit-distance driven blur scaling (REBLUR-style).
    hitdist_blur_scale: float = 1.0
    # History clamping: fetched history is clamped to the current frame's
    # 3x3 mean +- clamp_sigma * sigma box (REBLUR color clamp).
    clamp_sigma: float = 2.0
    # Anti-lag fast history cap and sensitivity: the history length is cut
    # when |fast - slow| luminance exceeds the local noise level
    # (antilag_sigma * sigma + antilag_relative * signal).
    fast_max_accumulated_frames: int = 4
    antilag_sigma: float = 3.0
    antilag_relative: float = 0.25
    # (An atrous_guide_bf16 flag — bf16 storage for the à-trous guide
    # pack — shipped round 4 quality-neutral but perf-unmeasured; the
    # round-5 frame A/B measured it 58.0 vs 56.0 ms at 1080p (the
    # shifted guide reads are not the filter's bottleneck, and the
    # cast/widen pairs cost more than the saved traffic), so the flag
    # and the bf16 path were removed per the prune-or-promote rule.)
    # Denoise the stochastic indirect (AO/final-gather/skylight) channel
    # at half resolution with a joint-bilateral upsample, compositing the
    # deterministic sun-NEE direct term at full resolution. Deviation
    # from the reference (which feeds direct+indirect into REBLUR
    # together): the direct term has ZERO variance — denoising it wastes
    # the whole temporal/spatial chain on a clean signal AND blurs shadow
    # edges; splitting keeps shadows pixel-sharp and cuts the denoiser's
    # gather/filter cost 4x. Requires even width/height (else full-res).
    half_res_indirect: bool = True
    # Full-resolution path only: route only the stochastic indirect
    # through the temporal chain (like the half-res path) instead of the
    # reference-lumped direct+indirect feed. Isolates the RESOLUTION
    # error when comparing half-res against full-res (the quality gate in
    # tests/test_quality.py); the lumped default keeps NRD-input parity.
    split_direct: bool = False


@dataclasses.dataclass(frozen=True)
class SpatialHashSettings:
    """GI radiance cache layout.

    Reference: ``assets/shaders/headers/spatial_hash.glsl:1`` (capacity
    specialization constant, default 32Mi entries) and ``:179``
    (MAX_SAMPLE_COUNT = 404). The default here is smaller; pass the
    reference value explicitly for a parity run.
    """

    capacity: int = 1 << 20
    max_sample_count: int = 404
    num_probes: int = 3
    # Cell size in world units: leaves are 4 voxels wide and keys are
    # quantised leaf centres / 4 (final_gather.rchit:43).
    cell_size: float = 4.0
    # Max unique cells scattered into the table per insert batch (the
    # scatter is row-count bound; overflow defers deterministically to
    # later frames — spatial_hash.hash_insert). 0 = uncapped.
    insert_cap: int = 1 << 17
    # Working-set probe rotation: the hash mode's per-frame working set
    # (ONE hash_get per (instance, leaf, face) cell, see
    # render/pipeline.py) re-probes only a rotating 1/N slice each frame
    # when N > 1; the rest serves the value from its last probe (kept in
    # FrameState.gi_ws). Error class matches the reference's own
    # semantics: a reference cell's value also only changes when some
    # pool surfel lands on it, which at a 345k pool over ~1M+ active
    # cells is every few frames — the rotation adds at most N-1 frames
    # of the same lag. 1 = probe every cell every frame.
    ws_refresh_slices: int = 1


@dataclasses.dataclass(frozen=True)
class SurfelSettings:
    """Surfel pool used to refresh the spatial hash over frames.

    Reference: 720*480 pool (``standard.rs:334-341``,
    ``headers/surfel.glsl``), one cosine ray + one sun-NEE ray per surfel
    per frame (``surfel/surfel.rgen``).
    """

    pool_size: int = 720 * 480

    # Dense-GI refresh budget: at most this many (instance, leaf, face)
    # cells are patched per frame — the reference's own fixed-pool
    # semantics (720*480 surfels regardless of scene size). Scenes whose
    # cell count exceeds the budget refresh round-robin slices over
    # frames (contiguous dynamic slices — still scatter-free), so the
    # per-frame ray cost stays O(budget) instead of O(instances × leaves).
    # None/0 = always refresh every cell.
    dense_refresh_budget: int = 720 * 480

    # Hash-mode pool refresh budget: at most this many pool slots trace
    # their refresh rays (cosine + sun NEE) per frame, rotating round-
    # robin like dense_refresh_budget. The reference's own scheduler is
    # stochastic (a cell with count c re-enqueues with p = 1/(c+2),
    # surfel.rchit:95-105) so per-slot refresh is already every-few-
    # frames there; the rotation makes the budget deterministic.
    # None/0 = trace the whole pool every frame.
    pool_refresh_budget: int = 0


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera.

    Reference: ``PinholeProjection`` (``crates/render/src/projection.rs:4``)
    with infinite-reverse-Z projection (``standard.rs:277-302``); ray
    generation per ``headers/camera.glsl``.
    """

    fov: float = math.pi / 2.0
    near: float = 0.1
    far: float = 100000.0


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Top-level per-frame pipeline configuration.

    The CONTRIBUTION_* toggles mirror ``headers/standard.glsl:16-26``.
    """

    width: int = 1920
    height: int = 1080

    # Light-path contribution toggles (standard.glsl:16-26).
    contribution_direct: bool = True                 # Eye -> Object -> Sun
    contribution_secondary_skylight: bool = True     # Eye -> Object -> Sky
    contribution_secondary_spatial_hash: bool = True  # Eye -> Obj -> Obj
    contribution_secondary_sunlight: bool = True     # Eye->Obj->Surfel->Sun

    # tmax for the AO ray; beyond this the final-gather pass takes over
    # (standard.glsl:28 AMBIENT_OCCLUSION_THRESHOLD).
    ambient_occlusion_threshold: float = 8.0

    # Sun-shadow (NEE) intersector. "reference" = the reference's actual
    # semantics: shadow rays run through the AO pipeline's intersector
    # (ambient_occlusion.rint), which does the precise voxel DDA only
    # within AMBIENT_OCCLUSION_THRESHOLD and reports any occupied LEAF
    # at entry beyond it — block-granular occlusion for distant
    # occluders (slightly conservative shadows, exactly like the
    # reference; ~2x cheaper: no leaf-mask fetches past the threshold).
    # "precise" = full voxel DDA over the whole ray (the round-1/2
    # behavior; pixel-exact distant occlusion the reference never had).
    shadow_mode: str = "reference"

    # DEBUG_VISUALIZE_SPATIAL_HASH (standard.glsl:26, hit.rchit:34-55):
    # render the GI cache contents directly — illuminance = cached cell
    # radiance, albedo = the leaf's average albedo.
    debug_visualize_spatial_hash: bool = False

    camera: CameraConfig = CameraConfig()
    sunlight: SunlightSettings = SunlightSettings()
    exposure: ExposureSettings = ExposureSettings()
    denoiser: DenoiserSettings = DenoiserSettings()
    spatial_hash: SpatialHashSettings = SpatialHashSettings()
    surfels: SurfelSettings = SurfelSettings()

    # Traversal kernel selection: "jnp" (pure XLA wavefront loop) or
    # "pallas" (hand-written Mosaic kernel).
    traversal_backend: str = "jnp"

    # (A fuse_ao_fg flag fusing the AO + final-gather walks into one
    # Pallas dispatch shipped rounds 2-4; measured 2.5 ms SLOWER than
    # the split passes at 1080p — per-round fixed costs over the union
    # round count — and pruned in round 5. The ao_fg kernel mode itself
    # remains: the reference-parity sun-shadow path is built on it.
    # Measurement record: ARCHITECTURE.md "perf non-wins".)

    # Per-instance material TYPE ids (() = all palette). Static by
    # design: the set of materials specializes the traced pipeline the
    # way the reference builds a pipeline permutation per material
    # subset (render/src/pipeline/manager.rs:277-315) — see
    # render/materials.py for the registry + dispatch.
    instance_materials: tuple = ()

    # (An fg_octant_sort ray-coherence experiment — octant-grouping the
    # cosine STBN per kernel tile region — shipped rounds 4; measured
    # ~neutral in-frame (the FG tile max is path-length-bound, not
    # direction-bound, tools/march_sim.py) and pruned in round 5. The
    # page-sort helper lives on in noise.octant_sort_regions for the
    # simulator; measurement record: ARCHITECTURE.md round-4 section.)

    # GI cache backend: "hash" = the reference's open-addressed spatial
    # hash + stochastic surfel pool (unbounded scenes); "dense" = one row
    # per (instance, leaf_row, face) cell, scatter-free inserts, every
    # cell refreshed each frame (the TPU-first fast path; see
    # ops/gi_cache.py). Dense mode ignores surfels.pool_size — the pool
    # IS the cell list.
    gi_cache: str = "hash"

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
