#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the HDDA traversal kernel (dust_tpu_torch/csrc/hdda.cu) with nvcc
   and the native scene build (dust_tpu_torch/native/voxcore.cpp) with g++;
3. renders one 1920x1080 castle+teapot frame of the dense-GI configuration
   while recording every traversal launch, then holds the kernel against
   its plain PyTorch version on the card, per mode, on a 65,536-ray
   subsample of that mode's real rays (every output equal, torch.equal),
   times both on the full ray set, and computes the launch's bound (the
   bytes it must move at the card's memory rate);
4. the slice: resets the launch counts, renders 4 frames through
   render_frame on the card, checks 6 kernel launches per frame and a
   finite, non-black image, prints ms/frame and Mrays/s, and counts one
   more frame's CUDA kernels and host syncs with torch.profiler;
5. renders a 256x144 frame on the card and on the CPU (plain versions)
   and checks that the two images agree (RMSE < 0.01);
6. the many-instance frame (bench.py --config stress: 3x3 castles + 2
   teapots, 11 instances, 1920x1080, the dense-cache refresh rotating
   through budget slices), batched scene-trace route: holds the scene
   kernel against its plain version on that frame's real rays (>2
   instances: near-to-far sweep order, per-ray instance skip; torch.equal)
   and times it per mode on the full launches, then renders 4 frames,
   checks 6 scene-kernel launches per frame and a finite, non-black
   image, and prints ms/frame and Mrays/s;
7. the same frame through the loop route (DUST_PALLAS_SCENE=loop, set
   in-process and removed afterwards): checks the single-instance
   kernel's launches per frame (11 per trace: precise 11, ao_fg 11,
   ao_threshold 11, rough 33; no scene-kernel launch), prints ms/frame
   and Mrays/s, holds that kernel against its plain version per mode on
   the whole recorded launch with the most active rays and on three edge
   launches made from it (no ray active with NaN origins, only its
   active rays, a ragged count; torch.equal), times both on that launch
   against the bound of what each ray needs, sums the kernel's device
   time over every launch of one loop frame per mode (the creeping
   ray's launches apart), and checks the loop-route image against the
   batched-route image of the same frame (RMSE < 0.01);
8. renders a 128x72 stress frame on the card and on the CPU and checks
   that the two images agree (RMSE < 0.01);
9. the spatial-hash frame (bench.py --config hash-reference: castle +
   animated teapot, 1920x1080, gi_cache="hash" with 2^25 slots, a
   720x480 surfel pool, insert_cap 2^17): resets the launch counts,
   renders 4 frames through render_frame on the card, checks 6
   scene-kernel launches per frame, a finite, non-black image and a
   table whose occupied slots grow from frame 1 to frame 4, prints
   ms/frame and Mrays/s, and counts one frame's CUDA kernels and host
   syncs with torch.profiler; then holds the scene kernel against its
   plain version on the surfel pass's rough launches of a later frame
   (the pool's rays; torch.equal on a 65,536-ray subsample), times
   them, and times one call each of the hash's working-set probe and
   insert;
10. renders a 256x144 hash frame (2^16 slots, a 4096-surfel pool) on the
   card and on the CPU for 2 frames: image RMSE < 0.01, and the two
   tables agree on fingerprint, last frame and sample count in >= 99%
   of the occupied slots;
11. primary-shadow (bench.py --config primary-shadow, the frame without
   GI): 4 frames at 1920x1080, 2 scene-kernel launches per frame
   (precise, ao_fg), ms/frame and Mrays/s at 2*W*H rays;
12. gi-4k (3840x2160): the scene kernel held against its plain version
   on 65,536 of each mode's rays (torch.equal) and graph-timed on each
   full launch against its bound; then 4 frames, 6 launches per frame;
13. flythrough (gi-4k, the camera orbiting): 4 frames, 6 launches each;
14. precise sun shadows (precise x2, ao_threshold, rough x3 per frame)
   and the full-resolution denoise, split and lumped: 2 frames each at
   1920x1080, and each at 256x144 on the card and on the CPU (RMSE <
   0.01);
15. the eager backend (traversal_backend="jnp", torch ops, no kernel
   launch): the gi frame at 1920x1080 (960x540 if a frame takes over
   10 s, and says so), timed at several lane-retirement intervals, then
   4 frames; one frame against the kernel's backend (RMSE < 0.01, hit
   masks >= 99.5%); its traversal on the card against the same on the
   CPU on 65,536 sampled rays per mode (every (inst, row, bit) equal);
16. tests/test_quality.py's converged-ground-truth gates at its bounds
   and frame counts (tests/golden/castle_gt_256x256.npz, loaded with
   numpy), on the kernel's backend;
17. edits and refit with the GI frame re-rendered (BASELINE config #4;
   dust_tpu_torch/bench_edits.py's frame: castle + teapot at rest,
   1920x1080, dense GI): 10-frame runs, the better of two, with no
   edit, with a leaf edit every frame, and with splices staged off the
   render thread, then one forced rebuild (a slab of 4096 new leaves).
   After each tier: the editor's tier and edits.REFITS (a leaf refit
   a frame, a splice a staged block, one rebuild, none with no edit),
   6 scene-kernel launches per frame, every tensor of the card's scene
   equal (torch.equal) to a CPU editor's given the same edits, the
   dense GI albedo words equal to a fresh cache of the edited scene, and
   the scene kernel equal to its plain version on 65,536 of the frame's
   rays per mode; then one
   loop-route frame on the rebuilt tables with the instance kernel held
   on each of its 12 launches whole and its device time summed; a frame with and one without a leaf edit under
   torch.profiler (the edit adds no host sync); a 1080p frame with the
   teapot on EmissiveMaterial (and
   at 256x144 card vs CPU RMSE < 0.01, the teapot's pixels brighter);
   a checkpoint saved after frame 2 and loaded into a fresh state on the
   card renders frame 3 equal to the run that never stopped; and the
   isolated refit tiers' latencies (bench_edits' default mode);
18. the ray-sharded flythrough (BASELINE config #5: 3840x2160, the
   camera orbiting) through render_frame with a mesh on a one-rank NCCL
   group (dust_tpu_torch/parallel): the scene kernel held against its
   plain version on 65,536 of each mode's sharded rays (torch.equal),
   the sun's two launches (ao_threshold, rough; the sharded route takes
   no fused ao_fg) timed against the unsharded frame's ao_fg launch,
   then 4 frames with 7 scene-kernel launches each, a finite, non-black
   image, ms/frame and Mrays/s, and the collectives per frame and the
   bytes they leave on the rank; each frame against the unsharded frame
   from the same state (isclose 1e-3 on more than 99.9% of the values),
   the unsharded frames timed in the same call; then the dry run's four
   gates on one rank of the card (python -m
   dust_tpu_torch.parallel.dryrun --ranks 1 --device cuda);
19. bench_trace (dust_tpu_torch/tools/bench_trace.py, the port of
   tools/bench_trace.py) at 1920x1080: each of its five passes (primary,
   shadow, ao, fg, aofg) on the gi frame's real rays, 12 launches per
   timing, best of 3: the scene kernel's launches of each pass checked,
   a finite checksum and a hit rate in (0, 1], ms (host and device) and
   Mrays/s per pass, each pass's launch alone (CUDA-graph replay); the
   primary and aofg launches held against the plain version on 65,536 of
   their rays (torch.equal);
20. profile_stages at 1920x1080 (the hash frame, a 720x480 pool, 2^22
   slots): every stage's host and device ms, the stage names the
   reference's;
21. profile_frame: 8 gi frames under torch.profiler, the Chrome trace
   written and not empty, the kernel table printed, 6 launches a frame;
22. gen_ground_truth at 256x256 with the golden's counts (64 warm-up and
   512 accumulated frames), written into a temporary directory: the
   output's RMSE against tests/golden/castle_gt_256x256.npz below 0.01,
   the radiance's and albedo's RMSE and both exposures printed, and the
   seconds it took (a line of its own when over 60 s);
23. reservoirs: 2^20 updated three times, packed and unpacked on the card
   and on the CPU from one seed: counts, weights and direction words
   equal, LogLuv words equal on at least 99.99% and at most one
   log-luminance code apart;
24. the native scene build (dust_tpu_torch/native/voxcore.cpp, built with
   g++ from source, on the host): on every model of the castle + teapot
   and the stress scenes, build_leaves + FlatTree.from_dense_pools and
   the chebyshev skip field held equal to their plain numpy versions
   (every geometry field and the block pointers; the distances); then,
   native and plain in turns, best of 5, with the host's CPU model and
   core count: load_vox_scene of the castle, the editor's geometry
   rebuild of the castle after one voxel edit, the castle's skip field,
   and the isolated splice tier on the card with the share of it that the
   rebuild takes. Phase 17's edit tiers, which now run native, are
   printed beside them;
25. the primary stage's G-buffer kernels (dust_tpu_torch/csrc/gbuffer.cu:
   primary_rays_kernel, gbuffer_resolve_kernel) held against their plain
   versions on the card, field by field (torch.equal and every float's
   bits): the camera rays, then the G-buffer and sky_out of the precise
   trace of those rays, on an orbit frame of the castle + animated teapot
   at 1920x1080 and 3840x2160 (hits on both instances, misses), a
   1000x600 raster-order frame, the second quarter [lo, hi) of the 1080p
   rays (a rank's chunk of the sharded frame) and the stress frame (11
   instances); at both castle sizes each kernel's time (CUDA-graph
   replay) beside its bound (its bytes at the memory rate) and the plain
   version's host-issued time; and at both sizes one
   frame through the kernels and through the plain versions from one
   state: output, aux and new state equal;
26. the spatial hash's kernels (dust_tpu_torch/csrc/spatial_hash.cu:
   spatial_hash_probe_kernel and the insert's keys, scan_up, scan_blocks,
   scan and apply kernels) held against their plain versions on the card
   (torch.equal): the LogLuv codec on every 32-bit word and 2^24 colours;
   three rounds of the insert at the castle-hash cell's size (2^25 slots,
   345,600 keys with repeats, evictions, the 131,072 cap reached) and
   small inserts (partial scan blocks, no cap, every key valid); the
   working-set probe of the 1080p hash frame's table, every row and four
   rotating slices; then 4 hash frames at 1920x1080 with one launch of
   each kernel a frame, and one frame through the kernels and through the
   plain versions from one state (output, aux and new state, the table
   included, equal); each kernel's time (CUDA-graph replay) beside the
   floor of benchmark/hashwork.py;
27. the denoiser's kernels (dust_tpu_torch/csrc/denoise.cu:
   denoise_temporal_kernel, denoise_atrous_kernel) held against
   denoise_plain on the card, every bit of the denoised colour, the hit
   distance and the packed history, over two steps (a still camera from
   an empty history, then a moved one from that history): the 4K frame's
   half-resolution step (1920x1080, 3 passes), the 1080p frames'
   (960x540, 3 passes), the full-resolution 1080p step (4 passes), a
   256x128 step whose reprojected pixel centres land exactly on the
   image's edges or just past them, and the 960x540 step on 4 ranks'
   rows (threads sharing an all-gather) against the plain version's ranks
   and the whole image; 4 frames each at 1920x1080 and 3840x2160 with one
   temporal and three à-trous launches a frame, and one frame at each
   through the kernels and through the plain version from one state
   (output, aux and new state equal); at both half-resolution shapes each
   kernel's time (CUDA-graph replay) beside its floor (the bytes it
   counts a pixel at the memory rate) and the plain step's host-issued
   time; and phase 20's denoise figure again (profile_stages' post
   stage);
28. the final gather's kernels (dust_tpu_torch/csrc/gbuffer.cu:
   gather_dirs_kernel, gather_resolve_kernel) held against their plain
   versions (shade.gather_dirs_plain, shade.resolve_gather_plain) on the
   card, every output and every bit: on the arguments of a frame of the
   1920x1080 and 3840x2160 dense GI frames and of the 1920x1080 hash frame
   (the enqueue's face, count and leaf centre included), and of 256x128
   dense and hash frames under the debug view (debug_visualize_spatial_hash),
   each also with the enqueue's outputs the other way, with the debug view
   the other way, with each contribution_secondary_* flag off and both, on
   the second quarter of the rays (a rank's chunk) and in raster order;
   then on 16,384 made-up rays with every edge (primary misses, degenerate
   normals, leaf rows past a cell cap, empty rows, -0.0 radiance and
   direct light); 4 frames of each with one launch of each kernel a frame,
   and one frame through the kernels and through the plain versions from
   one state (output, aux and new state equal); at both dense sizes each
   kernel's time (CUDA-graph replay) beside its floor (the bytes it needs:
   a primary miss's and a hit's, and a final-gather hit's cache row, at
   the memory rate) and the plain version's host-issued time.

Every config is built and rendered through the bench module
(dust_tpu_torch/bench.py). Before the result it prints each scene-kernel
mode's time per launch at the stress frame's shapes with its share of the
bound, the kernels line {"kernels": [...]} and the card's name and power
limit.

Exits non-zero, with no result line, when there is no CUDA device or any
phase fails. The last line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""

import json
import os
import sys
import time

DEVICE = "cuda:0"
WIDTH, HEIGHT = 1920, 1080
FRAMES = 4
SUBSAMPLE = 65536
# H100 SXM peaks (NVIDIA's data sheet), for the bounds: device memory
# rate, and float32 outside the tensor cores.
MEM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Float operations of the scene kernel's set-up of one ray for one
# instance (affine, normalisation, reciprocals, box clip, range scaling;
# an FMA counts 2), which every ray does for every instance. The walk's
# own operations depend on the data and are not counted.
SETUP_FLOPS = 61
# bench.py --config hash-reference: the surfel pool.
HASH_POOL = 720 * 480
WIDTH_4K, HEIGHT_4K = 3840, 2160
STRESS_INSTANCES = 11
# Scene-kernel launches per frame, per mode: the GI frame, the frame
# without GI (primary-shadow) and the GI frame with precise sun shadows.
SCENE_LAUNCHES = {"precise": 1, "ao_fg": 1, "ao_threshold": 1, "rough": 3}
NO_GI_LAUNCHES = {"precise": 1, "ao_fg": 1, "ao_threshold": 0, "rough": 0}
PRECISE_LAUNCHES = {"precise": 2, "ao_fg": 0, "ao_threshold": 1, "rough": 3}
NO_LAUNCHES = {"precise": 0, "ao_fg": 0, "ao_threshold": 0, "rough": 0}
# The G-buffer kernels' launches per frame (csrc/gbuffer.cu).
GBUFFER_LAUNCHES = {"primary_rays": 1, "gbuffer_resolve": 1}
# The ray-sharded GI frame: reference-mode sun shadows take two launches
# (ao_threshold, rough) in place of the fused ao_fg.
SHARDED_LAUNCHES = {"precise": 1, "ao_fg": 0, "ao_threshold": 2, "rough": 4}
# The eager backend: a 1080p frame over this many seconds is cut to
# 960x540; the lane-retirement intervals it is timed at.
EAGER_MAX_S = 10.0
SYNC_CHOICES = (1, 4, 8, 16, 32, 256, 32, 16, 8, 4)
# tests/test_quality.py's converged-ground-truth gates: the bounds and
# the frame counts (the camera, hash and pool are the port's copy of
# tests/quality_setup.py, dust_tpu_torch/tools/quality_setup.py).
GT_PATH = os.path.join("tests", "golden", "castle_gt_256x256.npz")
RMSE_DENOISED = 0.045
HALF_RES_EXTRA = 0.017
RMSE_HALF_CONVERGED = 0.055
RMSE_DENSE = 0.045
RMSE_HASH = 0.045
GT_FRAMES, GT_CONV_FRAMES, GT_CONV_AVG = 16, 32, 16
REPLACES = "dust_tpu/ops/pallas_trace.py:"
# The edits phase: frames per interleaved run (bench_edits' --edits), and
# edits per isolated tier.
EDIT_FRAMES = 10
ISOLATED_EDITS = 5
# The reference's tools on the card: bench_trace's launches per timing;
# tools/profile_stages.py's stage names, in its order ({p}: the pool);
# gen_ground_truth's warm-up frames (its default; the accumulated frames
# are the golden's own count) and its bound on the output's RMSE against
# the golden; the reservoirs packed on the card and on the CPU.
BENCH_TRACE_REPS = 12
STAGE_NAMES = (
    "primary trace (precise)", "resolve_hits", "shadow trace (precise)",
    "AO trace (ao_threshold)", "FG trace (rough)", "leaf_attributes (2M)",
    "hash_get (2M)", "pool_enqueue_mod (2M->pool)",
    "surfel trace (rough, {p})", "hash_get ({p})", "hash_insert ({p})",
    "denoise", "exposure histogram", "tonemap", "FULL FRAME")
PROFILE_FRAMES = 8
GT_WARMUP = 64
RMSE_GOLDEN = 0.01
GT_SLOW_S = 60.0
RESERVOIRS = 1 << 20
# The native scene build: timings in turns, best of this many each.
NATIVE_REPS = 5
# The G-buffer resolve's reads a ray: the trace result (t, inst, row,
# bit), the ray (origin, direction) and the 32-byte sector of its voxel
# word; its writes are the G-buffer's own bytes.
GBUFFER_READ_BYTES = 16 + 24 + 32
# The hash's kernels (csrc/spatial_hash.cu, phase 26): the castle-hash
# cell's table and insert cap, and the kernels a hash frame launches once
# each.
HASH_CAPACITY = 1 << 25
HASH_INSERT_CAP = 1 << 17
HASH_KERNELS = ("probe", "keys", "scan_up", "scan_blocks", "scan", "apply")
# The denoiser's kernels (csrc/denoise.cu, phase 27): the bytes each
# counts a pixel (the source's header: the temporal step's inputs, its
# share of the history and its outputs; a pass's own pixel read and its
# colour written; the last pass's radiance read and output written in
# its place), and the launches of a frame's half-resolution step.
DENOISE_TEMPORAL_BYTES = 124
DENOISE_PASS_BYTES = 40 + 16
DENOISE_LAST_PASS_BYTES = 40 + 12 + 12
DENOISE_LAUNCHES = {"denoise_temporal": 1, "denoise_atrous": 3}
# The final gather's kernels (csrc/gbuffer.cu, phase 28): the bytes each
# needs (the source's header) for a primary miss and a primary hit, the
# 32-byte sector of a final-gather hit's cache row, and the launches of a
# GI frame. The directions: the hit and the outputs, and a hit's normal
# (the noise layer stays in cache). The resolve: the hit and the outputs,
# a miss's sky_out, a hit's two trace results, ray and direct.
GATHER_DIRS_BYTES = dict(miss=1 + 16, hit=1 + 16 + 12)
GATHER_RESOLVE_BYTES = dict(miss=1 + 28 + 12, hit=1 + 28 + 20 + 24 + 12)
GATHER_ROW_BYTES = 32
GATHER_LAUNCHES = {"gather_dirs": 1, "gather_resolve": 1}


def _setup(device, width, height, config="gi", capacity=None, pool=None,
           tile=None, **changes):
    """Scene, camera and state of bench.py's ``config`` as the port's
    bench module builds them (dust_tpu_torch/bench.py), on the HDDA
    kernel's backend unless ``changes`` say otherwise; ``capacity`` and
    ``pool`` resize the hash and the surfel pool, ``tile`` is the eager
    backend's rays per walk, ``changes`` replace RenderSettings fields."""
    import dataclasses

    from dust_tpu_torch import bench

    argv = ["--config", config, "--width", str(width), "--height",
            str(height), "--device", str(device), "--backend", "pallas"]
    if tile:
        argv += ["--tile", str(tile)]
    args = bench.parse_args(argv)
    settings = bench.settings_for(args)
    if capacity:
        changes["spatial_hash"] = dataclasses.replace(settings.spatial_hash,
                                                      capacity=capacity)
    if pool:
        changes["surfels"] = dataclasses.replace(settings.surfels,
                                                 pool_size=pool)
    settings = dataclasses.replace(settings, **changes)
    return bench.setup(args, device, settings)


def _render(ctx, f, state, return_aux=False):
    """Frame ``f`` (animated teapot; on flythrough the camera moves) from
    ``state`` through the bench module: (output, new state), or (output,
    aux, new state) with ``return_aux``."""
    from dust_tpu_torch import bench

    out, aux, state = bench.render(ctx, state, f, return_aux=return_aux)
    return (out, aux, state) if return_aux else (out, state)


def _frames(ctx, count, first=0):
    """Render ``count`` frames carrying ctx's state; returns the last
    output."""
    out = None
    for f in range(first, first + count):
        out, ctx["state"] = _render(ctx, f, ctx["state"])
    return out


def _timed_frames(ctx, count, first, render=None):
    """``count`` synchronised frames: (last output, seconds per frame).
    ``render``: renders one frame (and returns its output) in place of
    ctx's next bench frame."""
    import torch

    times, out = [], None
    for f in range(first, first + count):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _frames(ctx, 1, first=f) if render is None else render()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def _check_launches(counts, per_frame, frames, what):
    print(f"{what} launches over {frames} frames: {counts}")
    for m, k in per_frame.items():
        if counts[m] != k * frames:
            raise SystemExit(f"{what} {m}: {counts[m]} launches, expected "
                             f"{k * frames}")


def _report_frame(label, ctx, out, times, card):
    """Checks a finite, non-black (H, W, 3) image and prints ms/frame
    (frames 2 on) and Mrays/s with bench.py's ray accounting."""
    import torch
    from dust_tpu_torch.render.pipeline import frame_ray_count

    img = out.float()
    h, w = ctx["settings"].height, ctx["settings"].width
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise SystemExit(f"{label}: output is not a finite (H, W, 3) image")
    mean = float(img.mean())
    if mean < 0.02:
        raise SystemExit(f"{label}: output is black (mean {mean:.4f})")
    rays = frame_ray_count(ctx["scene"], ctx["settings"])
    steady = times[1:]
    ms_frame = 1e3 * sum(steady) / len(steady)
    print(f"frame {w}x{h} {label}: {ms_frame:.2f} ms/frame (frames "
          f"2-{len(times)}; all: {', '.join(f'{1e3 * t:.1f}' for t in times)}"
          f" ms), {rays / 1e6:.3f} Mrays/frame, "
          f"{rays / (ms_frame * 1e3):.1f} Mrays/s, mean {mean:.4f} [{card}]")


def _ms(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls issued from the host
    after one warm-up call (CUDA events)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, min_ms=20.0):
    """Mean ms per launch of ``fn`` replayed from a CUDA graph, so that the
    launches run back to back on the card without the wrapper's host time
    (some 50-80 us a call, more than a short launch) between them. The
    replays run for about ``min_ms`` before the timed ones, as many, so
    that the clocks have left idle."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    once = _ms(graph.replay, 1)
    reps = max(10, int(min_ms / max(once, 1e-3)))
    for _ in range(reps):
        graph.replay()
    return _ms(graph.replay, reps)


def _subsample(args, n_keep, tables, seed=0):
    """``n_keep`` rays of a recorded launch whose arguments past the
    first ``tables`` are per ray (lo and hi bound at 2 and 3 of those),
    active rays first (seeded)."""
    import numpy as np
    import torch

    rays = list(args[tables:])
    lo, hi = rays[2], rays[3]
    active = torch.nonzero(hi >= lo).flatten().cpu().numpy()
    rest = np.setdiff1d(np.arange(lo.shape[0]), active)
    rng = np.random.default_rng(seed)
    pick = rng.permutation(active)[:n_keep]
    if len(pick) < n_keep:
        pick = np.concatenate([pick, rng.permutation(rest)[:n_keep - len(pick)]])
    idx = torch.as_tensor(np.sort(pick), device=lo.device)
    return args[:tables] + tuple(None if r is None else r[idx].contiguous()
                                 for r in rays)


def _compare(out_k, out_p):
    """Agreement of kernel and plain outputs, (agreement, max |dt|): a
    ray agrees when every integer output is equal and every float output
    is finite in both or in neither; max |dt| over rays finite in both."""
    import torch

    ok = torch.ones_like(out_k[0], dtype=torch.bool)
    err = 0.0
    for a, b in zip(out_k, out_p):
        if a.dtype.is_floating_point:
            ok &= torch.isfinite(a) == torch.isfinite(b)
            both = torch.isfinite(a) & torch.isfinite(b)
            if both.any():
                err = max(err, float((a[both] - b[both]).abs().max()))
        else:
            ok &= a == b
    return float(ok.float().mean()), err


def _bound(tensors, flops):
    """The least time a launch could take on the card, (ms, "bytes" or
    "operations"): the larger of every input read once and every output
    written once at the memory rate, and ``flops`` at the float32 rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    by_bytes = 1e3 * nbytes / MEM_BYTES_PER_S
    by_ops = 1e3 * flops / F32_FLOPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _instance_bytes(args, mode):
    """What one single-instance launch must move, (bytes, active rays),
    ray by ray: a ray with s_min >= s_stop is inactive whatever else it
    holds (the walk starts at s >= s_min and ends at s_stop), so it reads
    s_min and s_stop and writes the three miss outputs; an active ray
    (NaN bounds included) also reads its origin and direction, and in
    ao_fg its s_ao. The table words a walk reads depend on its path and
    are not counted (at most 0.31 MB for the castle). ``args``: the
    wrapper's (l1, l2, mask, origin, direction, s_min, s_stop, s_ao)."""
    s_min, s_stop = args[5], args[6]
    active = int((~(s_min >= s_stop)).sum())
    per_active = 24 + (4 if mode == "ao_fg" else 0)
    return s_min.shape[0] * (8 + 12) + active * per_active, active


def _instance_bound(args, mode):
    """The least time of a single-instance launch, (ms, "bytes"): its
    :func:`_instance_bytes` at the memory rate. The walk's float
    operations depend on the data and are not counted."""
    return 1e3 * _instance_bytes(args, mode)[0] / MEM_BYTES_PER_S, "bytes"


def _hold(label, run, run_plain, full, tables, flops, plain_timed=True,
          timed=True, sample=SUBSAMPLE, bound=None):
    """Kernel against plain version on ``sample`` rays of the recorded
    launch ``full`` (all of them if None): every output must be equal
    (torch.equal). Then, with ``timed``, the kernel is timed on the full
    launch, replayed from a CUDA graph (and, with ``plain_timed``, the
    plain version from the host); its bound is ``bound(full)``, or the
    bytes of every input and output with ``flops`` float operations.
    Returns a dict: max |dt|, and with ``timed`` kernel ms, plain ms (or
    None), bound ms and what bounds it."""
    import torch

    sub = full if sample is None else _subsample(full, sample, tables)
    out_k = run(sub)
    out_p = run_plain(sub)
    agree, err = _compare(out_k, out_p)
    equal = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    print(f"{label:28s} kernel vs plain on {out_k[0].shape[0]} rays: "
          f"agreement {agree:.6f} ({int(torch.isfinite(out_k[0]).sum())} "
          f"finite t), max |dt| {err:.3g}, equal {equal}")
    if not equal:
        raise SystemExit(f"{label}: kernel and plain differ "
                         f"(agreement {agree:.4%}, max |dt| {err:.3g})")
    if not timed:
        return dict(err=err)
    bound, bound_by = (_bound(full + run(full), flops) if bound is None
                       else bound(full))
    ms = _kernel_ms(lambda: run(full))
    plain_ms = _ms(lambda: run_plain(full), 1) if plain_timed else None
    print(f"{label:28s} full launch ({full[tables].shape[0]} rays): kernel "
          f"{ms:.3f} ms"
          + ("" if plain_ms is None else f", plain {plain_ms:.1f} ms")
          + f", bound {bound:.4f} ms ({bound_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by)


def _recording(module, name, on_call, render):
    """Calls ``render()`` with ``module.name`` wrapped so that
    ``on_call(args, kwargs)`` sees every launch; returns what it
    returns."""
    launch = getattr(module, name)

    def record(*args, **kw):
        on_call(args, kw)
        return launch(*args, **kw)

    setattr(module, name, record)
    try:
        return render()
    finally:
        setattr(module, name, launch)


def _recorded_frame(ctx, f, module, name, on_call):
    """Renders frame ``f`` (carrying ctx's state) with ``module.name``
    wrapped so that ``on_call(args, kwargs)`` sees every launch."""
    out, ctx["state"] = _recording(module, name, on_call,
                                   lambda: _render(ctx, f, ctx["state"]))
    return out


def _hold_scene_kernel(hdda, ctx, f, label, plain_timed, render=None,
                       timed=True):
    """The scene kernel against its plain version on frame ``f``'s real
    rays, and (with ``timed``) its time: the first launch of each mode.
    ``render``: a function that renders the frame instead of frame ``f``
    of ctx. Returns {mode: _hold's dict}."""
    import torch

    first = {}

    def keep(a, kw):
        first.setdefault(kw["mode"], a + (kw.get("t_ao"),))

    if render is None:
        _recorded_frame(ctx, f, hdda, "hdda", keep)
    else:
        _recording(hdda, "hdda", keep, render)
    torch.cuda.synchronize()
    held = {}
    for mode in hdda.MODES:
        full = first[mode]

        def run(a, m=mode):
            return hdda.hdda(*a[:11], t_ao=a[11], mode=m)

        def run_plain(a, m=mode):
            return hdda.hdda_plain(*a[:12], mode=m)

        flops = SETUP_FLOPS * full[7].shape[0] * full[3].shape[0]
        held[mode] = _hold(f"{label} {mode}", run, run_plain, full, 7, flops,
                           plain_timed, timed)
    return held


def _record_instance_launches(into):
    """A recorder for ``hdda_instance``: appends (mode, the wrapper's 8
    arguments) of every launch to ``into``."""
    return lambda a, kw: into.append((kw["mode"],
                                      a + (None,) * (8 - len(a))))


def _instance_edges(full):
    """The edge launches of a recorded single-instance launch: no ray
    active (s_stop = s_min, origins NaN, which no inactive ray may read),
    every ray active (its active rays alone), and a ragged count (SUBSAMPLE
    + 37 rays, a multiple of no block size)."""
    import torch

    tables, (o, d, s_min, s_stop, s_ao) = full[:3], full[3:]
    act = torch.nonzero(~(s_min >= s_stop)).flatten()
    return {
        "no ray active": tables + (torch.full_like(o, float("nan")), d, s_min,
                                   s_min.clone(), s_ao),
        "every ray active": tables + tuple(
            None if x is None else x[act].contiguous() for x in full[3:]),
        "ragged count": _subsample(full, SUBSAMPLE + 37, 3),
    }


def _hold_instance(hdda, label, mode, full, timed=True, edges=False):
    """The single-instance kernel against its plain version on the whole
    recorded launch ``full`` (torch.equal), and with ``edges`` on its
    :func:`_instance_edges`; with ``timed``, timed against its bound
    (:func:`_instance_bound`). Returns _hold's dict."""
    def run(a):
        return hdda.hdda_instance(*a[:8], mode=mode)

    def run_plain(a):
        return hdda.hdda_instance_plain(*a[:8], mode)

    h = _hold(f"{label} {mode}", run, run_plain, full, 3, 0, timed=timed,
              sample=None, bound=lambda a: _instance_bound(a, mode))
    if edges:
        for what, a in _instance_edges(full).items():
            _hold(f"{label} {mode}, {what}", run, run_plain, a, 3, 0,
                  timed=False, sample=None)
    return h


def _instance_frame_ms(hdda, recs, label, card):
    """Each mode's single-instance device time over one loop frame: every
    launch in ``recs`` (mode, args) timed from a CUDA-graph replay, summed,
    beside the summed bounds. Launches over 10x their mode's median are
    listed apart (the creeping ray's). Returns {mode: dict}."""
    times = {}
    for mode, a in recs:
        ms = _kernel_ms(lambda: hdda.hdda_instance(*a[:8], mode=mode))
        times.setdefault(mode, []).append((ms, _instance_bound(a, mode)[0]))
    out = {}
    for mode, rows in times.items():
        ms = sorted(r[0] for r in rows)
        slow = [m for m in ms if m > 10.0 * ms[len(ms) // 2]]
        total, bound = sum(ms), sum(r[1] for r in rows)
        out[mode] = dict(launches=len(rows), ms=total, bound_ms=bound,
                         slow_ms=slow)
        print(f"{label} hdda_instance<{mode}>: {len(rows)} launches, "
              f"{total:.4f} ms of device time a frame against a bound of "
              f"{bound:.4f} ms ({100.0 * bound / total:.1f}%)"
              + (f"; {len(slow)} over 10x the median (the creeping ray: "
                 f"{', '.join(f'{m:.3f}' for m in slow)} ms), the rest "
                 f"{total - sum(slow):.4f} ms" if slow else "")
              + f" [{card}]")
    return out


def _occupied(state) -> int:
    """Hash slots holding a key (non-zero fingerprint)."""
    return int((state.gi.table.view(-1, 4)[:, 0] != 0).sum())


def _profile_frame(ctx, f, render=None):
    """One frame under torch.profiler (frame ``f`` of ctx, or what
    ``render()`` renders): (CUDA kernels, memory copies and sets, host
    syncs, device ms, wall ms, [(device ms, launches, name)] of the
    kernels that took the most device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _frames(ctx, 1, first=f) if render is None else render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = copies = syncs = 0
    device_us = 0.0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
            device_us += e.device_time_total
            us, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.device_time_total, count + 1)
        elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize"):
            syncs += 1
    top = sorted(((us / 1e3, count, name) for name, (us, count)
                  in by_name.items()), reverse=True)[:10]
    # The frame's own closing torch.cuda.synchronize() is not the frame's.
    return kernels, copies, syncs - 1, device_us / 1e3, 1e3 * wall, top


def _print_profile(label, ctx, f, card, render=None):
    """Profiles frame ``f`` (_profile_frame), prints what it found and
    returns the number of host syncs."""
    kernels, copies, syncs, dev_ms, wall_ms, top = _profile_frame(ctx, f,
                                                                  render)
    print(f"{label} frame {f} under torch.profiler: {kernels} CUDA kernels, "
          f"{copies} copies/sets, {syncs} host syncs, {dev_ms:.2f} ms device "
          f"time in {wall_ms:.2f} ms ({100.0 * dev_ms / wall_ms:.1f}% busy) "
          f"[{card}]")
    for ms_k, count, name in top:
        print(f"  {ms_k:8.3f} ms in {count:5d} launches: {name[:90]}")
    return syncs


def _hash_tables_agree(a, b):
    """Share of the slots occupied in either table whose fingerprint,
    last frame and sample count are equal."""
    a = a.gi.table.cpu().view(-1, 4)
    b = b.gi.table.cpu().view(-1, 4)
    occ = (a[:, 0] != 0) | (b[:, 0] != 0)
    same = ((a[:, 0] == b[:, 0]) & (a[:, 2] == b[:, 2])
            & (a[:, 3] == b[:, 3]))
    return float(same[occ].float().mean()), int(occ.sum())


def _hash_phase(hdda, dev, card, reset_counts, rmse):
    """Phases 9 and 10: the hash-reference frame on the card, its pool
    launches held and timed, and the small hash frame on card and CPU.
    Returns (launches per mode over the 4 frames, {"sun"|"cosine": the
    pool launch's _hold dict with its active rays})."""
    import torch

    # ---- 9. the spatial-hash frame (hash-reference) ------------------
    hashed = _setup(dev, WIDTH, HEIGHT, "hash-reference")
    reset_counts()
    _out, times = _timed_frames(hashed, 1, first=0)
    occ1 = _occupied(hashed["state"])
    out, more = _timed_frames(hashed, FRAMES - 1, first=1)
    occ4 = _occupied(hashed["state"])
    _check_launches(hdda.LAUNCHES, SCENE_LAUNCHES, FRAMES, "hdda_scene")
    hash_launches = dict(hdda.LAUNCHES)
    _report_frame("castle+teapot hash-reference", hashed, out, times + more,
                  card)
    print(f"hash-reference table: {occ1} occupied slots after frame 1, "
          f"{occ4} after frame {FRAMES} of {hashed['state'].gi.capacity}")
    if not 0 < occ1 < occ4:
        raise SystemExit(f"hash table does not fill: {occ1} then {occ4}")
    _print_profile("hash-reference", hashed, FRAMES, card)
    # The surfel pass's rough launches (sun, then cosine) of a frame with
    # a filled pool: the pool's rays.
    pool_launches = []
    _recorded_frame(hashed, FRAMES + 1, hdda, "hdda", lambda a, kw: (
        kw["mode"] == "rough" and a[7].shape[0] == HASH_POOL
        and pool_launches.append(a + (None,))))
    torch.cuda.synchronize()
    if len(pool_launches) != 2:
        raise SystemExit(f"hash frame: {len(pool_launches)} pool-sized rough "
                         "launches, expected 2")
    pool_held = {}
    for what, full in zip(("sun", "cosine"), pool_launches):
        live = int((full[10] >= full[9]).sum())
        flops = SETUP_FLOPS * full[7].shape[0] * full[3].shape[0]
        pool_held[what] = _hold(
            f"hash pool {what} rough", lambda a: hdda.hdda(*a[:11],
                                                           mode="rough"),
            lambda a: hdda.hdda_plain(*a[:12], mode="rough"), full, 7, flops)
        pool_held[what]["active_rays"] = live
        h = pool_held[what]
        print(f"hash pool {what} rough: {live} of {HASH_POOL} rays active; "
              f"{h['ms']:.4f} ms per launch, bound {h['bound_ms']:.4f} ms "
              f"({h['bound_by']}), {100.0 * h['bound_ms'] / h['ms']:.2f}% of "
              f"the bound [{card}]")
    # The hash layer's own time: one call each of the working-set probe
    # and the insert, recorded from a frame and issued again from the host.
    from dust_tpu_torch.ops import spatial_hash
    from dust_tpu_torch.render import pipeline
    layer_ms = {}
    for f, (module, name) in enumerate(((pipeline, "_working_set"),
                                        (spatial_hash, "hash_insert"))):
        call = []
        _recorded_frame(hashed, FRAMES + 2 + f, module, name,
                        lambda a, kw: call.append((a, kw)))
        fn = getattr(module, name)
        layer_ms[name] = _ms(lambda: fn(*call[0][0], **call[0][1]), 5)
    print(f"hash layer at {WIDTH}x{HEIGHT}: working set "
          f"{layer_ms['_working_set']:.2f} ms, insert "
          f"{layer_ms['hash_insert']:.2f} ms per call (CUDA events around 5 "
          f"host-issued calls) [{card}]")
    del hashed, out, pool_launches

    # ---- 10. the hash frame small, on the card and on the CPU ---------
    small = [_setup(d, 256, 144, "hash-reference", capacity=1 << 16,
                    pool=4096) for d in (dev, torch.device("cpu"))]
    imgs = [_frames(c, 2) for c in small]
    err = rmse(imgs[0], imgs[1])
    share, occ = _hash_tables_agree(small[0]["state"], small[1]["state"])
    print(f"256x144 hash, 2 frames: card vs CPU plain RMSE {err:.5f}; "
          f"tables agree on {share:.4%} of {occ} occupied slots")
    if not err < 0.01:
        raise SystemExit(f"card and CPU hash frames differ: RMSE {err:.5f}")
    if not (occ > 0 and share >= 0.99):
        raise SystemExit(f"card and CPU hash tables differ: {share:.4%} of "
                         f"{occ} occupied slots agree")

    return hash_launches, pool_held


def _config_phase(hdda, dev, card, reset_counts, label, config, width,
                  height, per_frame, frames=FRAMES, **changes):
    """``frames`` frames of a config (with ``changes`` to its settings) on
    the card, from a fresh state, through the bench module: the launch
    counts of those frames checked against ``per_frame``, a finite
    non-black image, ms/frame and Mrays/s. Returns (ctx, launches per
    mode)."""
    ctx = _setup(dev, width, height, config, **changes)
    reset_counts()
    out, times = _timed_frames(ctx, frames, first=0)
    _check_launches(hdda.LAUNCHES, per_frame, frames, f"{label} hdda_scene")
    launches = dict(hdda.LAUNCHES)
    _report_frame(label, ctx, out, times, card)
    return ctx, launches


def _card_vs_cpu(dev, rmse, label, **changes):
    """A 256x144 gi frame with ``changes`` to its settings on the card and
    on the CPU (plain versions), 2 frames: RMSE < 0.01."""
    import torch

    imgs = [_frames(_setup(d, 256, 144, **changes), 2)
            for d in (dev, torch.device("cpu"))]
    err = rmse(imgs[0], imgs[1])
    print(f"256x144 {label}, 2 frames: card vs CPU plain RMSE {err:.5f}")
    if not err < 0.01:
        raise SystemExit(f"card and CPU frames differ ({label}): RMSE "
                         f"{err:.5f}")


def _scene_on(scene, device):
    """The scene's tensors moved to ``device``."""
    import dataclasses

    import torch

    return dataclasses.replace(scene, **{
        f.name: getattr(scene, f.name).to(device)
        for f in dataclasses.fields(scene)
        if isinstance(getattr(scene, f.name), torch.Tensor)})


def _eager_phase(hdda, dev, card, reset_counts, rmse):
    """Phase 15: the gi frame on the eager backend (traversal_backend=
    "jnp", torch ops, no kernel). Returns {"ms": ms/frame, "size": (w, h),
    "sync_ms": {interval: ms}}."""
    import dataclasses

    import numpy as np
    import torch
    from dust_tpu_torch.ops import traverse

    w, h = WIDTH, HEIGHT
    eager = _setup(dev, w, h, tile=w * h, traversal_backend="jnp")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _frames(eager, 1, first=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    print(f"eager gi frame 0 at {w}x{h}: {first_s:.2f} s")
    if first_s > EAGER_MAX_S:
        w, h = 960, 540
        print(f"eager backend: a {WIDTH}x{HEIGHT} frame took {first_s:.1f} s "
              f"(over {EAGER_MAX_S:.0f} s), so the eager phase is cut to "
              f"{w}x{h}")
        eager = _setup(dev, w, h, tile=w * h, traversal_backend="jnp")
        _frames(eager, 1, first=0)
    # The lane-retirement interval, one frame each from the same state.
    sync_ms = {}
    chosen = traverse.SYNC_EVERY
    try:
        for k in SYNC_CHOICES:
            traverse.SYNC_EVERY = k
            state = eager["state"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _render(eager, 1, state)
            torch.cuda.synchronize()
            sync_ms.setdefault(k, []).append(1e3 * (time.perf_counter() - t0))
    finally:
        traverse.SYNC_EVERY = chosen
    print(f"eager gi {w}x{h}, ms of one frame (from one state) by the "
          f"iterations between host syncs, in the order run "
          f"{list(SYNC_CHOICES)}: "
          + ", ".join(f"{k}: {'/'.join(f'{t:.1f}' for t in v)}"
                      for k, v in sync_ms.items())
          + f"; in use: {chosen} [{card}]")
    reset_counts()
    out, times = _timed_frames(eager, FRAMES, first=1)
    _check_launches(hdda.LAUNCHES, NO_LAUNCHES, FRAMES, "eager hdda_scene")
    _report_frame(f"gi, eager backend", eager, out, times, card)
    steady = times[1:]
    ms = 1e3 * sum(steady) / len(steady)

    # Against the kernel's backend: one frame from one state.
    f = 1 + FRAMES
    pallas = dict(eager, settings=dataclasses.replace(
        eager["settings"], traversal_backend="pallas"))
    img_e, aux_e, _ = _render(eager, f, eager["state"], return_aux=True)
    img_p, aux_p, _ = _render(pallas, f, eager["state"], return_aux=True)
    err = rmse(img_e, img_p)
    hits = float((torch.isfinite(aux_e["depth"])
                  == torch.isfinite(aux_p["depth"])).float().mean())
    print(f"eager vs kernel backend, frame {f} at {w}x{h}: RMSE {err:.5f}, "
          f"hit masks agree on {hits:.4%}")
    if not (err < 0.01 and hits >= 0.995):
        raise SystemExit(f"eager and kernel backends differ: RMSE {err:.5f}, "
                         f"hit masks {hits:.4%}")

    # The eager traversal on the card against the same on the CPU.
    first = {}
    _recorded_frame(eager, f + 1, traverse, "trace_scene_tiled",
                    lambda a, kw: first.setdefault(kw["mode"], a))
    rng = np.random.default_rng(0)
    for mode, (scene, o, d, tn, tx) in sorted(first.items()):
        scene_cpu = _scene_on(scene, "cpu")
        n = o.shape[0]
        tn, tx = (torch.broadcast_to(torch.as_tensor(
            t, dtype=torch.float32, device=o.device), (n,)) for t in (tn, tx))
        live = torch.nonzero(tx >= tn).flatten().cpu().numpy()
        idx = np.sort(rng.permutation(live)[:SUBSAMPLE])
        pick = torch.as_tensor(idx, device=o.device)
        rays = [x[pick].contiguous() for x in (o, d, tn, tx)]
        card_res = traverse.trace_scene(scene, *rays, mode=mode)
        cpu_res = traverse.trace_scene(scene_cpu, *(x.cpu() for x in rays),
                                       mode=mode)
        differ = torch.zeros(len(idx), dtype=torch.bool)
        for a, b in zip(card_res[1:], cpu_res[1:]):
            differ |= a.cpu() != b
        fin = torch.isfinite(cpu_res.t)
        dt = float((card_res.t.cpu()[fin] - cpu_res.t[fin]).abs().max()) \
            if bool(fin.any()) else 0.0
        print(f"eager {mode} on {len(idx)} rays, card vs CPU: "
              f"{int(differ.sum())} rays with another (inst, row, bit), "
              f"{int(fin.sum())} hits, max |dt| {dt:.3g}")
        if int(differ.sum()):
            raise SystemExit(f"eager {mode}: card and CPU traversals differ "
                             f"on {int(differ.sum())} rays")
    return dict(ms=ms, size=(w, h), sync_ms=sync_ms)


def _gates(dev, here, card):
    """Phase 16: tests/test_quality.py's converged-ground-truth gates on
    the card, on the HDDA kernel's backend."""
    import numpy as np
    import torch
    from dust_tpu_torch.config import DenoiserSettings
    from dust_tpu_torch.ops import tonemap as tonemaplib
    from dust_tpu_torch.ops.noise import load_blue_noise
    from dust_tpu_torch.ops.sky import bake_sky
    from dust_tpu_torch.render.pipeline import make_frame_state, render_frame
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.tools import quality_setup
    from dust_tpu_torch.tools.rmse import rmse as err
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    gt = np.load(os.path.join(here, GT_PATH))
    W, H = int(gt["width"]), int(gt["height"])
    vox = load_vox_scene(procgen.castle_scene_bytes())
    procgen.add_teapot(vox)
    scene = build_device_scene(vox, dev)
    bn = load_blue_noise(dev)
    exposure = torch.tensor(float(gt["exposure"]), device=dev)

    def run(frames, avg_last=0, **overrides):
        """The final frame tonemapped at the ground truth's exposure, and
        with ``avg_last`` the mean of the last frames too."""
        s = quality_setup.gt_settings(W, H, backend="pallas", **overrides)
        cam = quality_setup.gt_camera(s, W, H, dev)
        sky = bake_sky(s.sunlight, dev)
        state = make_frame_state(s, scene, dev)
        acc, cnt = 0.0, 0
        for f in range(frames):
            _out, aux, state = render_frame(scene, state, cam, sky,
                                            bn.unitvec3_cosine, bn.scalar, s)
            img = tonemaplib.tonemap(aux["denoised"], aux["albedo"], exposure,
                                     "srgb").cpu().numpy()
            if avg_last and f >= frames - avg_last:
                acc, cnt = acc + img, cnt + 1
        return (img, acc / cnt) if avg_last else img

    t0 = time.perf_counter()
    dense = run(GT_CONV_FRAMES, GT_CONV_AVG)
    split = run(GT_CONV_FRAMES, GT_CONV_AVG, denoiser=DenoiserSettings(
        half_res_indirect=False, split_direct=True))
    lumped = run(GT_FRAMES, denoiser=DenoiserSettings(half_res_indirect=False))
    hashed = run(GT_FRAMES, gi_cache="hash")
    r_half, r_split = err(dense[0], gt["output"]), err(split[0], gt["output"])
    gates = [
        (f"denoised ({GT_CONV_FRAMES} frames)", r_half, RMSE_DENOISED),
        ("half-res extra over full-res split", r_half - r_split,
         HALF_RES_EXTRA),
        (f"converged half-res bias (last {GT_CONV_AVG} of {GT_CONV_FRAMES} "
         "frames averaged)", err(dense[1], split[1]), RMSE_HALF_CONVERGED),
        (f"full-res lumped ({GT_FRAMES} frames)", err(lumped, gt["output"]),
         RMSE_DENOISED),
        ("dense", r_half, RMSE_DENSE),
        (f"hash ({GT_FRAMES} frames)", err(hashed, gt["output"]), RMSE_HASH),
    ]
    print(f"converged-ground-truth gates at {W}x{H} (tests/test_quality.py's "
          f"bounds; full-res split {r_split:.4f}) in "
          f"{time.perf_counter() - t0:.1f} s [{card}]:")
    failed = []
    for name, value, bound in gates:
        ok = value < bound
        print(f"  {name}: RMSE {value:.4f} (bound {bound}) "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(name)
    if failed:
        raise SystemExit(f"ground-truth gates failed: {failed}")
    return {name: value for name, value, _ in gates}


def _scenes_equal(label, card, cpu):
    """Every tensor of the card's DeviceScene torch.equal to the CPU's,
    and the same static tables."""
    import dataclasses

    import torch

    for f in dataclasses.fields(cpu):
        a, b = getattr(card, f.name), getattr(cpu, f.name)
        same = (torch.equal(a.cpu(), b) if isinstance(b, torch.Tensor)
                else a == b)
        if not same:
            raise SystemExit(f"{label}: the card's scene and the CPU "
                             f"editor's differ in {f.name}")


def _edit_tier(hdda, label, ctx, cpu_ed, done, mode, frames, launches):
    """Checks after an edit tier: the editor's last tier, 6 scene-kernel
    launches per frame rendered, the card's scene equal to the CPU
    editor's given the same edits (from ``done`` on, each followed by a
    refit), the dense GI table's albedo words equal to a fresh cache of
    the edited scene, and the scene kernel equal to its plain version on
    a frame's real rays of every mode. Returns the number of edits
    replayed so far."""
    import torch
    from dust_tpu_torch import bench_edits
    from dust_tpu_torch.ops import gi_cache as gilib

    if ctx["editor"].last_refit_mode != mode:
        raise SystemExit(f"{label}: the last refit took the "
                         f"{ctx['editor'].last_refit_mode} tier, not {mode}")
    _check_launches(hdda.LAUNCHES, SCENE_LAUNCHES, frames,
                    f"{label} hdda_scene")
    launches[label] = dict(hdda.LAUNCHES)
    for model, coords, idx in ctx["edits"][done:]:
        cpu_ed.set_voxels(model, coords, idx)
        cpu_ed.refit()
    if cpu_ed.last_refit_mode != mode:
        raise SystemExit(f"{label}: the CPU editor took the "
                         f"{cpu_ed.last_refit_mode} tier")
    _scenes_equal(label, ctx["scene"], cpu_ed.device)
    fresh = gilib.make_dense_gi_cache(ctx["scene"]).table[:, 2]
    if not torch.equal(ctx["state"].gi.table[:, 2], fresh):
        raise SystemExit(f"{label}: the dense GI albedo words are stale")
    print(f"{label}: tier {mode}, {len(ctx['edits'])} edits; scene equal to "
          f"the CPU editor's, GI albedo words equal to a fresh cache")
    _hold_scene_kernel(hdda, ctx, 0, f"{label} hdda_scene", False,
                       render=lambda: bench_edits.render(ctx), timed=False)
    return len(ctx["edits"])


def _edits_phase(hdda, dev, card, reset_counts, rmse):
    """Phase 17: edits and refit with the GI frame re-rendered
    (dust_tpu_torch/bench_edits.py's frame). Returns (its timings, the
    scene kernel's launches by tier, the instance kernels' launches on
    the loop-route frame)."""
    import dataclasses
    import tempfile

    import torch
    from dust_tpu_torch import bench_edits as be
    from dust_tpu_torch.render import edits as editlib
    from dust_tpu_torch.render import materials as matlib
    from dust_tpu_torch.render.edits import SceneEditor
    from dust_tpu_torch.render.pipeline import make_frame_state
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.utils.checkpoint import load_state, save_state
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    n = EDIT_FRAMES
    ctx = be.setup(dev)
    vox = load_vox_scene(procgen.castle_scene_bytes())
    procgen.add_teapot(vox)
    cpu_ed = SceneEditor(vox, build_device_scene(vox, "cpu"))
    _scenes_equal("edits, as built", ctx["scene"], cpu_ed.device)
    be.render(ctx)
    torch.cuda.synchronize()
    launches, times = {}, {}

    def counts():
        return dict(editlib.REFITS), dict(editlib.CELLS)

    def check_refits(label, before, landed, cells=None):
        """``edits.REFITS`` since ``before`` (a ``counts()``): ``landed``
        (tier -> count), nothing under the other tiers; ``edits.CELLS``
        since then printed, and held to ``cells`` when given. Read before
        the CPU editor's replay, which counts too."""
        got = {k: editlib.REFITS[k] - before[0][k] for k in editlib.REFITS}
        want = {k: landed.get(k, 0) for k in editlib.REFITS}
        grid = {k: editlib.CELLS[k] - before[1][k] for k in editlib.CELLS}
        print(f"{label}: edits.REFITS landed {got}, edits.CELLS {grid}")
        if got != want:
            raise SystemExit(f"{label}: edits.REFITS counted {got}, not "
                             f"{want}")
        if cells is not None and grid != cells:
            raise SystemExit(f"{label}: edits.CELLS counted {grid}, not "
                             f"{cells}")

    # ---- interleaved: no edit, a leaf edit every frame, staged splices --
    reset_counts()
    before = counts()
    times["base_ms"] = min(be.run(ctx, n), be.run(ctx, n))
    _check_launches(hdda.LAUNCHES, SCENE_LAUNCHES, 2 * n,
                    "edits baseline hdda_scene")
    check_refits("edits baseline", before, {})
    launches["edits baseline"] = dict(hdda.LAUNCHES)
    reset_counts()
    before = counts()
    times["leaf_ms"] = min(be.run(ctx, n, lambda f: be.leaf_edit(ctx, f)),
                           be.run(ctx, n, lambda f: be.leaf_edit(ctx, f)))
    check_refits("edits leaf", before, {"leaf": 2 * n},
                 {"merge": 2 * n, "leaf": 64 * 2 * n})
    done = _edit_tier(hdda, "edits leaf", ctx, cpu_ed, 0, "leaf", 2 * n,
                      launches)

    def edited_frame():
        be.leaf_edit(ctx, 2 * n)
        return be.render(ctx)

    # One frame without and one with a leaf edit under torch.profiler (the
    # later tiers' replay takes this edit too): the leaf tier adds no host
    # sync.
    plain_syncs = _print_profile("edits, no edit,", ctx, 0, card,
                                 lambda: be.render(ctx))
    edit_syncs = _print_profile("edits, a leaf edit,", ctx, 0, card,
                                edited_frame)
    if edit_syncs != plain_syncs:
        raise SystemExit(f"edits: a leaf edit added host syncs "
                         f"({edit_syncs} against {plain_syncs})")
    reset_counts()
    before, staged = counts(), len(ctx["edits"])
    every = max(n // 2, 1)
    times["splice_ms"] = min(
        be.run(ctx, n, lambda f: be.splice_step(ctx, f, every)),
        be.run(ctx, n, lambda f: be.splice_step(ctx, f, every)))
    be.land_splice(ctx)
    times["swap_frames"] = list(ctx["splice_swaps"])
    if not ctx["splice_swaps"]:
        raise SystemExit("edits: no staged splice swapped in")
    # One splice a staged block (each is one edit), the last one landed
    # by land_splice.
    check_refits("edits splice", before,
                 {"splice": len(ctx["edits"]) - staged})
    done = _edit_tier(hdda, "edits splice", ctx, cpu_ed, done, "splice",
                      2 * n, launches)

    # ---- one forced rebuild --------------------------------------------
    before = counts()
    be.edit(ctx, be.slab_voxels(), 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx["scene"], ctx["state"] = ctx["editor"].refit(ctx["state"])
    torch.cuda.synchronize()
    times["rebuild_in_loop_ms"] = 1e3 * (time.perf_counter() - t0)
    check_refits("edits rebuild", before, {"rebuild": 1})
    reset_counts()
    out, frame_s = _timed_frames(ctx, 2, 0, lambda: be.render(ctx))
    done = _edit_tier(hdda, "edits rebuild", ctx, cpu_ed, done, "rebuild", 2,
                      launches)
    img = out.float()
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.02):
        raise SystemExit("edits rebuild: output is not a finite, non-black "
                         "image")
    print(f"edits: base {times['base_ms']:.2f}, leaf edit every frame "
          f"{times['leaf_ms']:.2f}, staged splice {times['splice_ms']:.2f} "
          f"ms/frame (swaps after {times['swap_frames']} frames); the "
          f"rebuild refit {times['rebuild_in_loop_ms']:.1f} ms, frames after "
          f"it {', '.join(f'{1e3 * t:.1f}' for t in frame_s)} ms [{card}]")

    # ---- the loop route on the rebuilt tables: the instance kernels -----
    os.environ["DUST_PALLAS_SCENE"] = "loop"
    try:
        recs = []
        reset_counts()
        _recording(hdda, "hdda_instance", _record_instance_launches(recs),
                   lambda: be.render(ctx))
        per_frame = {m: ctx["scene"].num_instances * k
                     for m, k in SCENE_LAUNCHES.items()}
        _check_launches(hdda.INSTANCE_LAUNCHES, per_frame, 1,
                        "edits loop hdda_instance")
        _check_launches(hdda.LAUNCHES, NO_LAUNCHES, 1, "edits loop hdda_scene")
        loop_launches = dict(hdda.INSTANCE_LAUNCHES)
        torch.cuda.synchronize()
        for mode, a in recs:
            _hold_instance(hdda, "edits loop hdda_instance", mode, a,
                           timed=False)
        loop_frame_ms = _instance_frame_ms(hdda, recs, "edits loop frame",
                                           card)
    finally:
        os.environ.pop("DUST_PALLAS_SCENE", None)

    # ---- the teapot on the emissive material ---------------------------
    saved = matlib.material_registry()
    matlib.register_material(1, matlib.EmissiveMaterial(strength=6.0))
    try:
        ids = tuple(int(i == 1) for i in range(ctx["scene"].num_instances))
        lit = be.setup(dev)
        lit["settings"] = dataclasses.replace(lit["settings"],
                                              instance_materials=ids)
        reset_counts()
        out, frame_s = _timed_frames(lit, 2, 0, lambda: be.render(lit))
        _check_launches(hdda.LAUNCHES, SCENE_LAUNCHES, 2,
                        "emissive hdda_scene")
        _report_frame("castle+teapot, emissive teapot", lit, out, frame_s,
                      card)
        del lit
        small = []
        for d, mats in ((dev, ()), (dev, ids), (torch.device("cpu"), ids)):
            c = be.setup(d, 256, 144)
            c["settings"] = dataclasses.replace(c["settings"],
                                                instance_materials=mats)
            small.append(be.render(c, return_aux=True))
        (plain, aux), (card_lit, _), (cpu_lit, _) = small
        err = rmse(card_lit, cpu_lit)
        px = (aux["voxel_id"] & 0xFFFF) == 1
        gain = float(card_lit[px].mean() - plain[px].mean())
        print(f"256x144 emissive teapot: card vs CPU plain RMSE {err:.5f}; "
              f"{int(px.sum())} teapot pixels brighter by {gain:.4f}")
        if not err < 0.01:
            raise SystemExit(f"card and CPU emissive frames differ: RMSE "
                             f"{err:.5f}")
        if not (int(px.sum()) > 20 and gain > 0.02):
            raise SystemExit(f"emissive teapot: {int(px.sum())} pixels, "
                             f"brighter by {gain:.4f}")
    finally:
        matlib._REGISTRY.clear()
        matlib._REGISTRY.update(saved)

    # ---- checkpoint resume ---------------------------------------------
    res = be.setup(dev)
    for _ in range(2):
        be.render(res)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_state(path, res["state"])
        resumed = load_state(path, make_frame_state(res["settings"],
                                                    res["scene"], dev))
    if resumed.gi.table.device != ctx["scene"].device:
        raise SystemExit("checkpoint: the loaded state is not on the card")
    out_a, state_a = be.render(res), res["state"]
    res["state"] = resumed
    out_b, state_b = be.render(res), res["state"]
    same = (torch.equal(out_a, out_b)
            and torch.equal(state_a.gi.table, state_b.gi.table)
            and torch.equal(state_a.denoiser.history,
                            state_b.denoiser.history))
    print(f"checkpoint after frame 2, resumed on the card: frame 3 equal "
          f"{same}")
    if not same:
        raise SystemExit("checkpoint: the resumed frame 3 differs")
    del res, resumed, state_a, state_b

    # ---- the isolated refit tiers ----------------------------------------
    iso = be.isolated(dev, ISOLATED_EDITS)
    times["isolated"] = iso
    print(f"edits, isolated on the castle: build + upload "
          f"{iso['build_ms']:.1f} ms; best / median ms: floor "
          f"{iso['floor_ms'][0]:.2f} / {iso['floor_ms'][1]:.2f}, leaf "
          f"{iso['leaf_ms'][0]:.2f} / {iso['leaf_ms'][1]:.2f}, splice "
          f"{iso['splice_ms'][0]:.2f} / {iso['splice_ms'][1]:.2f}, rebuild "
          f"{iso['rebuild_ms'][0]:.2f} / {iso['rebuild_ms'][1]:.2f} [{card}]")
    return times, launches, loop_launches, loop_frame_ms


def _sharded_phase(hdda, dev, card, reset_counts):
    """Phase 18: the flythrough at 3840x2160 (BASELINE config #5) through
    render_frame with a mesh, on a one-rank NCCL group on the card, then
    the dry run's four gates (python -m dust_tpu_torch.parallel.dryrun
    --ranks 1 --device cuda). Returns (the scene kernel's launches per
    mode over the sharded frames, a dict of the phase's numbers)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from dust_tpu_torch import bench, parallel
    from dust_tpu_torch.parallel import dryrun
    from dust_tpu_torch.render.pipeline import frame_ray_count

    label = "flythrough, sharded"
    with tempfile.TemporaryDirectory() as tmp:
        parallel.init_process_group(
            0, 1, dev, store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            mesh = parallel.make_mesh()
            ctx = _setup(dev, WIDTH_4K, HEIGHT_4K, "flythrough")
            sh = dict(ctx, scene=parallel.replicate_scene(ctx["scene"], mesh))
            s = ctx["settings"]
            rays = frame_ray_count(ctx["scene"], s)

            def sharded(state, f):
                return bench.render(sh, parallel.shard_frame_state(
                    state, mesh), f, mesh=mesh)

            # The scene kernel against its plain version on the sharded
            # launches' real rays, and the sun's two launches (the 7th
            # launch) against the unsharded frame's fused ao_fg launch.
            calls = {"sharded": [], "unsharded": []}

            def keep(into):
                return lambda a, kw: into.append(
                    (kw["mode"], a + (kw.get("t_ao"),)))

            _recording(hdda, "hdda", keep(calls["sharded"]),
                       lambda: sharded(ctx["state"], 0))
            _recording(hdda, "hdda", keep(calls["unsharded"]),
                       lambda: bench.render(ctx, ctx["state"], 0))
            torch.cuda.synchronize()
            modes = [m for m, _ in calls["sharded"]]
            if modes != ["precise", "ao_threshold", "rough", "ao_threshold",
                         "rough", "rough", "rough"]:
                raise SystemExit(f"{label}: launch order {modes}")
            seen = set()
            for mode, full in calls["sharded"]:
                if mode in seen:
                    continue
                seen.add(mode)
                _hold(f"{label} hdda_scene {mode}",
                      lambda a, m=mode: hdda.hdda(*a[:11], t_ao=a[11], mode=m),
                      lambda a, m=mode: hdda.hdda_plain(*a[:12], mode=m),
                      full, 7, 0, timed=False)

            def launch_ms(mode, a):
                return _kernel_ms(lambda: hdda.hdda(*a[:11], t_ao=a[11],
                                                    mode=mode))

            sun_pair = [launch_ms(*c) for c in calls["sharded"][1:3]]
            fused = launch_ms(*calls["unsharded"][1])
            print(f"{label}: sun shadows in two launches ao_threshold "
                  f"{sun_pair[0]:.3f} ms + rough {sun_pair[1]:.3f} ms = "
                  f"{sum(sun_pair):.3f} ms, against the unsharded frame's "
                  f"fused ao_fg {fused:.3f} ms (+{sum(sun_pair) - fused:.3f} "
                  f"ms) [{card}]")
            del calls

            # The path: 4 frames, carrying the sharded state.
            state = parallel.shard_frame_state(ctx["state"], mesh)
            reset_counts()
            mesh.counts.update(calls=0, bytes=0)
            times, out = [], None
            for f in range(FRAMES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, _aux, state = bench.render(sh, state, f, mesh=mesh)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            _check_launches(hdda.LAUNCHES, SHARDED_LAUNCHES, FRAMES,
                            f"{label} hdda_scene")
            launches = dict(hdda.LAUNCHES)
            collectives = {k: v / FRAMES for k, v in mesh.counts.items()}
            img = parallel.gather_image(mesh, out, s.height)
            _report_frame(label, ctx, img, times, card)
            ms_sharded = 1e3 * sum(times[1:]) / (FRAMES - 1)
            print(f"{label}: {collectives['calls']:.0f} collectives per frame "
                  f"moving {collectives['bytes'] / 1e6:.1f} MB onto the rank "
                  f"(one rank, NCCL) [{card}]")
            # One more frame of each under torch.profiler: the device's
            # busy share.
            _print_profile(label, None, FRAMES, card, render=lambda: (
                bench.render(sh, state, FRAMES, mesh=mesh)))
            _print_profile("flythrough, unsharded", None, FRAMES, card,
                           render=lambda: bench.render(ctx, ctx["state"],
                                                       FRAMES))

            # Each frame against the unsharded frame from the same state
            # and camera; the unsharded frames carry the state and are
            # timed.
            state, u_times, agree = ctx["state"], [], []
            for f in range(FRAMES):
                img_s, _aux, _st = sharded(state, f)
                img_s = parallel.gather_image(mesh, img_s, s.height)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img_u, _aux, state = bench.render(ctx, state, f)
                torch.cuda.synchronize()
                u_times.append(time.perf_counter() - t0)
                agree.append(float(torch.isclose(
                    img_s, img_u, rtol=1e-3, atol=1e-3).float().mean()))
            print(f"{label} vs unsharded, frames 0-{FRAMES - 1} from the same "
                  f"states: isclose on {', '.join(f'{a:.6f}' for a in agree)} "
                  f"of values")
            if min(agree) <= dryrun.GATE:
                raise SystemExit(f"{label}: sharded and unsharded frames "
                                 f"differ ({min(agree):.6f} isclose)")
            ms_unsharded = 1e3 * sum(u_times[1:]) / (FRAMES - 1)
            print(f"{label}: {ms_sharded:.2f} ms/frame "
                  f"({rays / (ms_sharded * 1e3):.1f} Mrays/s) against the "
                  f"unsharded flythrough's {ms_unsharded:.2f} ms/frame "
                  f"({rays / (ms_unsharded * 1e3):.1f} Mrays/s) [{card}]")
        finally:
            dist.destroy_process_group()

    # The dry run's four gates on one rank of the card.
    if dryrun.main(["--ranks", "1", "--device", "cuda"]) != 0:
        raise SystemExit("dryrun --ranks 1 --device cuda failed")
    return launches, dict(
        ms=ms_sharded, unsharded_ms=ms_unsharded,
        collectives_per_frame=collectives["calls"],
        collective_bytes_per_frame=collectives["bytes"],
        sun_two_launches_ms=sun_pair, ao_fg_ms=fused, isclose=agree)


def _tools_phase(hdda, dev, card, reset_counts, here):
    """Phases 19-23: the reference's tools, ported
    (dust_tpu_torch/tools/), on the card. Returns ({path: the scene
    kernel's launches per mode}, a dict of the phases' numbers)."""
    import math
    import tempfile

    import numpy as np
    import torch
    from dust_tpu_torch.ops import reservoir as reslib
    from dust_tpu_torch.tools import (bench_trace, gen_ground_truth,
                                      profile_frame, profile_stages)
    from dust_tpu_torch.tools.rmse import rmse

    by_path, out = {}, {}

    # ---- 19. bench_trace: each trace pass alone on a frame's rays -------
    scene = bench_trace.build_scene(dev)
    rays, _primary = bench_trace.build_rays(scene, WIDTH, HEIGHT, dev)
    reset_counts()
    passes = bench_trace.run(scene, rays, bench_trace.PASSES,
                             BENCH_TRACE_REPS, dev,
                             log=lambda line: print("bench_trace " + line))
    by_path["bench_trace"] = dict(hdda.LAUNCHES)
    for name, res in passes.items():
        mode = rays[name][4]
        want = {m: 4 * BENCH_TRACE_REPS * (m == mode) for m in hdda.MODES}
        if res["launches"] != want:
            raise SystemExit(f"bench_trace {name}: launches {res['launches']}"
                             f", expected {want}")
        if not (math.isfinite(res["checksum"]) and 0 < res["hit_rate"] <= 1):
            raise SystemExit(f"bench_trace {name}: checksum "
                             f"{res['checksum']}, hit rate {res['hit_rate']}")
    print(f"bench_trace at {WIDTH}x{HEIGHT}, {BENCH_TRACE_REPS} launches per "
          f"timing, best of 3 [{card}]")
    # Each pass's launch alone (CUDA-graph replay), beside the burst's
    # per-launch times; the primary and fused ao_fg launches against the
    # plain version on 65,536 of their rays.
    for name in bench_trace.PASSES:
        calls = []
        _recording(hdda, "hdda", lambda a, kw: calls.append(
            (kw["mode"], a + (kw.get("t_ao"),))),
            lambda: bench_trace.trace_pass(scene, rays[name]))
        torch.cuda.synchronize()
        mode, full = calls[0]
        res = passes[name]
        res["kernel_ms"] = _kernel_ms(
            lambda: hdda.hdda(*full[:11], t_ao=full[11], mode=mode))
        print(f"bench_trace {name}: the launch alone {res['kernel_ms']:.4f} "
              f"ms (graph replay) against {res['ms']:.4f} ms a launch in "
              f"the burst [{card}]")
        if name in ("primary", "aofg"):
            _hold(f"bench_trace {name} hdda_scene {mode}",
                  lambda a, m=mode: hdda.hdda(*a[:11], t_ao=a[11], mode=m),
                  lambda a, m=mode: hdda.hdda_plain(*a[:12], mode=m), full,
                  7, 0, timed=False)
    out["bench_trace"] = passes
    del scene, rays, _primary

    # ---- 20. profile_stages: each stage of the hash frame alone ---------
    print(f"profile_stages at {WIDTH}x{HEIGHT}, pool {HASH_POOL}, 2^22 slots, "
          f"best of 5 (host ms, device ms) [{card}]:")
    reset_counts()
    stages = profile_stages.profile(
        WIDTH, HEIGHT, HASH_POOL, 1 << 22, 5, dev,
        log=lambda line: print("profile_stages " + line))
    by_path["profile_stages"] = dict(hdda.LAUNCHES)
    want = [n.format(p=HASH_POOL) for n in STAGE_NAMES]
    if list(stages) != want:
        raise SystemExit(f"profile_stages: stages {list(stages)}, expected "
                         f"the reference's {want}")
    out["profile_stages"] = stages
    # The insert's own device time: the kernels of one call at the pool
    # size (profile_stages' inputs) summed under torch.profiler, against
    # the span its CUDA events measure.
    from dust_tpu_torch.ops import spatial_hash as sh
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.trunc(torch.randn((HASH_POOL, 3), generator=gen,
                                device=dev).abs() * 50.0 / 4.0).int()
    f0 = torch.zeros((HASH_POOL,), dtype=torch.int32, device=dev)
    ones = torch.ones((HASH_POOL, 3), device=dev)
    table = sh.make_spatial_hash(1 << 22, dev)
    kernels, copies, syncs, dev_ms, wall_ms, top = _profile_frame(
        None, 0, render=lambda: sh.hash_insert(table, q, f0, ones, 0,
                                               valid=ones[:, 0] > 0))
    print(f"hash_insert ({HASH_POOL}) under torch.profiler: {kernels} CUDA "
          f"kernels, {copies} copies/sets, {syncs} host syncs, {dev_ms:.3f} ms "
          f"of device time in {wall_ms:.3f} ms [{card}]")
    for ms_k, count, name in top[:5]:
        print(f"  {ms_k:8.3f} ms in {count:5d} launches: {name[:90]}")
    out["hash_insert_profiled"] = dict(kernels=kernels, syncs=syncs,
                                       device_ms=dev_ms, wall_ms=wall_ms)

    # ---- 21. profile_frame: the gi frame under torch.profiler -----------
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        prof = profile_frame.profile(
            WIDTH, HEIGHT, PROFILE_FRAMES, tmp, dev,
            log=lambda line: print("profile_frame " + line))
        _check_launches(hdda.LAUNCHES, SCENE_LAUNCHES, PROFILE_FRAMES + 2,
                        "profile_frame hdda_scene")
        by_path["profile_frame"] = dict(hdda.LAUNCHES)
        size = os.path.getsize(prof["trace"])
    print(f"profile_frame: {prof['ms_per_frame']:.3f} ms/frame under the "
          f"profiler, Chrome trace {size} B, {len(prof['top'])} kernels in "
          f"the table [{card}]")
    if size == 0 or not prof["top"]:
        raise SystemExit("profile_frame: an empty trace or kernel table")
    out["profile_frame"] = dict(ms=prof["ms_per_frame"], trace_bytes=size,
                                top=prof["top"][:5])

    # ---- 22. gen_ground_truth against tests/golden/ ----------------------
    golden = np.load(os.path.join(here, GT_PATH))
    W, H, frames = (int(golden[k]) for k in ("width", "height", "frames"))
    reset_counts()
    t0 = time.perf_counter()
    got = gen_ground_truth.ground_truth(
        W, H, frames, GT_WARMUP, dev,
        log=lambda line: print("gen_ground_truth " + line))
    secs = time.perf_counter() - t0
    _check_launches(hdda.LAUNCHES, SCENE_LAUNCHES, GT_WARMUP + frames,
                    "gen_ground_truth hdda_scene")
    by_path["gen_ground_truth"] = dict(hdda.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"castle_gt_{W}x{H}.npz")
        gen_ground_truth.write(path, got)
        written = np.load(path)
        if sorted(written.files) != sorted(golden.files):
            raise SystemExit(f"gen_ground_truth: fields {written.files}")
    e_out = rmse(got["output"], golden["output"])
    e_rad = rmse(got["radiance"], golden["radiance"])
    e_alb = rmse(got["albedo"], golden["albedo"])
    rms = rmse(golden["radiance"], np.zeros_like(golden["radiance"]))
    print(f"gen_ground_truth {W}x{H}, {GT_WARMUP} + {frames} frames in "
          f"{secs:.1f} s: against {GT_PATH}: output RMSE {e_out:.6f} (bound "
          f"{RMSE_GOLDEN}), radiance RMSE {e_rad:.6f} (RMS {rms:.4f}), albedo "
          f"RMSE {e_alb:.6f}; exposure {float(got['exposure']):.6f} on the "
          f"card, {float(golden['exposure']):.6f} in the golden [{card}]")
    if secs > GT_SLOW_S:
        print(f"gen_ground_truth took {secs:.1f} s, over {GT_SLOW_S:.0f} s")
    if not e_out < RMSE_GOLDEN:
        raise SystemExit(f"gen_ground_truth: output RMSE {e_out:.6f} against "
                         f"the golden")
    out["gen_ground_truth"] = dict(
        seconds=secs, output_rmse=e_out, radiance_rmse=e_rad,
        radiance_rms=rms, albedo_rmse=e_alb,
        exposure=float(got["exposure"]),
        golden_exposure=float(golden["exposure"]))

    # ---- 23. reservoirs: pack and unpack on the card and on the CPU -----
    rng = np.random.default_rng(0)
    steps = []
    for _ in range(3):
        d = rng.normal(size=(RESERVOIRS, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        steps.append([x.astype(np.float32) for x in (
            d, np.exp(rng.normal(0.0, 2.0, (RESERVOIRS, 3))),
            rng.exponential(1.0, RESERVOIRS), rng.random(RESERVOIRS))])
    packed, unpacked = [], []
    for where in (dev, torch.device("cpu")):
        r = reslib.make_reservoirs(RESERVOIRS, where)
        for step in steps:
            r = reslib.reservoir_update(
                r, *(torch.as_tensor(x, device=where) for x in step))
        words = reslib.pack_reservoir(r)
        packed.append([w.cpu() for w in words])
        unpacked.append(reslib.unpack_reservoir(*words))
    (cc, cd, cl, cw), (pc, pd, pl, pw) = packed
    same = [torch.equal(cc, pc), torch.equal(cw, pw), torch.equal(cd, pd)]
    luv_same = float((cl == pl).float().mean())
    steps_apart = int(((cl >> 18) - (pl >> 18)).abs().max())
    low_same = bool(((cl & 0x3FFFF) == (pl & 0x3FFFF)).all())
    u_card, u_cpu = unpacked
    dots = float((u_card.direction.cpu() * u_cpu.direction).sum(-1).min())
    print(f"reservoirs, {RESERVOIRS} after 3 updates, card vs CPU: counts, "
          f"weights, direction words equal {same}; LogLuv words equal on "
          f"{luv_same:.6%}, log-luminance codes at most {steps_apart} apart, "
          f"u and v codes equal {low_same}; unpacked directions' least dot "
          f"{dots:.7f}")
    if not (all(same) and luv_same >= 0.9999 and steps_apart <= 1
            and low_same):
        raise SystemExit("reservoirs: the card's packed words differ from "
                         "the CPU's")
    out["reservoirs"] = dict(count=RESERVOIRS, luv_equal=luv_same,
                             luv_steps_apart=steps_apart)
    return by_path, out


def _host_cpu():
    """The host's CPU model and the cores this process may run on. The
    model is /proc/cpuinfo's ``model name``, else its vendor, family and
    model numbers (or an Arm core's implementer and part), with the
    machine's architecture."""
    import platform

    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip() and fields:
                break                                # the first processor
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    model = fields.get("model name") or ", ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model",
                                     "CPU implementer", "CPU part")
        if fields.get(k)) or "no model in /proc/cpuinfo"
    return f"{model} ({platform.machine()})", len(os.sched_getaffinity(0))


def _in_turns(native_fn, plain_fn, reps=NATIVE_REPS):
    """Best host ms of ``native_fn`` and of ``plain_fn`` over ``reps`` calls
    each, in turns (native, plain, plain, native, ...); with the first
    call's results of each."""
    times = {"native": [], "plain": []}
    first = {}
    fns = {"native": native_fn, "plain": plain_fn}
    for k in range(reps):
        order = ("native", "plain") if k % 2 == 0 else ("plain", "native")
        for name in order:
            t0 = time.perf_counter()
            out = fns[name]()
            times[name].append(1e3 * (time.perf_counter() - t0))
            first.setdefault(name, out)
    return min(times["native"]), min(times["plain"]), first


def _geometries_equal(label, a, b):
    """Every field of two VoxGeometry, dtypes included."""
    import numpy as np

    pairs = [(f, getattr(a.flat, f), getattr(b.flat, f)) for f in (
        "leaf_origin", "mask_lo", "mask_hi", "active_lo", "active_hi",
        "material_ptr", "leaf_grid")]
    pairs += [(f, getattr(a, f), getattr(b, f))
              for f in ("avg_albedo", "materials")]
    for name, x, y in pairs:
        if not (x.dtype == y.dtype and x.shape == y.shape
                and np.array_equal(x, y)):
            raise SystemExit(f"native: {label}: {name} differs from the "
                             f"plain version")
    if (tuple(a.size), a.unit_size) != (tuple(b.size), b.unit_size):
        raise SystemExit(f"native: {label}: size differs")


def _native_phase(dev, card, edit_times):
    """Phase 24: the native scene build (dust_tpu_torch/native), held equal
    to its plain versions and timed against them on the host. Returns a
    dict of the phase's numbers."""
    import numpy as np
    from dust_tpu_torch import native
    from dust_tpu_torch.bench_edits import fresh_leaf_voxels
    from dust_tpu_torch.render import scene as scn
    from dust_tpu_torch.render.edits import SceneEditor, geometry_voxels
    from dust_tpu_torch.vox import loader, procgen
    from dust_tpu_torch.vox.collector import collect_material_indices

    cpu, cores = _host_cpu()
    host = f"{cpu}, {cores} cores"

    # ---- every model of both scenes: native equal to plain -------------
    castle = loader.load_vox_scene(procgen.castle_scene_bytes())
    procgen.add_teapot(castle)
    stress, _ = procgen.stress_scene()
    held = []
    for label, vox in (("castle+teapot", castle), ("stress", stress)):
        for mid, geo in sorted(vox.geometries.items()):
            coords, idx = geometry_voxels(geo)
            occupancy, block_ptr, mats = native.build_leaves(coords, idx)
            mats_plain, ptr_plain = collect_material_indices(coords, idx)
            if not (np.array_equal(block_ptr, ptr_plain)
                    and np.array_equal(mats, mats_plain)):
                raise SystemExit(f"native: {label} model {mid}: build_leaves "
                                 f"differs from collect_material_indices")
            args = (coords, idx, vox.palette, geo.size, geo.unit_size)
            built = loader.build_model_geometry(*args)
            what = f"{label} model {mid}"
            _geometries_equal(what, built,
                              loader.build_model_geometry_plain(*args))
            _geometries_equal(what + " as loaded", built, geo)
            occ = geo.flat.leaf_grid >= 0
            if not np.array_equal(native.chebyshev(occ),
                                  scn._chebyshev_plain(occ)):
                raise SystemExit(f"native: {what}: chebyshev differs from "
                                 f"the dilation loop")
            held.append(dict(scene=label, model=mid, voxels=len(coords),
                             leaves=geo.num_blocks))
    print("native: build_leaves + from_dense_pools + "
          "build_geometry_from_flat and chebyshev equal to their plain "
          "versions on " + ", ".join(
              f"{h['scene']} model {h['model']} ({h['voxels']} voxels, "
              f"{h['leaves']} leaves)" for h in held))

    # ---- in turns: native against plain --------------------------------
    out = dict(library=native.build_library().name, cpu=cpu, cores=cores,
               held=held)
    data = procgen.castle_scene_bytes()
    swap = loader.build_model_geometry

    def load_plain():
        loader.build_model_geometry = loader.build_model_geometry_plain
        try:
            return loader.load_vox_scene(data)
        finally:
            loader.build_model_geometry = swap

    nat, plain, first = _in_turns(lambda: loader.load_vox_scene(data),
                                  load_plain)
    for mid, g in first["native"].geometries.items():
        _geometries_equal(f"castle load model {mid}", g,
                          first["plain"].geometries[mid])
    out["load_ms"] = dict(native=nat, plain=plain)

    vox = loader.load_vox_scene(data)
    ed = SceneEditor(vox, scn.build_device_scene(vox, dev))
    fresh = fresh_leaf_voxels(vox)
    ed.set_voxel(0, fresh[0], 5)
    ed.refit()
    geo = vox.geometries[0]
    nat, plain, first = _in_turns(
        lambda: ed._rebuild_geometry(0),
        lambda: loader.build_model_geometry_plain(
            *ed.voxels(0), vox.palette, geo.size, geo.unit_size))
    _geometries_equal("castle rebuild", first["native"], first["plain"])
    out["rebuild_geometry_ms"] = dict(native=nat, plain=plain)

    occ = geo.flat.leaf_grid >= 0
    nat, plain, first = _in_turns(lambda: scn.chebyshev_distance_field(occ),
                                  lambda: scn._chebyshev_plain(occ))
    if not np.array_equal(first["native"], first["plain"]):
        raise SystemExit("native: the castle's skip field differs")
    out["chebyshev_ms"] = dict(native=nat, plain=plain)

    # The isolated splice tier (bench_edits' edit: one voxel in a fresh
    # leaf of the castle), native and plain in turns, and the share of it
    # that the geometry rebuild takes.
    rebuild_native = ed._rebuild_geometry
    inner = []

    def rebuild_timed(mid):
        t0 = time.perf_counter()
        g = rebuild_native(mid)
        inner.append(1e3 * (time.perf_counter() - t0))
        return g

    def rebuild_plain(mid):
        g = vox.geometries[mid]
        return loader.build_model_geometry_plain(
            *ed.voxels(mid), vox.palette, g.size, g.unit_size)

    edits = iter(fresh[1:])

    def splice(rebuild):
        ed._rebuild_geometry = rebuild
        ed.set_voxel(0, next(edits), 5)
        scene = ed.refit()
        int(scene.avg_albedo[0, 0])          # waits for the device
        if ed.last_refit_mode != "splice":
            raise SystemExit(f"native: a splice edit took the "
                             f"{ed.last_refit_mode} tier")

    nat, plain, _ = _in_turns(lambda: splice(rebuild_timed),
                              lambda: splice(rebuild_plain))
    ed._rebuild_geometry = rebuild_native
    out["splice_ms"] = dict(native=nat, plain=plain,
                            rebuild_geometry_native=min(inner))
    share = min(inner) / nat
    ms = {k: out[k] for k in ("load_ms", "rebuild_geometry_ms",
                              "chebyshev_ms", "splice_ms")}
    print("native vs plain, best of "
          f"{NATIVE_REPS} in turns (host ms) on {host}: " + "; ".join(
              f"{k[:-3]} {v['native']:.2f} / {v['plain']:.2f} "
              f"({v['plain'] / v['native']:.2f}x)" for k, v in ms.items())
          + f"; the geometry rebuild is {100 * share:.1f}% of the native "
          f"splice tier [{card}]")
    iso = edit_times["isolated"]
    print(f"native: phase 17's edit tiers of this call (native): staged "
          f"splice {edit_times['splice_ms']:.2f} ms/frame, forced rebuild "
          f"{edit_times['rebuild_in_loop_ms']:.1f} ms, isolated splice "
          f"{iso['splice_ms'][0]:.2f} / {iso['splice_ms'][1]:.2f} and "
          f"rebuild {iso['rebuild_ms'][0]:.2f} / {iso['rebuild_ms'][1]:.2f} "
          f"(best / median ms) on {host} [{card}]")
    out["splice_share"] = share
    return out


def _held_equal(label, kernel, plain):
    """Kernel outputs against plain outputs, field by field: dtype, shape,
    torch.equal, and every bit of a float32 field (so -0.0 and 0.0
    differ)."""
    import torch

    for name, b in plain.items():
        a = kernel[name]
        if a.dtype != b.dtype or a.shape != b.shape:
            raise SystemExit(f"{label} {name}: kernel {a.dtype} "
                             f"{tuple(a.shape)}, plain {b.dtype} "
                             f"{tuple(b.shape)}")
        same = (a.view(torch.int32) == b.view(torch.int32)
                if a.dtype == torch.float32 else a == b)
        if not (torch.equal(a, b) and bool(same.all())):
            rays = int((~same).reshape(a.shape[0], -1).any(dim=1).sum())
            raise SystemExit(f"{label} {name}: kernel and plain differ on "
                             f"{rays} of {a.shape[0]} rays")


def _gbuffer_case(label, scene, cam, sky, width, height, tiled, lo=0,
                  hi=None, instances=2, card="", timed=False):
    """Phase 25 on one frame's rays ``[lo, hi)``: both G-buffer kernels
    held against their plain versions (:func:`_held_equal`), the frame's
    rays traced precise in between; at least ``instances`` instances hit
    and some rays miss. With ``timed``, each kernel's device time beside
    its bound and its plain version's time. Returns a dict of numbers."""
    import ctypes

    import torch
    from dust_tpu_torch.ops import camera as cameralib
    from dust_tpu_torch.ops import gbuffer, hdda, shade

    n = width * height
    hi = n if hi is None else hi
    before = dict(gbuffer.LAUNCHES)

    def rays():
        return cameralib.primary_rays(cam, width, height, tiled, lo, hi)

    def rays_plain():
        return cameralib.primary_rays_plain(cam, width, height, tiled, lo,
                                            hi)

    o, d = rays()
    o_p, d_p = rays_plain()
    _held_equal(f"{label} primary_rays", dict(origins=o, directions=d),
                dict(origins=o_p, directions=d_p))
    res = hdda.trace_scene(scene, o, d, cam.near, cam.far, "precise")

    def resolve():
        return shade.resolve_primary(scene, res, o, d, sky)

    def resolve_plain():
        return shade.resolve_hits_plain(scene, res, o, d, sky)

    g = resolve()
    g_p = resolve_plain()
    _held_equal(f"{label} gbuffer_resolve", g, g_p)
    expect = {k: v + (k in GBUFFER_LAUNCHES) for k, v in before.items()}
    if gbuffer.LAUNCHES != expect:
        raise SystemExit(f"{label}: G-buffer launches {gbuffer.LAUNCHES}, "
                         f"expected {expect}")
    hits = torch.bincount(g_p["inst"][g_p["hit"]],
                          minlength=scene.num_instances).tolist()
    misses = int((~g_p["hit"]).sum())
    print(f"{label}: rays [{lo}, {hi}) of {width}x{height} "
          f"({'tiled' if tiled else 'raster'}), both kernels equal to "
          f"their plain versions in every field; hits by instance {hits}, "
          f"misses {misses}")
    if misses == 0 or sum(h > 0 for h in hits) < instances:
        raise SystemExit(f"{label}: want misses and hits on {instances} "
                         "instances")
    out = dict(rays=hi - lo, hits=hits, misses=misses)
    if not timed:
        return out
    m = hi - lo
    out_bytes = sum(t.numel() * t.element_size() for t in g.values())
    # The resolve's launch alone (its wrapper uploads inst_leaf_base, a
    # blocking copy no CUDA graph can hold); args and the outputs it
    # points at stay alive while the graph replays.
    args, outs = gbuffer._resolve_args(scene, res, o, d, sky)
    for name, fn, plain, nbytes in (
            ("primary_rays", rays, rays_plain, 24 * m),
            ("gbuffer_resolve",
             lambda: gbuffer.LIBRARY.launch(
                 "gbuffer_resolve_launch", ctypes.addressof(args),
                 device=o.device, count="gbuffer_resolve"),
             resolve_plain, GBUFFER_READ_BYTES * m + out_bytes)):
        ms = _kernel_ms(fn)
        plain_ms = _ms(plain, 3)
        bound = 1e3 * nbytes / MEM_BYTES_PER_S
        print(f"{label} {name}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes / m:.1f} B a ray at 3.35 TB/s, "
              f"{100.0 * bound / ms:.1f}% of it); plain {plain_ms:.3f} ms "
              f"host-issued [{card}]")
        out[name] = dict(ms=ms, bound_ms=bound, bytes_per_ray=nbytes / m,
                         plain_ms=plain_ms)
    del args, outs
    return out


def _frame_equal(label, what, ctx, frame, swaps):
    """Frame ``frame`` of ctx from its state through the kernels and
    through their plain versions (each ``(module, name, plain)`` of
    ``swaps``: the entry point ``module.name`` swapped for ``plain``):
    output, aux and new state equal (torch.equal). Returns the kernels'
    new state."""
    import dataclasses

    import torch

    entry = [getattr(module, name) for module, name, _ in swaps]
    try:
        out_k, aux_k, st_k = _render(ctx, frame, ctx["state"], True)
        for module, name, plain in swaps:
            setattr(module, name, plain)
        out_p, aux_p, st_p = _render(ctx, frame, ctx["state"], True)
    finally:
        for (module, name, _), fn in zip(swaps, entry):
            setattr(module, name, fn)

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if dataclasses.is_dataclass(x):
            x = [getattr(x, f.name) for f in dataclasses.fields(x)]
        elif isinstance(x, dict):
            x = list(x.values())
        elif not isinstance(x, (list, tuple)):
            return [x]
        return [leaf for v in x for leaf in leaves(v)]

    a, b = leaves((out_k, aux_k, st_k)), leaves((out_p, aux_p, st_p))
    same = len(a) == len(b) and all(
        torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v
        for u, v in zip(a, b))
    print(f"{label}: frame {frame} through the {what} kernels and through "
          f"their plain versions: output, aux and state equal {same} "
          f"({len(a)} fields)")
    if not same:
        raise SystemExit(f"{label}: the frame differs from the plain path's")
    return st_k


def _gbuffer_frame_equal(label, ctx, frame=3):
    """:func:`_frame_equal` of the G-buffer kernels' entry points."""
    from dust_tpu_torch.ops import camera as cameralib
    from dust_tpu_torch.ops import shade

    return _frame_equal(label, "G-buffer", ctx, frame, [
        (cameralib, "primary_rays", cameralib.primary_rays_plain),
        (shade, "resolve_primary", shade.resolve_hits_plain)])


def _gbuffer_phase(dev, card):
    """25. The G-buffer kernels held and timed (module docstring); a dict
    of the phase's numbers."""
    import math

    from dust_tpu_torch import bench
    from dust_tpu_torch.ops import camera as cameralib
    from dust_tpu_torch.vox import procgen

    def orbit_frame(ctx, width, height, angle, frame):
        """The castle at ``frame`` of the teapot's motion (the frame
        before it as the previous transforms) seen from the bench's orbit
        at ``angle``."""
        s = ctx["settings"]
        scene = ctx["scene"]
        for f in (frame - 1, frame):
            scene = scene.with_transforms(
                procgen.teapot_motion(ctx["base_o2w"], ctx["anim"], f))
        r = math.dist((bench.EYE[0], bench.EYE[2]),
                      (bench.TARGET[0], bench.TARGET[2]))
        eye = (r * math.sin(angle), bench.EYE[1], r * math.cos(angle))
        cam = cameralib.camera_settings(
            cameralib.look_at(eye, bench.TARGET), s.camera.fov,
            s.camera.near, s.camera.far, width, height, dev)
        return scene, cam

    out = {}
    for config, width, height in (("gi", WIDTH, HEIGHT),
                                  ("gi-4k", WIDTH_4K, HEIGHT_4K)):
        ctx = _setup(dev, width, height, config)
        _gbuffer_frame_equal(f"gbuffer {width}x{height}", ctx)
        scene, cam = orbit_frame(ctx, width, height, 2.0, 17)
        label = f"gbuffer {width}x{height}"
        out[label] = _gbuffer_case(label, scene, cam, ctx["sky"], width,
                                   height, True, card=card, timed=True)
        if config == "gi":
            n = width * height
            c = -(-n // 4)
            out["gbuffer chunk"] = _gbuffer_case(
                "gbuffer 1080p rank 1 of 4", scene, cam, ctx["sky"], width,
                height, True, lo=c, hi=2 * c, instances=1)
            _s, raster_cam = orbit_frame(ctx, 1000, 600, 4.0, 18)
            out["gbuffer raster"] = _gbuffer_case(
                "gbuffer 1000x600 raster", _s, raster_cam, ctx["sky"], 1000,
                600, False, instances=1)
        del ctx, scene
    stress = _setup(dev, WIDTH, HEIGHT, "stress")
    out["gbuffer stress"] = _gbuffer_case(
        "gbuffer stress", stress["scene"], stress["cam"], stress["sky"],
        WIDTH, HEIGHT, True, instances=3)
    return out

def _hash_codec_equal(dev, chunk=1 << 26, colours=1 << 24, seed=0):
    """Phase 26: the hash kernels' LogLuv codec
    (``spatial_hash_logluv_kernel``) against packing.py's on the card:
    every 32-bit word decoded (each float's bits equal), and ``colours``
    ACEScg colours encoded (words equal): components log-uniform over
    1e-12..1e8, a tenth of them 0, a twentieth negative, and rows of
    infinities, NaN, subnormals and the largest float. Returns a dict of
    the counts checked."""
    import torch
    from dust_tpu_torch.ops import packing as pk
    from dust_tpu_torch.ops import spatial_hash as sh

    for start in range(0, 1 << 32, chunk):
        words = torch.arange(start, start + chunk, dtype=torch.int64,
                             device=dev)
        words = ((words ^ 0x80000000) - 0x80000000).int()
        k = sh.logluv(words).view(torch.int32)
        p = pk.decode_logluv(words).view(torch.int32)
        bad = (k != p).any(dim=1)
        if bool(bad.any()):
            w = words[bad][:4].tolist()
            raise SystemExit(
                f"LogLuv decode: kernel and plain differ on "
                f"{int(bad.sum())} words of [{start}, {start + chunk}), "
                f"e.g. {w}: kernel {k[bad][:4].tolist()}, plain "
                f"{p[bad][:4].tolist()}")
        del words, k, p, bad
    g = torch.Generator(device="cpu").manual_seed(seed)
    rgb = 10.0 ** (torch.rand((colours, 3), generator=g) * 20.0 - 12.0)
    u = torch.rand((colours, 3), generator=g)
    rgb = torch.where(u < 0.1, 0.0, torch.where(u > 0.95, -rgb, rgb))
    special = torch.tensor([[float("inf"), 1.0, 1.0], [1.0, float("inf"), 0.0],
                            [float("nan"), 1.0, 1.0], [1.0, float("nan"), 1.0],
                            [1e-40, 1e-40, 1e-40], [0.0, 1e-45, 0.0],
                            [3.4e38, 3.4e38, 3.4e38], [-0.0, -0.0, -0.0],
                            [-float("inf"), 2.0, 3.0]])
    rgb = torch.cat([special, rgb]).to(dev)
    k = sh.logluv(rgb)
    p = pk.encode_logluv(rgb)
    p = ((p ^ 0x80000000) - 0x80000000).int()
    bad = k != p
    if bool(bad.any()):
        raise SystemExit(
            f"LogLuv encode: kernel and plain differ on {int(bad.sum())} of "
            f"{rgb.shape[0]} colours, e.g. {rgb[bad][:4].tolist()}: kernel "
            f"{k[bad][:4].tolist()}, plain {p[bad][:4].tolist()}")
    print(f"hash codec: every 32-bit LogLuv word decoded and "
          f"{rgb.shape[0]} colours encoded, kernel equal to packing.py's")
    return dict(words=1 << 32, colours=rgb.shape[0])


def _hash_filled_table(capacity, dev, share=0.5, seed=0):
    """A table whose groups are occupied in ``share`` of them: every slot
    of such a group holds a nonzero fingerprint, a LogLuv word, a last
    frame in [0, 100) and a count in [1, 404] (keys that land there evict
    by LRU), the rest empty."""
    import torch
    from dust_tpu_torch.ops import spatial_hash as sh

    g = torch.Generator(device=dev).manual_seed(seed)
    ngroups = capacity // 4
    slots = torch.randint(1, 2 ** 31 - 1, (ngroups, 4, 4), generator=g,
                          device=dev, dtype=torch.int32)
    slots[..., 2] = torch.randint(0, 100, (ngroups, 4), generator=g,
                                  device=dev, dtype=torch.int32)
    slots[..., 3] = torch.randint(1, 405, (ngroups, 4), generator=g,
                                  device=dev, dtype=torch.int32)
    used = torch.rand(ngroups, generator=g, device=dev) < share
    return sh.SpatialHash(table=torch.where(used[:, None], slots.reshape(
        ngroups, 16), 0))


def _hash_insert_case(label, dev, capacity, n, cap, rounds=3, seed=0,
                      all_valid=False):
    """Phase 26: the insert's kernels against ``hash_insert_plain`` on the
    card, ``rounds`` inserts of ``n`` keys into one table (each round into
    the kernels' table of the round before), tables equal (torch.equal).
    The keys repeat (a key drawn from n / 2 cells, so runs of one key in a
    round and matches across rounds); half the groups start full, so keys
    evict. Returns a dict: applied groups and evictions of the last round,
    and whether the cap bound."""
    import torch
    from dust_tpu_torch.ops import spatial_hash as sh

    g = torch.Generator(device="cpu").manual_seed(seed)
    table = _hash_filled_table(capacity, dev, seed=seed)
    ncells = max(n // 2, 1)
    cell_q = torch.randint(-4000, 4000, (ncells, 3), generator=g,
                           dtype=torch.int32)
    cell_f = torch.randint(0, 6, (ncells,), generator=g, dtype=torch.int32)
    out = {}
    for r in range(rounds):
        pick = torch.randint(0, ncells, (n,), generator=g)
        q, f = cell_q[pick].to(dev), cell_f[pick].to(dev)
        scale = 10.0 ** (torch.rand((n, 1), generator=g) * 5.0 - 3.0)
        value = (torch.rand((n, 3), generator=g) * scale).to(dev)
        valid = None if all_valid else (
            torch.rand(n, generator=g) < 0.9).to(dev)
        before = dict(sh.LAUNCHES)
        k = sh.hash_insert(table, q, f, value, 7 + r, valid=valid,
                           max_updates=cap)
        p = sh.hash_insert_plain(table, q, f, value, 7 + r, valid=valid,
                                 max_updates=cap)
        grew = {name: sh.LAUNCHES[name] - before[name] for name in before}
        want = dict.fromkeys(before, 1)
        want.update(probe=0, logluv=0)
        if grew != want:
            raise SystemExit(f"{label}: launches {grew}, expected {want}")
        if not torch.equal(k.table, p.table):
            rows = int((k.table != p.table).any(dim=1).sum())
            raise SystemExit(f"{label} round {r}: kernel and plain tables "
                             f"differ in {rows} group rows")
        old = table.table.view(-1, 4, 4)
        new = k.table.view(-1, 4, 4)
        changed = (old != new).any(dim=2)          # (groups, slots)
        evicted = changed & (old[..., 0] != 0) & (old[..., 0] != new[..., 0])
        groups = int(changed.any(dim=1).sum())
        keys = sh.key_location(q.long(), f.long(), capacity) >> 2
        live = keys if valid is None else keys[valid]
        distinct = int(torch.unique(live).numel())
        out = dict(keys=n, applied_groups=groups,
                   evictions=int(evicted.sum()), groups_with_keys=distinct,
                   cap=cap, cap_bound=cap is not None and distinct > cap)
        table = k
    print(f"{label}: {rounds} rounds of {n} keys into {capacity} slots, "
          f"kernel tables equal to the plain version's; last round "
          f"{out['applied_groups']} groups written of "
          f"{out['groups_with_keys']} with keys (cap {cap}), "
          f"{out['evictions']} evictions")
    return out


def _hash_probe_case(label, ctx, slices=4):
    """Phase 26: the working-set probe kernel against its plain version on
    ctx's scene and table: every row, then each of ``slices`` rotating
    slices of a copy (torch.equal). Returns a dict of the counts."""
    import torch
    from dust_tpu_torch.ops import gi_cache as gilib
    from dust_tpu_torch.ops import spatial_hash as sh
    from dust_tpu_torch.render import pipeline

    scene, state = ctx["scene"], ctx["state"]
    centers, vleaf = pipeline._cell_enumeration(scene)
    cs = ctx["settings"].spatial_hash.cell_size
    alb = gilib.albedo_words(scene)
    before = sh.LAUNCHES["probe"]
    k = sh.probe_working_set(state.gi, centers, vleaf, cs, albedo=alb)
    p = sh.probe_working_set_plain(state.gi, centers, vleaf, cs, albedo=alb)
    if not torch.equal(k, p):
        raise SystemExit(f"{label}: kernel and plain working sets differ in "
                         f"{int((k != p).any(dim=1).sum())} rows")
    rows = k.shape[0]
    found = int(((k[:, 1] >> 16) & 0xFFFF).ne(0).sum())
    size = -(-rows // slices)
    for s in range(slices):
        lo = min(s * size, rows - size)
        ws = k.clone()
        ws[:, :2] = 0
        kk = sh.probe_working_set(state.gi, centers, vleaf, cs, ws=ws, lo=lo,
                                  hi=lo + size)
        pp = sh.probe_working_set_plain(state.gi, centers, vleaf, cs, ws=ws,
                                        lo=lo, hi=lo + size)
        if not torch.equal(kk, pp):
            raise SystemExit(f"{label}: slice [{lo}, {lo + size}) differs in "
                             f"{int((kk != pp).any(dim=1).sum())} rows")
    if sh.LAUNCHES["probe"] != before + 1 + slices:
        raise SystemExit(f"{label}: {sh.LAUNCHES['probe'] - before} probe "
                         f"launches, expected {1 + slices}")
    print(f"{label}: {rows} working-set keys ({centers.shape[0]} cells), "
          f"{found} found in the table; the kernel equal to the plain "
          f"version on every row and on {slices} rotating slices")
    if not 0 < found < rows:
        raise SystemExit(f"{label}: {found} of {rows} keys found")
    return dict(rows=rows, cells=centers.shape[0], found=found)


def _hash_frame_equal(label, ctx, frame):
    """:func:`_frame_equal` of the hash kernels' entry points (the new
    state holds the table)."""
    from dust_tpu_torch.ops import spatial_hash as sh

    return _frame_equal(label, "hash", ctx, frame, [
        (sh, "probe_working_set", sh.probe_working_set_plain),
        (sh, "hash_insert", sh.hash_insert_plain)])


def _hash_phase_26(dev, card):
    """26. The hash's kernels held and timed (module docstring); a dict of
    the phase's numbers."""
    import torch
    from benchmark import hashwork
    from dust_tpu_torch.ops import gi_cache as gilib
    from dust_tpu_torch.ops import spatial_hash as sh
    from dust_tpu_torch.render import pipeline

    out = {"codec": _hash_codec_equal(dev)}
    out["insert"] = _hash_insert_case(
        "hash insert at the cell's size", dev, HASH_CAPACITY, HASH_POOL,
        HASH_INSERT_CAP)
    if not (out["insert"]["cap_bound"] and out["insert"]["evictions"] > 0):
        raise SystemExit(f"hash insert: want the cap reached and evictions, "
                         f"got {out['insert']}")
    for n, cap in ((1000, None), (1024, None), (4097, 100)):
        _hash_insert_case(f"hash insert of {n} keys", dev, 1 << 16, n, cap,
                          rounds=2, seed=n, all_valid=n == 1024)
    ctx = _setup(dev, WIDTH, HEIGHT, "hash-reference")
    for k in sh.LAUNCHES:
        sh.LAUNCHES[k] = 0
    _frames(ctx, FRAMES)
    want = {k: FRAMES for k in HASH_KERNELS}
    got = {k: sh.LAUNCHES[k] for k in HASH_KERNELS}
    if got != want:
        raise SystemExit(f"hash frame: launches {got} over {FRAMES} frames, "
                         f"expected {want}")
    out["probe"] = _hash_probe_case("hash probe at the cell's size", ctx)
    ctx["state"] = _hash_frame_equal(f"hash {WIDTH}x{HEIGHT}", ctx, FRAMES)

    # Each kernel's time, on the next frame's own probe and insert.
    calls = []
    _recorded_frame(ctx, FRAMES + 1, sh, "hash_insert",
                    lambda a, kw: calls.append((a, kw)))
    a, kw = calls[0]
    args, _table = sh._insert_args(*a[:5], kw.get("valid"),
                                   kw.get("max_updates"))
    sh._insert_run(args, dev)
    scene, state = ctx["scene"], ctx["state"]
    centers, vleaf = pipeline._cell_enumeration(scene)
    cs = ctx["settings"].spatial_hash.cell_size
    alb = gilib.albedo_words(scene)
    times = {"probe": _kernel_ms(lambda: sh.probe_working_set(
        state.gi, centers, vleaf, cs, albedo=alb))}
    for step, name in enumerate(sh._INSERT_STEPS):
        times[name] = _kernel_ms(lambda: sh._insert_step(args, dev, step))
    times["sort (torch)"] = _kernel_ms(
        lambda: torch.sort(args.keep["gkey"], stable=True))
    keys = 6 * centers.shape[0]
    pool = a[1].reshape(-1, 3).shape[0]
    floor = {"probe": 1e3 * hashwork.probe_bytes(keys, centers.shape[0])
             / hashwork.MEM_BYTES_PER_S,
             "insert": 1e3 * hashwork.insert_bytes(pool)
             / hashwork.MEM_BYTES_PER_S}
    insert_ms = sum(times[n] for n in sh._INSERT_STEPS)
    for name, ms in times.items():
        print(f"hash {name}: {ms:.4f} ms a launch (CUDA-graph replay) "
              f"[{card}]")
    print(f"hash probe: {keys} keys, floor {floor['probe']:.4f} ms, "
          f"{100.0 * floor['probe'] / times['probe']:.1f}% of it; insert "
          f"kernels {insert_ms:.4f} ms over {pool} keys, floor "
          f"{floor['insert']:.4f} ms, "
          f"{100.0 * floor['insert'] / insert_ms:.1f}% (benchmark/hashwork.py "
          f"at 3.35 TB/s) [{card}]")
    out.update(ms=times, floor_ms=floor, keys=dict(probe=keys, insert=pool))
    del ctx, args
    return out


def _denoise_inputs(height, width, dev, seed=0, edge=False):
    """Two denoiser steps' inputs at ``height`` x ``width`` (dicts ``a`` and
    ``b`` of :func:`denoise`'s keywords): the orbit camera's G-buffer of
    a rippled surface 12-28 units away (a tenth of the pixels missed, a
    disc moving), then the same seen from a camera moved 0.85 units, so
    that the second step reprojects under motion and some pixels leave
    the image. With ``edge`` (width and height powers of two) the
    previous view-projection is affine and the second step moves each
    pixel by 0, +-1, +0.5 or -0.25 pixels: pixel centres land on the
    image's edge rows and columns exactly, or just outside."""
    import math

    import torch
    from dust_tpu_torch.ops import camera as cameralib

    gen = torch.Generator().manual_seed(seed)
    H, W = height, width
    ys = torch.arange(H, dtype=torch.float32)[:, None]
    xs = torch.arange(W, dtype=torch.float32)[None, :]
    valid = (torch.rand((H, W), generator=gen) > 0.1)
    valid[H // 3:H // 3 + max(H // 16, 1), W // 5:W // 4] = False
    disc = ((ys - H / 2) ** 2 + (xs - W / 2) ** 2) < (min(H, W) / 5) ** 2
    radiance = torch.exp(torch.randn((H, W, 3), generator=gen)) * 0.3
    hitdist = torch.exp(torch.randn((H, W), generator=gen) * 1.5) * 4.0
    hitdist = torch.where(torch.rand((H, W), generator=gen) < 0.05, 1e5,
                          hitdist)
    steps = {}
    for k, name in enumerate("ab"):
        if edge:
            vp = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 0],
                               [0, 0, 0, 1.0]])
            pos = torch.stack(torch.broadcast_tensors(
                (xs + 0.5) * (2.0 / W) - 1.0, 1.0 - (ys + 0.5) * (2.0 / H),
                torch.rand((H, W), generator=gen)), dim=-1)
            depth = 0.9 + 0.2 * torch.rand((H, W), generator=gen)
            shift = torch.tensor([0.0, 0.0, 0.0, 1.0, -1.0, 0.5, -0.25])
            pick = torch.randint(0, 7, (2, H, W), generator=gen)
            motion = torch.stack(
                [shift[pick[0]] * (2.0 / W), -shift[pick[1]] * (2.0 / H),
                 torch.zeros((H, W))], dim=-1) * k
            dirs = torch.tensor([0.0, 0.0, -1.0]).expand(H, W, 3)
        else:
            eye = (26.0 + 0.6 * k, 14.0, 32.0 - 0.6 * k)
            cam = cameralib.camera_settings(
                cameralib.look_at(eye, (4.0, -4.0, 0.0)), 0.9, 0.1, 1e4, W,
                H, "cpu")
            if k == 0:
                vp = cam.view_proj
            dirs = cameralib.camera_ray_dirs(cam, W, H)
            depth = (20.0 + 8.0 * torch.sin(xs / 29.0) * torch.cos(ys / 17.0)
                     + 0.5 * torch.rand((H, W), generator=gen))
            pos = torch.tensor(eye) + dirs * depth[..., None]
            motion = torch.where(
                disc[..., None], 0.05 * torch.randn((H, W, 3), generator=gen),
                0.0)
        nrm = -dirs / dirs.norm(dim=-1, keepdim=True) \
            + 0.4 * torch.randn((H, W, 3), generator=gen)
        nrm = nrm / nrm.norm(dim=-1, keepdim=True)
        ok = valid[..., None]
        steps[name] = dict(
            radiance=radiance * (1.0 + 0.1 * k), hitdist=hitdist,
            depth=torch.where(valid, depth, math.inf),
            normal=torch.where(ok, nrm, torch.tensor([0.0, 0.0, 1.0])),
            world_pos=torch.where(ok, pos, 0.0),
            motion=torch.where(ok, motion, 0.0), prev_view_proj=vp)
    return {name: {k: v.to(dev).contiguous() for k, v in step.items()}
            for name, step in steps.items()}


def _denoise_held(label, kernel, plain):
    """:func:`_held_equal` of two denoiser steps' (denoised, hitdist,
    new state)."""
    def fields(step):
        return dict(denoised=step[0], hitdist=step[1],
                    history=step[2].history)

    _held_equal(label, fields(kernel), fields(plain))


def _denoise_case(label, dev, height, width, passes, seed=0, edge=False,
                  card="", timed=False):
    """Phase 27 at one shape: two steps (a still camera from an empty
    history, then a moved one from the first step's history), each
    through the kernels and through the plain version, held every bit
    (:func:`_denoise_held`), with ``passes`` à-trous passes; each step
    launches the temporal kernel once and the à-trous kernel ``passes``
    times (on the card; the CPU runs the plain version and launches
    nothing). With ``timed``, each kernel's device time beside its floor and
    the plain step's time. Returns a dict of numbers."""
    import dataclasses

    import torch
    from dust_tpu_torch.config import DenoiserSettings
    from dust_tpu_torch.ops import denoise as denoiselib

    settings = dataclasses.replace(DenoiserSettings(),
                                   atrous_iterations=passes)
    steps = _denoise_inputs(height, width, dev, seed, edge)
    state = denoiselib.make_denoiser_state(height, width, dev)
    out = dict(shape=[height, width], passes=passes)
    for name in "ab":
        before = dict(denoiselib.LAUNCHES)
        k = denoiselib.denoise(state, settings=settings, **steps[name])
        on = torch.device(dev).type == "cuda"  # the CPU launches nothing
        expect = {"denoise_temporal": before["denoise_temporal"] + on,
                  "denoise_atrous": before["denoise_atrous"] + on * passes}
        if denoiselib.LAUNCHES != expect:
            raise SystemExit(f"{label}: launches {denoiselib.LAUNCHES}, "
                             f"expected {expect}")
        p = denoiselib.denoise_plain(state, settings=settings, **steps[name])
        _denoise_held(f"{label} step {name}", k, p)
        state = p[2]
        kept = float((state.history_len > 1.0).float().mean())
        out[f"history_kept_{name}"] = kept
    print(f"{label}: {height}x{width}, {passes} passes, two steps equal to "
          f"the plain version in every bit; history kept on "
          f"{100.0 * out['history_kept_b']:.1f}% of the pixels after the "
          f"moved step")
    if not 0.05 < out["history_kept_b"] < 0.98:
        raise SystemExit(f"{label}: want the moved step to keep some "
                         f"history and lose some, got {out}")
    if not timed:
        return out
    b = steps["b"]
    plain_ms = _ms(lambda: denoiselib.denoise_plain(
        state, settings=settings, **b), 3)
    t_in = (state.history, b["radiance"], b["hitdist"], b["depth"],
            b["normal"], b["world_pos"], b["motion"], b["prev_view_proj"],
            settings, 0, 0)
    _h, filt, _hd, geom, terms = denoiselib._temporal(*t_in)
    times = {"denoise_temporal": _kernel_ms(
        lambda: denoiselib._temporal(*t_in))}
    px = height * width
    floor = {"denoise_temporal": DENOISE_TEMPORAL_BYTES * px}
    for it in range(passes):
        last = it == passes - 1
        name = f"denoise_atrous step {1 << it}"
        times[name] = _kernel_ms(lambda: denoiselib._atrous(
            filt, geom, terms, b["radiance"], settings, 0, 0, 1 << it, last))
        floor[name] = (DENOISE_LAST_PASS_BYTES if last
                       else DENOISE_PASS_BYTES) * px
    floor = {k: 1e3 * v / MEM_BYTES_PER_S for k, v in floor.items()}
    step_ms = _kernel_ms(lambda: denoiselib.denoise(
        state, settings=settings, **b))
    for name, ms in times.items():
        print(f"{label} {name}: {ms:.4f} ms (CUDA-graph replay), floor "
              f"{floor[name]:.4f} ms, {100.0 * floor[name] / ms:.1f}% of it "
              f"[{card}]")
    print(f"{label}: the step {step_ms:.4f} ms through the kernels "
          f"(CUDA-graph replay), floor {sum(floor.values()):.4f} ms; plain "
          f"{plain_ms:.3f} ms host-issued [{card}]")
    out.update(ms=times, floor_ms=floor, step_ms=step_ms, plain_ms=plain_ms)
    return out


def _in_ranks(ranks, fn):
    """``fn(rank, gather)`` on ``ranks`` threads, each with an all-gather
    over the threads (``gather(x)``: every rank's ``x`` in rank order);
    the results in rank order."""
    import threading

    import torch

    slots = [None] * ranks
    results = [None] * ranks
    errors = []
    barrier = threading.Barrier(ranks)

    def run(r):
        def gather(x):
            slots[r] = x
            barrier.wait()
            whole = torch.cat(slots)
            barrier.wait()
            return whole

        try:
            results[r] = fn(r, gather)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _denoise_sharded(denoise, state, inputs, settings, ranks):
    """One denoiser step as ``ranks`` ranks of the sharded frame compute
    it (:func:`_in_ranks`): each its rows of the image (the last rank
    fewer), with ``rows=(lo, hi, gather)``; the ranks' results joined."""
    import torch
    from dust_tpu_torch.ops import denoise as denoiselib

    H = inputs["depth"].shape[0]
    c = -(-H // ranks)

    def rank(r, gather):
        lo, hi = min(H, r * c), min(H, (r + 1) * c)
        mine = {k: (v if k == "prev_view_proj" else
                    v[max(lo - 1, 0):min(hi + 1, H)] if k == "radiance"
                    else v[lo:hi]) for k, v in inputs.items()}
        part = denoiselib.DenoiserState(history=state.history[lo:hi])
        return denoise(part, settings=settings, rows=(lo, hi, gather),
                       **mine)

    parts = _in_ranks(ranks, rank)
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]),
            denoiselib.DenoiserState(history=torch.cat(
                [p[2].history for p in parts])))


def _denoise_sharded_case(label, dev, height, width, passes, ranks=4,
                          seed=0):
    """Phase 27's sharded rows: the moved step of :func:`_denoise_inputs`
    on ``ranks`` ranks through the kernels, equal in every bit to the
    plain version's sharded step and, on the card, to the whole image's
    (on the CPU, close to it)."""
    import dataclasses

    import torch

    from dust_tpu_torch.config import DenoiserSettings
    from dust_tpu_torch.ops import denoise as denoiselib

    settings = dataclasses.replace(DenoiserSettings(),
                                   atrous_iterations=passes)
    steps = _denoise_inputs(height, width, dev, seed)
    state = denoiselib.denoise_plain(
        denoiselib.make_denoiser_state(height, width, dev),
        settings=settings, **steps["a"])[2]
    whole = denoiselib.denoise_plain(state, settings=settings, **steps["b"])
    k = _denoise_sharded(denoiselib.denoise, state, steps["b"], settings,
                         ranks)
    p = _denoise_sharded(denoiselib.denoise_plain, state, steps["b"],
                         settings, ranks)
    _denoise_held(label, k, p)
    if torch.device(dev).type == "cuda":
        _denoise_held(f"{label} (whole)", k, whole)
    else:
        # The CPU's vectorised exp2 and log2 round a lane of the vector
        # body and one of the scalar tail apart, so rows cut elsewhere
        # may move a last bit.
        for a, b in zip(k[:2], whole[:2]):
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                raise SystemExit(f"{label}: the sharded rows differ from "
                                 "the whole image's")
        same = (k[2].history == whole[2].history).all(dim=-1)
        if float(same.float().mean()) < 0.999:
            raise SystemExit(f"{label}: the sharded history differs from "
                             "the whole image's")
    print(f"{label}: {height}x{width} on {ranks} ranks, {passes} passes: "
          f"the rows through {denoiselib.denoise.__name__} equal the plain "
          f"version's, sharded and whole")


def _denoise_frame_equal(label, ctx, frame=3):
    """:func:`_frame_equal` of the denoiser's entry point."""
    from dust_tpu_torch.ops import denoise as denoiselib

    return _frame_equal(label, "denoise", ctx, frame, [
        (denoiselib, "denoise", denoiselib.denoise_plain)])


def _denoise_phase_27(dev, card):
    """27. The denoiser's kernels held and timed (module docstring); a dict
    of the phase's numbers."""
    from dust_tpu_torch.ops import denoise as denoiselib
    from dust_tpu_torch.tools import profile_stages

    out = {}
    for label, h, w, passes, timed in (
            ("denoise 4K half-res", HEIGHT_4K // 2, WIDTH_4K // 2, 3, True),
            ("denoise 1080p half-res", HEIGHT // 2, WIDTH // 2, 3, True),
            ("denoise 1080p full-res", HEIGHT, WIDTH, 4, False)):
        out[label] = _denoise_case(label, dev, h, w, passes, card=card,
                                   timed=timed)
    out["edge"] = _denoise_case("denoise edges", dev, 128, 256, 3, seed=1,
                                edge=True)
    _denoise_sharded_case("denoise sharded", dev, HEIGHT // 2, WIDTH // 2, 3)
    for config, width, height in (("gi", WIDTH, HEIGHT),
                                  ("gi-4k", WIDTH_4K, HEIGHT_4K)):
        ctx = _setup(dev, width, height, config)
        for k in denoiselib.LAUNCHES:
            denoiselib.LAUNCHES[k] = 0
        _frames(ctx, FRAMES)
        want = {k: FRAMES * v for k, v in DENOISE_LAUNCHES.items()}
        if denoiselib.LAUNCHES != want:
            raise SystemExit(f"denoise {config}: launches "
                             f"{denoiselib.LAUNCHES} over {FRAMES} frames, "
                             f"expected {want}")
        _denoise_frame_equal(f"denoise {width}x{height}", ctx, FRAMES)
        del ctx
    # Phase 20's denoise figure again: profile_stages' post stage.
    stages = profile_stages.profile(
        WIDTH, HEIGHT, HASH_POOL, 1 << 22, 5, dev, stages=("post",),
        log=lambda line: print("profile_stages " + line))
    out["profile_stages_denoise"] = stages.get("denoise")
    return out


def _gather_edge_inputs(scene, n, dev, seed=0):
    """The gather entry points' arguments on ``n`` made-up rays (a 256-wide
    tiled image) of ``scene`` (on ``dev``), with every edge a frame can
    meet: primary misses (a zero normal), degenerate normals (z < -0.99999,
    some exactly -1), AO hits, final-gather misses and hits on every
    instance, leaf rows past an instance's cell cap, cache rows without a
    sample, with -0.0 halves and with -0.0 direct light. Returns
    (gather_dirs' arguments, resolve_gather's less ``cells``)."""
    import math

    import torch
    from dust_tpu_torch.config import RenderSettings
    from dust_tpu_torch.ops import gi_cache as gilib
    from dust_tpu_torch.ops import noise as noiselib
    from dust_tpu_torch.ops import sky as skylib
    from dust_tpu_torch.ops.fp import as_i32, f16_bits
    from dust_tpu_torch.ops.traverse import TraceResult

    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    def unit(k):
        v = torch.randn(k, 3, generator=g)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    settings = RenderSettings()
    normal = unit(n)
    normal[::16] = torch.tensor([0.0, 0.0, -1.0])
    normal[8::16] = torch.tensor([3e-3, 0.0, -math.sqrt(1.0 - 9e-6)])
    hit = rand(n) > 0.15
    normal[~hit] = 0.0
    bn = noiselib.load_blue_noise(dev).unitvec3_cosine
    dirs = (normal.to(dev), hit.to(dev), bn, 37, (7, 183), 28011, 256,
            n // 256, True, 0, n, settings.ambient_occlusion_threshold)

    n_inst = scene.num_instances
    _bases, caps, _ = gilib.cell_layout(scene)
    fg_inst = randint(-1, n_inst, n)
    fg_row = torch.where(fg_inst >= 0, randint(0, max(caps) + 64, n), -1)
    fg_t = torch.where(fg_inst >= 0, rand(n) * 60.0 + 0.5, float("inf"))
    ao_inst = torch.where(rand(n) > 0.75, randint(0, n_inst, n), -1)
    ao_t = torch.where(ao_inst >= 0, rand(n) * 0.4 + 0.1, float("inf"))
    minus = torch.full((n,), -1, dtype=torch.int32)
    fg = TraceResult(fg_t, fg_inst.int(), fg_row.int(), minus)
    ao = TraceResult(ao_t, ao_inst.int(), minus.clone(), minus.clone())
    hit_loc = rand(n, 3) * 120.0 - 10.0
    gi_dir = unit(n)
    gi_dir[5::11] = torch.tensor([0.0, 1.0, 0.0])
    direct = torch.randn(n, 3, generator=g) * 2.0
    direct[::13] = -0.0
    sky_out = rand(n, 3) * 3.0

    rows = 6 * gilib.dense_cells(scene)
    rad = (torch.randn(rows, 3, generator=g) * 4.0).abs() * (
        rand(rows, 1) > 0.1)
    half = f16_bits(rad)
    half[::5] = 0x8000
    count = torch.where(rand(rows) > 0.3, randint(1, 405, rows), 0).long()
    w0 = half[:, 0] | (half[:, 1] << 16)
    w1 = half[:, 2] | (count << 16)
    w2 = torch.randint(0, 1 << 32, (rows,), generator=g)
    cache = gilib.DenseGICache(table=torch.stack(
        [as_i32(w0), as_i32(w1), as_i32(w2)], dim=-1).to(dev))
    sky = skylib.bake_sky(settings.sunlight, dev)
    resolve = (scene, *(TraceResult(*(x.to(dev) for x in r))
                        for r in (fg, ao)),
               *(x.to(dev) for x in (hit_loc, gi_dir, hit, direct, sky_out)),
               cache, sky, True, True)
    return dirs, resolve


def _gather_inputs(ctx, frame):
    """The arguments of the gather's two entry points in frame ``frame``
    of ctx (carrying its state): (gather_dirs' positional arguments,
    resolve_gather's less its keywords, its ``cells``, its
    ``debug_illum``)."""
    from dust_tpu_torch.ops import shade

    calls = {}

    def render():
        return _recording(shade, "resolve_gather",
                          lambda a, kw: calls.setdefault("resolve", (a, kw)),
                          lambda: _render(ctx, frame, ctx["state"]))

    _out, ctx["state"] = _recording(
        shade, "gather_dirs", lambda a, kw: calls.setdefault("dirs", a),
        render)
    (a, kw) = calls["resolve"]
    return calls["dirs"], a, kw["cells"], kw["debug_illum"]


def _gather_held(label, dirs, resolve, cells, debug_illum=None):
    """Both gather kernels against their plain versions
    (:func:`_held_equal`: every output, every bit) on one set of
    arguments, one launch of each counted."""
    from dust_tpu_torch.ops import gbuffer, shade

    before = dict(gbuffer.LAUNCHES)
    gi_dir, t_max = shade.gather_dirs(*dirs)
    gi_dir_p, t_max_p = shade.gather_dirs_plain(*dirs)
    _held_equal(f"{label} gather_dirs", dict(gi_dir=gi_dir, ao_t_max=t_max),
                dict(gi_dir=gi_dir_p, ao_t_max=t_max_p))
    out = shade.resolve_gather(*resolve, cells=cells, debug_illum=debug_illum)
    out_p = shade.resolve_gather_plain(*resolve, cells=cells,
                                       debug_illum=debug_illum)
    if list(out) != list(out_p):
        raise SystemExit(f"{label}: outputs {list(out)}, plain {list(out_p)}")
    _held_equal(f"{label} gather_resolve", out, out_p)
    expect = {k: v + (k in GATHER_LAUNCHES) for k, v in before.items()}
    if gbuffer.LAUNCHES != expect:
        raise SystemExit(f"{label}: launches {gbuffer.LAUNCHES}, expected "
                         f"{expect}")


def _gather_variants(label, dirs, resolve, cells, debug_illum=None):
    """:func:`_gather_held` on the arguments as given, with the other
    ``cells``, with the debug view (made-up cached radiance with -0.0) or
    without it, with each ``contribution_secondary_*`` flag off and both,
    on the second quarter of the rays (a rank's chunk of the sharded
    frame) and in raster order."""
    import torch

    _gather_held(label, dirs, resolve, cells, debug_illum)
    _gather_held(f"{label} cells={not cells}", dirs, resolve, not cells)
    if debug_illum is None:
        n = dirs[0].shape[0]
        debug_illum = torch.rand(
            n, 3, generator=torch.Generator().manual_seed(n)) * 4.0
        debug_illum[::7] = -0.0
        debug_illum = debug_illum.to(dirs[0].device)
    else:
        debug_illum = None
    _gather_held(f"{label} debug view {debug_illum is not None}", dirs,
                 resolve, cells, debug_illum)
    for bounce, sky in ((False, True), (True, False), (False, False)):
        _gather_held(f"{label} bounce={bounce} skylight={sky}", dirs,
                     (*resolve[:10], bounce, sky), cells)
    n = dirs[0].shape[0]
    lo, hi = n // 4, n // 2
    chunk = (*(x[lo:hi] for x in dirs[:2]), *dirs[2:9], lo, hi, dirs[11])
    scene, fg, ao, *per_ray = resolve[:8]
    rest = resolve[8:]
    _gather_held(f"{label} rays [{lo}, {hi})", chunk,
                 (scene, *(type(r)(*(x[lo:hi] for x in r)) for r in (fg, ao)),
                  *(x[lo:hi] for x in per_ray), *rest), cells)
    _gather_held(f"{label} raster", (*dirs[:8], False, *dirs[9:]), resolve,
                 cells)


def _gather_case(label, ctx, frame, card="", timed=False):
    """Phase 28 on frame ``frame`` of ctx (rendered, carrying its state):
    both gather kernels held against their plain versions on the frame's
    own arguments (:func:`_gather_variants`); the frame must have
    final-gather hits and misses and AO hits. With ``timed``, each
    kernel's device time (CUDA-graph replay) beside its floor and its
    plain version's time. Returns a dict of numbers."""
    import ctypes

    import torch
    from dust_tpu_torch.ops import gbuffer, shade

    dirs, resolve, cells, debug_illum = _gather_inputs(ctx, frame)
    _gather_variants(label, dirs, resolve, cells, debug_illum)
    _scene, fg, ao, _o, _d, hit = resolve[:6]
    fg_hit = int((hit & ~(ao.inst >= 0) & (fg.inst >= 0)).sum())
    out = dict(rays=int(hit.shape[0]), hits=int(hit.sum()),
               ao_hits=int((hit & (ao.inst >= 0)).sum()), fg_hits=fg_hit)
    print(f"{label}: both gather kernels equal to their plain versions in "
          f"every output ({'with' if cells else 'without'} the enqueue's; "
          f"and the other way, the debug view the other way, each "
          f"contribution off, a chunk, raster order); {out}")
    if not (fg_hit and out["ao_hits"] and out["hits"] > fg_hit):
        raise SystemExit(f"{label}: want AO hits, final-gather hits and "
                         "misses")
    if not timed:
        return out
    m, hits = out["rays"], out["hits"]
    dev = hit.device
    args_d, keep_d = gbuffer._dirs_args(*dirs)
    args_r, keep_r = gbuffer._gather_args(*resolve, cells, debug_illum)

    def needed(per_ray):
        return per_ray["miss"] * (m - hits) + per_ray["hit"] * hits

    for name, entry, args, plain, nbytes in (
            ("gather_dirs", "gather_dirs_launch", args_d,
             lambda: shade.gather_dirs_plain(*dirs),
             needed(GATHER_DIRS_BYTES)),
            ("gather_resolve", "gather_resolve_launch", args_r,
             lambda: shade.resolve_gather_plain(
                 *resolve, cells=cells, debug_illum=debug_illum),
             needed(GATHER_RESOLVE_BYTES) + GATHER_ROW_BYTES * fg_hit)):
        ms = _kernel_ms(lambda: gbuffer.LIBRARY.launch(
            entry, ctypes.addressof(args), device=dev, count=name))
        plain_ms = _ms(plain, 3)
        bound = 1e3 * nbytes / MEM_BYTES_PER_S
        print(f"{label} {name}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes / m:.1f} B a ray at 3.35 TB/s, "
              f"{100.0 * bound / ms:.1f}% of it); plain {plain_ms:.3f} ms "
              f"host-issued [{card}]")
        out[name] = dict(ms=ms, bound_ms=bound, bytes_per_ray=nbytes / m,
                         plain_ms=plain_ms)
    del args_d, keep_d, args_r, keep_r
    torch.cuda.synchronize()
    return out


def _gather_edges(label, scene, dev, seed=0):
    """Phase 28's made-up rays (:func:`_gather_edge_inputs`) through
    :func:`_gather_variants`."""
    dirs, resolve = _gather_edge_inputs(scene, 1 << 14, dev, seed)
    _gather_variants(label, dirs, resolve, False)
    print(f"{label}: both gather kernels equal to their plain versions on "
          f"the made-up edges (seed {seed})")


def _gather_frame_equal(label, ctx, frame):
    """:func:`_frame_equal` of the gather kernels' entry points."""
    from dust_tpu_torch.ops import shade

    return _frame_equal(label, "gather", ctx, frame, [
        (shade, "gather_dirs", shade.gather_dirs_plain),
        (shade, "resolve_gather", shade.resolve_gather_plain)])


def _gather_phase_28(dev, card):
    """28. The final gather's kernels held and timed (module docstring); a
    dict of the phase's numbers."""
    from dust_tpu_torch.ops import gbuffer

    out = {}
    for config, width, height, timed, debug in (
            ("gi", WIDTH, HEIGHT, True, False),
            ("gi-4k", WIDTH_4K, HEIGHT_4K, True, False),
            ("hash-reference", WIDTH, HEIGHT, False, False),
            ("gi", 256, 128, False, True),
            ("hash-reference", 256, 128, False, True)):
        ctx = _setup(dev, width, height, config,
                     debug_visualize_spatial_hash=debug)
        for k in gbuffer.LAUNCHES:
            gbuffer.LAUNCHES[k] = 0
        _frames(ctx, FRAMES)
        _check_launches(gbuffer.LAUNCHES,
                        {**GBUFFER_LAUNCHES, **GATHER_LAUNCHES}, FRAMES,
                        f"{config} G-buffer and gather")
        label = f"gather {config} {width}x{height}" + (
            " debug view" if debug else "")
        out[label] = _gather_case(label, ctx, FRAMES, card=card, timed=timed)
        _gather_frame_equal(label, ctx, FRAMES + 1)
        if config == "gi" and not debug:
            _gather_edges("gather edges", ctx["scene"], dev)
        del ctx
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "dust_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(dust_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from dust_tpu_torch import bench, native
    from dust_tpu_torch.ops import denoise, gbuffer, hdda, spatial_hash
    from dust_tpu_torch.tools.rmse import rmse as rmse_np

    card = bench.card_name()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device(DEVICE)

    def reset_counts():
        for m in hdda.MODES:
            hdda.LAUNCHES[m] = 0
            hdda.INSTANCE_LAUNCHES[m] = 0
        for k in gbuffer.LAUNCHES:
            gbuffer.LAUNCHES[k] = 0
        for k in spatial_hash.LAUNCHES:
            spatial_hash.LAUNCHES[k] = 0
        for k in denoise.LAUNCHES:
            denoise.LAUNCHES[k] = 0

    def rmse(a, b):
        return rmse_np(a.float().cpu().numpy(), b.float().cpu().numpy())

    # ---- 2. build -----------------------------------------------------
    for module in (hdda, gbuffer, spatial_hash, denoise):
        t0 = time.perf_counter()
        lib = module.LIBRARY.build(verbose=True)
        print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lib = native.build_library()
    print(f"build: {lib.name} (g++) in {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernel against plain, per mode, on one frame's real rays ---
    ctx = _setup(dev, WIDTH, HEIGHT)
    held = _hold_scene_kernel(hdda, ctx, 0, "gi hdda_scene", True)
    kernels = [dict(name=f"hdda_scene<{m}>", route="cuda",
                    source="dust_tpu_torch/csrc/hdda.cu",
                    replaces=REPLACES + "1305", launches=0,
                    max_abs_err=held[m]["err"], ms=held[m]["ms"],
                    plain_ms=held[m]["plain_ms"],
                    bound_ms=held[m]["bound_ms"], bound_by=held[m]["bound_by"],
                    library_ms=None) for m in hdda.MODES]

    # ---- 4. the slice: 4 frames through render_frame on the card -------
    reset_counts()
    out, times = _timed_frames(ctx, FRAMES, first=1)
    _check_launches(hdda.LAUNCHES, SCENE_LAUNCHES, FRAMES, "hdda_scene")
    _check_launches(gbuffer.LAUNCHES, GBUFFER_LAUNCHES, FRAMES, "G-buffer")
    _check_launches(gbuffer.LAUNCHES, GATHER_LAUNCHES, FRAMES, "gather")
    for k in kernels:
        k["launches"] = hdda.LAUNCHES[k["name"][len("hdda_scene<"):-1]]
    _report_frame("castle+teapot dense GI", ctx, out, times, card)
    _print_profile("gi", ctx, FRAMES + 1, card)
    del ctx, out

    # ---- 5. the same frame small, on the card and on the CPU -----------
    imgs = [_frames(_setup(d, 256, 144), 2) for d in (dev, torch.device("cpu"))]
    err = rmse(imgs[0], imgs[1])
    print(f"256x144, 2 frames: card vs CPU plain RMSE {err:.5f}")
    if not err < 0.01:
        raise SystemExit(f"card and CPU frames differ: RMSE {err:.5f}")

    # ---- 6. the stress frame, batched route ----------------------------
    stress = _setup(dev, WIDTH, HEIGHT, "stress")
    if stress["scene"].num_instances != STRESS_INSTANCES:
        raise SystemExit(f"stress scene: {stress['scene'].num_instances} "
                         f"instances, expected {STRESS_INSTANCES}")
    stress_held = _hold_scene_kernel(hdda, stress, 0, "stress hdda_scene",
                                     False)
    reset_counts()
    out, times = _timed_frames(stress, FRAMES, first=1)
    _check_launches(hdda.LAUNCHES, SCENE_LAUNCHES, FRAMES, "hdda_scene")
    _check_launches(hdda.INSTANCE_LAUNCHES, dict.fromkeys(hdda.MODES, 0),
                    FRAMES, "hdda_instance")
    stress_launches = dict(hdda.LAUNCHES)
    _report_frame("stress, batched route", stress, out, times, card)

    # ---- 7. the stress frame, loop route -------------------------------
    first = 1 + FRAMES
    os.environ["DUST_PALLAS_SCENE"] = "loop"
    try:
        recs = []
        _recorded_frame(stress, first, hdda, "hdda_instance",
                        _record_instance_launches(recs))
        reset_counts()
        out, times = _timed_frames(stress, FRAMES, first=first + 1)
        per_trace = {m: STRESS_INSTANCES * k for m, k in SCENE_LAUNCHES.items()}
        _check_launches(hdda.INSTANCE_LAUNCHES, per_trace, FRAMES,
                        "hdda_instance")
        _check_launches(hdda.LAUNCHES, dict.fromkeys(hdda.MODES, 0), FRAMES,
                        "hdda_scene")
        launches = dict(hdda.INSTANCE_LAUNCHES)
        _report_frame("stress, loop route", stress, out, times, card)
        torch.cuda.synchronize()
        # Per mode, the launch with the most active rays, held whole and on
        # its edge launches, and timed; then every launch of the frame.
        busiest = {}
        for mode, a in recs:
            live = _instance_bytes(a, mode)[1]
            if live > busiest.get(mode, (-1,))[0]:
                busiest[mode] = (live, a)
        for mode in hdda.MODES:
            live, full = busiest[mode]
            h = _hold_instance(hdda, "stress hdda_instance", mode, full,
                               edges=True)
            print(f"stress hdda_instance<{mode}> busiest launch: {live} of "
                  f"{full[3].shape[0]} rays active, {h['ms']:.4f} ms against "
                  f"a bound of {h['bound_ms']:.4f} ms "
                  f"({100.0 * h['bound_ms'] / h['ms']:.1f}%) [{card}]")
            kernels.append(dict(
                name=f"hdda_instance<{mode}>", route="cuda",
                source="dust_tpu_torch/csrc/hdda.cu",
                replaces=REPLACES + ("1397" if mode == "ao_fg" else "1335"),
                launches=launches[mode], max_abs_err=h["err"], ms=h["ms"],
                plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
                bound_by=h["bound_by"], library_ms=None, active_rays=live))
        loop_frame_ms = {"stress loop": _instance_frame_ms(
            hdda, recs, "stress loop frame", card)}
        del busiest, recs
        # One frame from one state through both routes.
        f = first + 1 + FRAMES
        img_loop, _ = _render(stress, f, stress["state"])
    finally:
        os.environ.pop("DUST_PALLAS_SCENE", None)
    img_batched, _ = _render(stress, f, stress["state"])
    err = rmse(img_loop, img_batched)
    print(f"stress frame {f}: loop vs batched route RMSE {err:.5f}")
    if not err < 0.01:
        raise SystemExit(f"loop and batched routes differ: RMSE {err:.5f}")
    del stress, out, img_loop, img_batched

    # ---- 8. the stress frame small, on the card and on the CPU ---------
    imgs = [_frames(_setup(d, 128, 72, "stress"), 2)
            for d in (dev, torch.device("cpu"))]
    err = rmse(imgs[0], imgs[1])
    print(f"128x72 stress, 2 frames: card vs CPU plain RMSE {err:.5f}")
    if not err < 0.01:
        raise SystemExit(f"card and CPU stress frames differ: RMSE {err:.5f}")

    hash_launches, pool_held = _hash_phase(hdda, dev, card, reset_counts,
                                           rmse)

    # ---- 11. primary-shadow: the frame without GI ----------------------
    from dust_tpu_torch.config import DenoiserSettings

    by_path = {}
    _ctx, by_path["primary-shadow"] = _config_phase(
        hdda, dev, card, reset_counts, "primary-shadow", "primary-shadow",
        WIDTH, HEIGHT, NO_GI_LAUNCHES)
    del _ctx

    # ---- 12. gi-4k: the scene kernel held and timed at 4K --------------
    k4 = _setup(dev, WIDTH_4K, HEIGHT_4K, "gi-4k")
    held_4k = _hold_scene_kernel(hdda, k4, 0, "gi-4k hdda_scene", False)
    reset_counts()
    out, times = _timed_frames(k4, FRAMES, first=1)
    _check_launches(hdda.LAUNCHES, SCENE_LAUNCHES, FRAMES, "gi-4k hdda_scene")
    by_path["gi-4k"] = dict(hdda.LAUNCHES)
    _report_frame("gi-4k", k4, out, times, card)
    for mode in hdda.MODES:
        h = held_4k[mode]
        print(f"gi-4k hdda_scene<{mode}>: {h['ms']:.4f} ms per launch at "
              f"{WIDTH_4K}x{HEIGHT_4K}; bound {h['bound_ms']:.4f} ms "
              f"({h['bound_by']}); {100.0 * h['bound_ms'] / h['ms']:.2f}% of "
              f"the bound [{card}]")
    del k4, out

    # ---- 13. flythrough: 4K, the camera moving every frame -------------
    _ctx, by_path["flythrough"] = _config_phase(
        hdda, dev, card, reset_counts, "flythrough", "flythrough", WIDTH_4K,
        HEIGHT_4K, SCENE_LAUNCHES)
    del _ctx

    # ---- 14. precise sun shadows and the full-resolution denoise -------
    variants = {
        "precise-shadows": (PRECISE_LAUNCHES, dict(shadow_mode="precise")),
        "full-res-split": (SCENE_LAUNCHES, dict(denoiser=DenoiserSettings(
            half_res_indirect=False, split_direct=True))),
        "full-res-lumped": (SCENE_LAUNCHES, dict(denoiser=DenoiserSettings(
            half_res_indirect=False))),
    }
    for name, (per_frame, changes) in variants.items():
        _ctx, by_path[name] = _config_phase(
            hdda, dev, card, reset_counts, name, "gi", WIDTH, HEIGHT,
            per_frame, frames=2, **changes)
        del _ctx
        _card_vs_cpu(dev, rmse, name, **changes)

    # ---- 15. the eager backend -----------------------------------------
    eager = _eager_phase(hdda, dev, card, reset_counts, rmse)

    # ---- 16. the converged-ground-truth gates --------------------------
    gates = _gates(dev, here, card)

    # ---- 17. edits and refit with the GI frame re-rendered -------------
    edit_times, edit_launches, loop_launches, loop_frame_ms["edits loop"] = (
        _edits_phase(hdda, dev, card, reset_counts, rmse))

    # ---- 18. the ray-sharded 4K flythrough on a one-rank NCCL group ----
    by_path["flythrough-sharded"], sharded = _sharded_phase(
        hdda, dev, card, reset_counts)

    # ---- 19-23. the reference's tools, ported, on the card -------------
    tool_launches, tools = _tools_phase(hdda, dev, card, reset_counts, here)
    by_path.update(tool_launches)

    # ---- 24. the native scene build -------------------------------------
    native_build = _native_phase(dev, card, edit_times)

    # ---- 25. the primary stage's G-buffer kernels ------------------------
    gbuffer_held = _gbuffer_phase(dev, card)
    for name in GBUFFER_LAUNCHES:
        h = gbuffer_held[f"gbuffer {WIDTH}x{HEIGHT}"][name]
        h4 = gbuffer_held[f"gbuffer {WIDTH_4K}x{HEIGHT_4K}"][name]
        kernels.append(dict(
            name=f"{name}_kernel", route="cuda",
            source="dust_tpu_torch/csrc/gbuffer.cu", replaces=None,
            launches=FRAMES, max_abs_err=0.0, ms=h["ms"],
            plain_ms=h["plain_ms"], bound_ms=h["bound_ms"], bound_by="bytes",
            library_ms=None, gi_4k=dict(ms=h4["ms"], bound_ms=h4["bound_ms"],
                                        bound_by="bytes")))

    # ---- 26. the spatial hash's kernels -----------------------------------
    hash_held = _hash_phase_26(dev, card)
    for name in HASH_KERNELS:
        kernels.append(dict(
            name=f"spatial_hash_{name}_kernel", route="cuda",
            source="dust_tpu_torch/csrc/spatial_hash.cu", replaces=None,
            launches=FRAMES, max_abs_err=0.0, ms=hash_held["ms"][name],
            plain_ms=None,
            bound_ms=hash_held["floor_ms"]["probe" if name == "probe"
                                          else "insert"],
            bound_by="bytes", library_ms=None))

    # ---- 27. the denoiser's kernels ----------------------------------------
    denoise_held = _denoise_phase_27(dev, card)
    for name in DENOISE_LAUNCHES:
        by_shape = {}
        for shape in ("4K", "1080p"):
            h = denoise_held[f"denoise {shape} half-res"]
            ks = [k for k in h["ms"] if k.startswith(name)]
            by_shape[shape] = dict(
                ms=sum(h["ms"][k] for k in ks),
                bound_ms=sum(h["floor_ms"][k] for k in ks),
                plain_ms=h["plain_ms"], bound_by="bytes")
        kernels.append(dict(
            name=f"{name}_kernel", route="cuda",
            source="dust_tpu_torch/csrc/denoise.cu", replaces=None,
            launches=FRAMES * DENOISE_LAUNCHES[name], max_abs_err=0.0,
            **by_shape["1080p"], library_ms=None, gi_4k=by_shape["4K"]))

    # ---- 28. the final gather's kernels -----------------------------------
    gather_held = _gather_phase_28(dev, card)
    for name in GATHER_LAUNCHES:
        h = gather_held[f"gather gi {WIDTH}x{HEIGHT}"][name]
        h4 = gather_held[f"gather gi-4k {WIDTH_4K}x{HEIGHT_4K}"][name]
        kernels.append(dict(
            name=f"{name}_kernel", route="cuda",
            source="dust_tpu_torch/csrc/gbuffer.cu", replaces=None,
            launches=FRAMES, max_abs_err=0.0, ms=h["ms"],
            plain_ms=h["plain_ms"], bound_ms=h["bound_ms"], bound_by="bytes",
            library_ms=None, gi_4k=dict(ms=h4["ms"], bound_ms=h4["bound_ms"],
                                        bound_by="bytes")))

    for k in kernels:
        if k["name"].startswith("hdda_scene<"):
            mode = k["name"][len("hdda_scene<"):-1]
            k["launches_by_path"] = {"gi": k["launches"],
                                     "stress": stress_launches[mode],
                                     "hash-reference": hash_launches[mode]}
            k["launches_by_path"].update(
                {path: counts[mode] for path, counts in by_path.items()})
            k["launches_by_path"].update(
                {path: counts[mode] for path, counts in edit_launches.items()})
            h = held_4k[mode]
            k["gi_4k"] = dict(max_abs_err=h["err"], ms=h["ms"],
                              bound_ms=h["bound_ms"], bound_by=h["bound_by"])
        if k["name"] == "hdda_scene<rough>":
            k["hash_pool"] = {
                w: dict(rays=HASH_POOL, active_rays=h["active_rays"],
                        max_abs_err=h["err"], ms=h["ms"],
                        plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
                        bound_by=h["bound_by"])
                for w, h in pool_held.items()}
        if k["name"].startswith("hdda_instance<"):
            mode = k["name"][len("hdda_instance<"):-1]
            k["launches_by_path"] = {"stress": k["launches"],
                                     "edits loop": loop_launches[mode]}
            k["loop_frame"] = {path: by_mode[mode] for path, by_mode
                               in loop_frame_ms.items()}
    print(json.dumps({"eager_backend": eager, "gates": gates,
                      "edits": edit_times, "flythrough_sharded": sharded,
                      "tools": tools, "native": native_build,
                      "gbuffer": gbuffer_held, "spatial_hash": hash_held,
                      "denoise": denoise_held, "gather": gather_held}))
    for mode in hdda.MODES:
        h = stress_held[mode]
        print(f"stress hdda_scene<{mode}>: {h['ms']:.3f} ms per launch at "
              f"{WIDTH}x{HEIGHT}, {STRESS_INSTANCES} instances; bound "
              f"{h['bound_ms']:.4f} ms ({h['bound_by']}); "
              f"{100.0 * h['bound_ms'] / h['ms']:.2f}% of the bound [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
