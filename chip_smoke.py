#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the HDDA traversal kernel (dust_tpu_torch/csrc/hdda.cu) with nvcc;
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
   ao_threshold 11, rough 33; no scene-kernel launch), holds that kernel
   against its plain version per mode on a 65,536-ray subsample of a
   recorded launch (torch.equal) and times both on the full launch,
   prints ms/frame and Mrays/s, and checks the loop-route image
   against the batched-route image of the same frame (RMSE < 0.01);
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
   After each tier: the editor's tier, 6 scene-kernel launches per
   frame, every tensor of the card's scene equal (torch.equal) to a CPU
   editor's given the same edits, the dense GI albedo words equal to a
   fresh cache of the edited scene, and the scene kernel equal to its
   plain version on 65,536 of the frame's rays per mode; then one
   loop-route frame on the rebuilt tables with the instance kernels held
   the same way; a frame with and one without a leaf edit under
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
   dust_tpu_torch.parallel.dryrun --ranks 1 --device cuda).

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
# The ray-sharded GI frame: reference-mode sun shadows take two launches
# (ao_threshold, rough) in place of the fused ao_fg.
SHARDED_LAUNCHES = {"precise": 1, "ao_fg": 0, "ao_threshold": 2, "rough": 4}
# The eager backend: a 1080p frame over this many seconds is cut to
# 960x540; the lane-retirement intervals it is timed at.
EAGER_MAX_S = 10.0
SYNC_CHOICES = (1, 4, 8, 16, 32, 256, 32, 16, 8, 4)
# tests/test_quality.py's converged-ground-truth gates: the bounds, the
# frame counts, and tests/quality_setup.py's camera, hash and pool.
GT_PATH = os.path.join("tests", "golden", "castle_gt_256x256.npz")
GT_EYE, GT_TARGET = (150.0, 90.0, 180.0), (0.0, 30.0, 0.0)
GT_CAPACITY, GT_POOL = 1 << 18, 16384
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


def _hold(label, run, run_plain, full, tables, flops, plain_timed=True,
          timed=True):
    """Kernel against plain version on a subsample of the recorded launch
    ``full``: every output must be equal (torch.equal). Then, with
    ``timed``, the kernel is timed on the full launch, replayed from a
    CUDA graph (and, with ``plain_timed``, the plain version from the
    host); its bound counts ``flops`` float operations. Returns a dict:
    max |dt|, and with ``timed`` kernel ms, plain ms (or None), bound ms
    and what bounds it."""
    import torch

    sub = _subsample(full, SUBSAMPLE, tables)
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
    bound, bound_by = _bound(full + run(full), flops)
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
    from dust_tpu_torch.config import (DenoiserSettings, RenderSettings,
                                       SpatialHashSettings, SurfelSettings)
    from dust_tpu_torch.ops import camera as cameralib
    from dust_tpu_torch.ops import tonemap as tonemaplib
    from dust_tpu_torch.ops.noise import load_blue_noise
    from dust_tpu_torch.ops.sky import bake_sky
    from dust_tpu_torch.render.pipeline import make_frame_state, render_frame
    from dust_tpu_torch.render.scene import build_device_scene
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
        kw = dict(width=W, height=H, gi_cache="dense",
                  traversal_backend="pallas",
                  spatial_hash=SpatialHashSettings(capacity=GT_CAPACITY),
                  surfels=SurfelSettings(pool_size=GT_POOL))
        kw.update(overrides)
        s = RenderSettings(**kw)
        cam = cameralib.camera_settings(
            cameralib.look_at(GT_EYE, GT_TARGET), s.camera.fov,
            s.camera.near, s.camera.far, W, H, dev)
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

    def err(a, b):
        return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                      - np.asarray(b, np.float64)) ** 2)))

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

    # ---- interleaved: no edit, a leaf edit every frame, staged splices --
    reset_counts()
    times["base_ms"] = min(be.run(ctx, n), be.run(ctx, n))
    _check_launches(hdda.LAUNCHES, SCENE_LAUNCHES, 2 * n,
                    "edits baseline hdda_scene")
    launches["edits baseline"] = dict(hdda.LAUNCHES)
    reset_counts()
    times["leaf_ms"] = min(be.run(ctx, n, lambda f: be.leaf_edit(ctx, f)),
                           be.run(ctx, n, lambda f: be.leaf_edit(ctx, f)))
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
    every = max(n // 2, 1)
    times["splice_ms"] = min(
        be.run(ctx, n, lambda f: be.splice_step(ctx, f, every)),
        be.run(ctx, n, lambda f: be.splice_step(ctx, f, every)))
    be.land_splice(ctx)
    times["swap_frames"] = list(ctx["splice_swaps"])
    if not ctx["splice_swaps"]:
        raise SystemExit("edits: no staged splice swapped in")
    done = _edit_tier(hdda, "edits splice", ctx, cpu_ed, done, "splice",
                      2 * n, launches)

    # ---- one forced rebuild --------------------------------------------
    be.edit(ctx, be.slab_voxels(), 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx["scene"], ctx["state"] = ctx["editor"].refit(ctx["state"])
    torch.cuda.synchronize()
    times["rebuild_in_loop_ms"] = 1e3 * (time.perf_counter() - t0)
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
        first = {}
        reset_counts()
        _recording(hdda, "hdda_instance", lambda a, kw: first.setdefault(
            kw["mode"], a + (None,) * (8 - len(a))),
            lambda: be.render(ctx))
        per_frame = {m: ctx["scene"].num_instances * k
                     for m, k in SCENE_LAUNCHES.items()}
        _check_launches(hdda.INSTANCE_LAUNCHES, per_frame, 1,
                        "edits loop hdda_instance")
        _check_launches(hdda.LAUNCHES, NO_LAUNCHES, 1, "edits loop hdda_scene")
        loop_launches = dict(hdda.INSTANCE_LAUNCHES)
        torch.cuda.synchronize()
        for mode in hdda.MODES:
            _hold(f"edits loop hdda_instance {mode}",
                  lambda a, m=mode: hdda.hdda_instance(*a[:8], mode=m),
                  lambda a, m=mode: hdda.hdda_instance_plain(*a[:8], m),
                  first[mode], 3, 0, timed=False)
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
    return times, launches, loop_launches


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
    from dust_tpu_torch.ops import hdda

    from dust_tpu_torch import bench

    card = bench.card_name()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device(DEVICE)

    def reset_counts():
        for m in hdda.MODES:
            hdda.LAUNCHES[m] = 0
            hdda.INSTANCE_LAUNCHES[m] = 0

    def rmse(a, b):
        return float(np.sqrt(np.mean((a.float().cpu().numpy()
                                      - b.float().cpu().numpy()) ** 2)))

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    lib = hdda.build_library(verbose=True)
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

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
        busiest = {}

        def keep_busiest(args, kw):
            """Per mode, the launch with the most active rays."""
            args = args + (None,) * (8 - len(args))
            n_live = int((args[6] > args[5]).sum())
            if n_live > busiest.get(kw["mode"], (-1,))[0]:
                busiest[kw["mode"]] = (n_live, args)

        _recorded_frame(stress, first, hdda, "hdda_instance", keep_busiest)
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
        for mode in hdda.MODES:
            full = busiest[mode][1]

            def run(a, m=mode):
                return hdda.hdda_instance(*a[:8], mode=m)

            def run_plain(a, m=mode):
                return hdda.hdda_instance_plain(*a[:8], m)

            h = _hold(f"stress hdda_instance {mode}", run, run_plain, full, 3,
                      0)
            kernels.append(dict(
                name=f"hdda_instance<{mode}>", route="cuda",
                source="dust_tpu_torch/csrc/hdda.cu",
                replaces=REPLACES + ("1397" if mode == "ao_fg" else "1335"),
                launches=launches[mode], max_abs_err=h["err"], ms=h["ms"],
                plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
                bound_by=h["bound_by"], library_ms=None))
        del busiest
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
    edit_times, edit_launches, loop_launches = _edits_phase(
        hdda, dev, card, reset_counts, rmse)

    # ---- 18. the ray-sharded 4K flythrough on a one-rank NCCL group ----
    by_path["flythrough-sharded"], sharded = _sharded_phase(
        hdda, dev, card, reset_counts)

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
    print(json.dumps({"eager_backend": eager, "gates": gates,
                      "edits": edit_times, "flythrough_sharded": sharded}))
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
