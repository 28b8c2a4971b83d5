#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the HDDA traversal kernel (dust_tpu_torch/csrc/hdda.cu) with nvcc;
3. renders one 1920x1080 castle+teapot frame of the dense-GI configuration
   while recording every traversal launch, then holds the kernel against
   its plain PyTorch version on the card, per mode, on a 65,536-ray
   subsample of that mode's real rays (hit, instance and leaf row must
   agree on at least 99.7% of rays), and times both on the full ray set;
4. the slice: resets the launch counts, renders 4 frames through
   render_frame on the card, checks 6 kernel launches per frame and a
   finite, non-black image, and prints ms/frame and Mrays/s;
5. renders a 256x144 frame on the card and on the CPU (plain versions)
   and checks that the two images agree (RMSE < 0.01).

Exits non-zero, with no result line, when there is no CUDA device or any
phase fails. The last line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""

import json
import os
import subprocess
import sys
import time

WIDTH, HEIGHT = 1920, 1080
FRAMES = 4
SUBSAMPLE = 65536
MIN_AGREEMENT = 0.997
EYE, TARGET = (122.0, 300.61, 54.45), (0.0, 0.0, 0.0)  # bench.py --config gi


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _setup(device, width, height):
    from dust_tpu.config import RenderSettings
    from dust_tpu.vox import procgen
    from dust_tpu.vox.loader import load_vox_scene
    from dust_tpu_torch.ops import camera as cameralib
    from dust_tpu_torch.ops.noise import load_blue_noise
    from dust_tpu_torch.ops.sky import bake_sky
    from dust_tpu_torch.render.pipeline import make_frame_state
    from dust_tpu_torch.render.scene import build_device_scene

    settings = RenderSettings(width=width, height=height, gi_cache="dense",
                              traversal_backend="pallas")
    vox = load_vox_scene(procgen.castle_scene_bytes())
    anim = procgen.add_teapot(vox)
    scene = build_device_scene(vox, device)
    cam = cameralib.camera_settings(
        cameralib.look_at(EYE, TARGET), settings.camera.fov,
        settings.camera.near, settings.camera.far, width, height, device)
    return dict(settings=settings, scene=scene, anim=anim, cam=cam,
                base_o2w=scene.obj_to_world.cpu().numpy(),
                state=make_frame_state(settings, scene, device),
                sky=bake_sky(settings.sunlight, device),
                bn=load_blue_noise(device))


def _frames(ctx, count, first=0):
    """Render ``count`` frames (animated teapot); returns the last output."""
    from dust_tpu.vox import procgen
    from dust_tpu_torch.render.pipeline import render_frame

    out = None
    for f in range(first, first + count):
        scene = ctx["scene"].with_transforms(
            procgen.teapot_motion(ctx["base_o2w"], ctx["anim"], f))
        out, _aux, ctx["state"] = render_frame(
            scene, ctx["state"], ctx["cam"], ctx["sky"],
            ctx["bn"].unitvec3_cosine, ctx["settings"], return_aux=False)
    return out


def _ms(fn, reps):
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


def _subsample(args, n_keep, seed=0):
    """``n_keep`` rays of a recorded launch, active rays first (seeded)."""
    import numpy as np
    import torch

    rays = list(args[7:])
    t_min, t_max = rays[2], rays[3]
    active = torch.nonzero(t_max >= t_min).flatten().cpu().numpy()
    rest = np.setdiff1d(np.arange(t_min.shape[0]), active)
    rng = np.random.default_rng(seed)
    pick = rng.permutation(active)[:n_keep]
    if len(pick) < n_keep:
        pick = np.concatenate([pick, rng.permutation(rest)[:n_keep - len(pick)]])
    idx = torch.as_tensor(np.sort(pick), device=t_min.device)
    return args[:7] + tuple(None if r is None else r[idx].contiguous()
                            for r in rays)


def _compare(mode, out_k, out_p):
    """Agreement of kernel and plain outputs: (agreement, max |dt|)."""
    import torch

    fused = mode == "ao_fg"
    ids = (1, 3, 4) if fused else (1, 2, 3)
    ok = torch.ones_like(out_k[1], dtype=torch.bool)
    for k in ids:
        ok &= out_k[k] == out_p[k]
    err = 0.0
    for k in ((0, 2) if fused else (0,)):
        both = torch.isfinite(out_k[k]) & torch.isfinite(out_p[k])
        ok &= torch.isfinite(out_k[k]) == torch.isfinite(out_p[k])
        if both.any():
            err = max(err, float((out_k[k][both] - out_p[k][both]).abs().max()))
    return float(ok.float().mean()), err


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
    from dust_tpu_torch.render.pipeline import frame_ray_count

    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda:0")

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    lib = hdda.build_library(verbose=True)
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernel against plain, per mode, on one frame's real rays ---
    ctx = _setup(dev, WIDTH, HEIGHT)
    recorded = []
    launch = hdda.hdda

    def record(*args, **kw):
        recorded.append((args + (kw.get("t_ao"),), kw["mode"]))
        return launch(*args, **kw)

    hdda.hdda = record
    try:
        _frames(ctx, 1)
    finally:
        hdda.hdda = launch
    torch.cuda.synchronize()
    first = {}
    for args, mode in recorded:
        first.setdefault(mode, args)
    kernels = []
    for mode in hdda.MODES:
        full = first[mode]
        sub = _subsample(full, SUBSAMPLE)

        def run(a, m=mode):
            return hdda.hdda(*a[:11], t_ao=a[11], mode=m)

        def run_plain(a, m=mode):
            return hdda.hdda_plain(*a[:12], mode=m)

        agree, err = _compare(mode, run(sub), run_plain(sub))
        n_hit = int((run(sub)[1] >= 0).sum())
        print(f"{mode:12s} kernel vs plain on {SUBSAMPLE} rays: agreement "
              f"{agree:.6f} ({n_hit} hits), max |dt| {err:.3g}")
        if agree < MIN_AGREEMENT:
            raise SystemExit(f"{mode}: kernel and plain agree on {agree:.4%}")
        ms = _ms(lambda: run(full), 10)
        plain_ms = _ms(lambda: run_plain(full), 1)
        n_rays = full[7].shape[0]
        print(f"{mode:12s} full launch ({n_rays} rays): kernel {ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms")
        kernels.append(dict(name=f"hdda_scene<{mode}>", route="cuda",
                            source="dust_tpu_torch/csrc/hdda.cu",
                            replaces="dust_tpu/ops/pallas_trace.py:1305",
                            launches=0, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms))
    del recorded, first

    # ---- 4. the slice: 4 frames through render_frame on the card -------
    for m in hdda.MODES:
        hdda.LAUNCHES[m] = 0
    times = []
    for f in range(FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _frames(ctx, 1, first=1 + f)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(hdda.LAUNCHES)
    print(f"launches over {FRAMES} frames: {launches}")
    expected = {"precise": 1, "ao_fg": 1, "ao_threshold": 1, "rough": 3}
    for m, per_frame in expected.items():
        if launches[m] != per_frame * FRAMES:
            raise SystemExit(f"{m}: {launches[m]} launches, expected "
                             f"{per_frame * FRAMES}")
    for k in kernels:
        k["launches"] = launches[k["name"][len("hdda_scene<"):-1]]
    img = out.float()
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(
            torch.isfinite(img).all()):
        raise SystemExit("frame output is not a finite (H, W, 3) image")
    mean = float(img.mean())
    if mean < 0.02:
        raise SystemExit(f"frame output is black (mean {mean:.4f})")
    rays = frame_ray_count(ctx["scene"], ctx["settings"])
    steady = times[1:]
    ms_frame = 1e3 * sum(steady) / len(steady)
    print(f"frame {WIDTH}x{HEIGHT} castle+teapot dense GI: "
          f"{ms_frame:.2f} ms/frame (frames 2-{FRAMES}; all: "
          f"{', '.join(f'{1e3 * t:.1f}' for t in times)} ms), "
          f"{rays / 1e6:.3f} Mrays/frame, {rays / (ms_frame * 1e3):.1f} Mrays/s, "
          f"mean {mean:.4f} [{card}]")
    del ctx

    # ---- 5. the same frame small, on the card and on the CPU -----------
    imgs = []
    for d in (dev, torch.device("cpu")):
        small = _setup(d, 256, 144)
        imgs.append(_frames(small, 2).float().cpu().numpy())
    rmse = float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2)))
    print(f"256x144, 2 frames: card vs CPU plain RMSE {rmse:.5f}")
    if not rmse < 0.01:
        raise SystemExit(f"card and CPU frames differ: RMSE {rmse:.5f}")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
