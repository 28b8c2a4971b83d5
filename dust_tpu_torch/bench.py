"""The port's benchmark: one of ``bench.py``'s configs, Mrays/s on one card.

Usage:
  python -m dust_tpu_torch.bench [--config gi|primary-shadow|gi-4k|
      hash-reference|stress|flythrough] [--device cuda|cpu]
      [--backend pallas|jnp] [--width W] [--height H] [--frames N]
      [--tile N] [--gi-cache dense|hash] [--hash-capacity N]
      [--ws-slices N] [--pool-budget N] [--no-teapot] [--small]

Prints ONE JSON line on stdout with the reference bench's keys:
  {"metric": "Mrays/s/chip (castle+teapot 1920x1080, 1-bounce GI)",
   "value": N, "unit": "Mrays/s", "vs_baseline": N}
and one line on stderr with ms/frame, the frame count, rays per frame,
the warm-up time and the device (on a card: its name and power limit as
``nvidia-smi`` gives them). ``vs_baseline = value / 500``, the
reference bench's pinned 500 Mrays/s.

The configs, scenes, cameras, warm-up, auto-scaled timed loop and ray
accounting are ``bench.py``'s. ``--device`` defaults to ``cuda`` and the
run fails without a CUDA device; ``--device cpu`` runs every kernel's
plain version. The traversal backend defaults to ``pallas`` (the HDDA
kernel) on the card and to ``jnp`` (the eager torch traversal) on the
CPU. There is no retry and no backend fallback: a failure exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

CONFIGS = ("gi", "primary-shadow", "gi-4k", "hash-reference", "stress",
           "flythrough")
BASELINE_MRAYS = 500.0
# The reference's canonical camera poses; every config looks at the origin.
EYE = (122.0, 300.61, 54.45)
STRESS_EYE = (260.0, 420.0, 180.0)
TARGET = (0.0, 0.0, 0.0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--small", action="store_true", help="tiny smoke run")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--tile", type=int, default=65536,
                    help="rays per walk of the jnp backend")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=["pallas", "jnp"], default=None)
    ap.add_argument("--gi-cache", choices=["dense", "hash"], default="dense")
    ap.add_argument("--hash-capacity", type=int, default=None,
                    help="spatial-hash capacity for --gi-cache hash")
    ap.add_argument("--ws-slices", type=int, default=1,
                    help="hash mode: re-probe a rotating 1/N of the GI "
                    "working set per frame")
    ap.add_argument("--pool-budget", type=int, default=0,
                    help="hash mode: trace a rotating slice of this many "
                    "surfel-pool slots per frame (0 = the whole pool)")
    ap.add_argument("--config", default=None, choices=CONFIGS,
                    help="gi = castle+teapot 1080p 1-bounce GI (default); "
                    "primary-shadow = direct light only; gi-4k = "
                    "3840x2160; hash-reference = a 2^25-slot hash and a "
                    "720x480 pool; stress = 3x3 castles + 2 teapots; "
                    "flythrough = gi-4k with an orbiting camera")
    ap.add_argument("--no-teapot", action="store_true",
                    help="drop the animated teapot (castle only)")
    args = ap.parse_args(argv)
    if args.config in ("gi-4k", "flythrough"):
        args.width, args.height = args.width or 3840, args.height or 2160
    elif args.config == "hash-reference":
        args.gi_cache = "hash"
        args.hash_capacity = args.hash_capacity or (1 << 25)
    return args


def settings_for(args):
    """The RenderSettings of ``args`` (bench.py's, with the backend
    defaulting by device)."""
    from dust_tpu_torch.config import (RenderSettings, SpatialHashSettings,
                                       SurfelSettings)

    if args.small:
        width, height = args.width or 320, args.height or 180
        pool, cap = 16384, 1 << 18
    else:
        width, height = args.width or 1920, args.height or 1080
        pool, cap = 720 * 480, 1 << 22
    if args.hash_capacity:
        cap = args.hash_capacity
    direct_only = args.config == "primary-shadow"
    on_card = args.device.startswith("cuda")
    return RenderSettings(
        width=width, height=height,
        spatial_hash=SpatialHashSettings(capacity=cap,
                                         ws_refresh_slices=args.ws_slices),
        surfels=SurfelSettings(pool_size=pool,
                               pool_refresh_budget=args.pool_budget),
        traversal_backend=args.backend or ("pallas" if on_card else "jnp"),
        gi_cache=args.gi_cache,
        contribution_secondary_spatial_hash=not direct_only,
        contribution_secondary_skylight=not direct_only,
        contribution_secondary_sunlight=not direct_only)


def vox_scene_for(args):
    """(the loaded scene, the animated teapot's instance index or None)."""
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    if args.config == "stress":
        return procgen.stress_scene()
    vox = load_vox_scene(procgen.castle_scene_bytes())
    return vox, None if args.no_teapot else procgen.add_teapot(vox)


def eye_for(args, frame: int):
    """The camera eye of ``frame``: fixed, or on flythrough the orbit of
    the reference CLI (0.05 rad a frame about the target)."""
    eye = STRESS_EYE if args.config == "stress" else EYE
    if args.config != "flythrough":
        return eye
    ang = frame * 0.05
    r = math.dist((eye[0], eye[2]), (TARGET[0], TARGET[2]))
    return (TARGET[0] + r * math.sin(ang), eye[1],
            TARGET[2] + r * math.cos(ang))


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def metric_name(args, width: int, height: int) -> str:
    kind = ("primary+shadow" if args.config == "primary-shadow" else
            "1-bounce GI, 32Mi hash" if args.config == "hash-reference" else
            "1-bounce GI, orbit flythrough" if args.config == "flythrough"
            else "1-bounce GI")
    workload = ("3x3 castle grid + 2 teapots" if args.config == "stress"
                else "castle" if args.no_teapot else "castle+teapot")
    return f"Mrays/s/chip ({workload} {width}x{height}, {kind})"


def setup(args, device, settings=None) -> dict:
    """What a run of ``args`` renders from, on ``device``: the settings
    (``settings_for(args)`` unless given), the scene, the animated
    teapot, the first frame's state, the sky, the blue noise and the
    fixed camera."""
    from dust_tpu_torch.ops.noise import load_blue_noise
    from dust_tpu_torch.ops.sky import bake_sky
    from dust_tpu_torch.render.pipeline import make_frame_state
    from dust_tpu_torch.render.scene import build_device_scene

    settings = settings or settings_for(args)
    vox, anim = vox_scene_for(args)
    scene = build_device_scene(vox, device)
    ctx = dict(args=args, device=device, settings=settings, scene=scene,
               anim=anim, base_o2w=scene.obj_to_world.cpu().numpy(),
               state=make_frame_state(settings, scene, device),
               sky=bake_sky(settings.sunlight, device),
               bn=load_blue_noise(device))
    ctx["cam"] = camera_for(ctx, 0)
    return ctx


def camera_for(ctx, frame: int):
    """The camera of ``frame`` (see :func:`eye_for`)."""
    from dust_tpu_torch.ops import camera as cameralib

    s = ctx["settings"]
    return cameralib.camera_settings(
        cameralib.look_at(eye_for(ctx["args"], frame), TARGET), s.camera.fov,
        s.camera.near, s.camera.far, s.width, s.height, ctx["device"])


def render(ctx, state, frame: int = 0, return_aux: bool = False):
    """Frame ``frame`` from ``state``: the teapot moved, on flythrough
    the camera too. Returns (output, aux, new state)."""
    from dust_tpu_torch.render.pipeline import render_frame
    from dust_tpu_torch.vox import procgen

    scene = ctx["scene"]
    if ctx["anim"] is not None:
        scene = scene.with_transforms(
            procgen.teapot_motion(ctx["base_o2w"], ctx["anim"], frame))
    args = ctx["args"]
    cam = (camera_for(ctx, frame) if args.config == "flythrough"
           else ctx["cam"])
    bn = ctx["bn"]
    return render_frame(scene, state, cam, ctx["sky"], bn.unitvec3_cosine,
                        bn.scalar, ctx["settings"], tile=args.tile,
                        return_aux=return_aux)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device (pass --device cpu to run the plain "
              "PyTorch versions on the CPU)", file=sys.stderr)
        return 2

    from dust_tpu_torch.render.pipeline import frame_ray_count

    ctx = setup(args, device)
    settings, scene, state = ctx["settings"], ctx["scene"], ctx["state"]
    width, height = settings.width, settings.height
    frames = min(args.frames, 4) if args.small else args.frames

    def step(state, f=0):
        out, _aux, state = render(ctx, state, f)
        return out, state

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Warm-up: the kernel build and the caches' first fill.
    t0 = time.perf_counter()
    out, state = step(state)
    sync()
    warmup_s = time.perf_counter() - t0
    out, state = step(state)
    sync()

    t0 = time.perf_counter()
    sync()
    roundtrip = time.perf_counter() - t0

    # Auto-scale the timed loop until it dwarfs the sync round trip.
    measured = frames
    while True:
        t0 = time.perf_counter()
        for k in range(measured):
            out, state = step(state, k)
        sync()
        elapsed = time.perf_counter() - t0
        if elapsed > max(12.0 * roundtrip, 0.25) or measured >= 64 * frames:
            break
        measured *= 4
    dt = max(elapsed - roundtrip, 1e-9) / measured

    rays = frame_ray_count(scene, settings)
    mrays = rays / dt / 1e6
    print(json.dumps({
        "metric": metric_name(args, width, height),
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
    }))
    where = card_name() if device.type == "cuda" else "cpu"
    print(f"# {width}x{height}, {measured} frames, {dt * 1e3:.2f} ms/frame "
          f"({1.0 / dt:.1f} fps), {rays / 1e6:.4f} Mrays/frame, warm-up "
          f"{warmup_s:.1f}s, backend {settings.traversal_backend}, device "
          f"{where}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
