"""The castle demo on the PyTorch port: procgen castle (+ the animated
teapot), the GI frame with either cache, PNG output.

Usage:
  python -m dust_tpu_torch.app.castle --width 1920 --height 1080 \\
      --frames 4 --teapot --out castle.png [--device cuda|cpu] \\
      [--gi-cache dense|hash] [--hash-capacity N] [--surfels N]

``--device`` defaults to ``cuda`` and fails when no CUDA device is
present; the CPU (every kernel's plain PyTorch version) runs only when
asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default="castle.png", help="PNG of the last frame")
    ap.add_argument("--teapot", action="store_true",
                    help="add the animated teapot (the headline scene)")
    ap.add_argument("--eye", type=float, nargs=3, default=(122.0, 300.61, 54.45))
    ap.add_argument("--target", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hash-capacity", type=int, default=1 << 20)
    ap.add_argument("--surfels", type=int, default=65536)
    ap.add_argument("--gi-cache", choices=["dense", "hash"], default="dense",
                    help="GI cache (dense = a row per leaf face, refreshed "
                    "every frame; hash = the spatial hash with a surfel pool)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("castle: no CUDA device (pass --device cpu to run the plain "
              "PyTorch versions on the CPU)", file=sys.stderr)
        return 2

    from dust_tpu_torch.config import (
        RenderSettings, SpatialHashSettings, SurfelSettings,
    )
    from dust_tpu_torch.utils.image import write_png
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene
    from dust_tpu_torch.ops import camera as cameralib
    from dust_tpu_torch.ops.noise import load_blue_noise
    from dust_tpu_torch.ops.sky import bake_sky
    from dust_tpu_torch.render.pipeline import make_frame_state, render_frame
    from dust_tpu_torch.render.scene import build_device_scene

    settings = RenderSettings(
        width=args.width, height=args.height,
        spatial_hash=SpatialHashSettings(capacity=args.hash_capacity),
        surfels=SurfelSettings(pool_size=args.surfels),
        gi_cache=args.gi_cache, traversal_backend="pallas")
    vox_scene = load_vox_scene(procgen.castle_scene_bytes())
    anim_idx = procgen.add_teapot(vox_scene) if args.teapot else None
    scene = build_device_scene(vox_scene, device)
    state = make_frame_state(settings, scene, device)
    sky = bake_sky(settings.sunlight, device)
    bn = load_blue_noise(device)
    base_o2w = scene.obj_to_world.cpu().numpy()
    cam = cameralib.camera_settings(
        cameralib.look_at(args.eye, args.target), settings.camera.fov,
        settings.camera.near, settings.camera.far, args.width, args.height,
        device)

    t0 = time.perf_counter()
    out = None
    for f in range(args.frames):
        if anim_idx is not None:
            scene = scene.with_transforms(
                procgen.teapot_motion(base_o2w, anim_idx, f))
        out, _aux, state = render_frame(scene, state, cam, sky,
                                        bn.unitvec3_cosine, bn.scalar,
                                        settings, return_aux=False)
    img = out.cpu().numpy()
    dt = time.perf_counter() - t0
    write_png(args.out, img)
    print(f"rendered {args.frames} frames at {args.width}x{args.height} on "
          f"{device} in {dt:.2f}s -> {args.out} (mean {img.mean():.3f})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
