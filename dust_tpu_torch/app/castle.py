"""The castle demo on the PyTorch port: a ``.vox`` scene or the procgen
castle (+ the animated teapot), the frame with either GI cache, PNG
output.

Usage:
  python -m dust_tpu_torch.app.castle --width 640 --height 360 \\
      --frames 8 --out castle.png [--scene castle.vox] [--teapot] \\
      [--orbit] [--all-frames] [--device cuda|cpu] [--backend jnp|pallas] \\
      [--tile N] [--gi-cache dense|hash] [--hash-capacity N] [--surfels N] \\
      [--frames-in-flight N]

The reference CLI's flags and defaults. ``--backend`` picks the traversal:
``jnp`` (the default, as the reference's) is the eager torch wavefront,
which carries no kernel; ``pallas`` is the HDDA kernel. ``--device``
defaults to ``cuda`` and fails when no CUDA device is present; the CPU
(every kernel's plain PyTorch version) runs only when asked for with
``--device cpu``. The output defaults to ``castle.png`` in the temporary
directory. ``--frames-in-flight N`` (default 3) lets the host run at
most N frames ahead of the device: a CUDA event is recorded after each
frame, and the host waits on the oldest one when more than N are
outstanding; 0 or less means no pacing. A crash writes a report into the
temporary directory (:mod:`dust_tpu_torch.utils.crashlog`), and the frame
times are logged (:class:`~dust_tpu_torch.utils.profiling.FrameDiagnostics`).
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys
import tempfile
import time
from collections import deque


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "castle.png"),
                    help="output PNG (last frame); _NNN inserted for "
                    "--all-frames")
    ap.add_argument("--all-frames", action="store_true",
                    help="write every frame")
    ap.add_argument("--scene", default=None,
                    help=".vox file (default: the procgen castle)")
    ap.add_argument("--teapot", action="store_true",
                    help="add the animated teapot")
    ap.add_argument("--eye", type=float, nargs=3, default=(150.0, 90.0, 180.0))
    ap.add_argument("--target", type=float, nargs=3, default=(0.0, 30.0, 0.0))
    ap.add_argument("--orbit", action="store_true", help="orbit the target")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=["jnp", "pallas"], default="jnp",
                    help="traversal: jnp = the eager torch wavefront, "
                    "pallas = the HDDA kernel")
    ap.add_argument("--tile", type=int, default=65536,
                    help="rays per walk of the jnp backend")
    ap.add_argument("--hash-capacity", type=int, default=1 << 20)
    ap.add_argument("--surfels", type=int, default=65536)
    ap.add_argument("--gi-cache", choices=["dense", "hash"], default="dense",
                    help="GI cache (dense = a row per leaf face, refreshed "
                    "every frame; hash = the spatial hash with a surfel pool)")
    ap.add_argument("--frames-in-flight", type=int, default=3,
                    help="frame pacing: most frames dispatched and not yet "
                    "finished on the device (rhyolite_bevy's 3 frames in "
                    "flight, queue.rs:222); 0 = no pacing")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("castle: no CUDA device (pass --device cpu to run the plain "
              "PyTorch versions on the CPU)", file=sys.stderr)
        return 2

    from dust_tpu_torch.config import (
        RenderSettings, SpatialHashSettings, SurfelSettings,
    )
    from dust_tpu_torch.utils import crashlog
    from dust_tpu_torch.utils.image import write_png
    from dust_tpu_torch.utils.profiling import FrameDiagnostics
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
        gi_cache=args.gi_cache, traversal_backend=args.backend)
    if args.scene:
        with open(args.scene, "rb") as f:
            vox_scene = load_vox_scene(f.read())
    else:
        vox_scene = load_vox_scene(procgen.castle_scene_bytes())
    anim_idx = procgen.add_teapot(vox_scene) if args.teapot else None
    scene = build_device_scene(vox_scene, device)
    state = make_frame_state(settings, scene, device)
    sky = bake_sky(settings.sunlight, device)
    bn = load_blue_noise(device)
    base_o2w = scene.obj_to_world.cpu().numpy()

    # Crash reports and frame-time diagnostics, like the reference's
    # SentryPlugin and FrameTimeDiagnosticsPlugin (examples/castle.rs:67).
    crashlog.install({"scene": args.scene or "procgen-castle",
                      "resolution": f"{args.width}x{args.height}"})
    logging.basicConfig(level=logging.INFO)
    diag = FrameDiagnostics(report_every=max(args.frames // 2, 2))

    # Frame pacing (rhyolite's frames in flight): a CUDA event per frame.
    # On the CPU every op has finished when it returns: nothing to pace.
    inflight: deque = deque()

    def pace():
        if args.frames_in_flight <= 0 or device.type != "cuda":
            return
        marker = torch.cuda.Event()
        marker.record()
        inflight.append(marker)
        if len(inflight) > args.frames_in_flight:
            inflight.popleft().synchronize()

    t0 = time.perf_counter()
    out = None
    for f in range(args.frames):
        eye = args.eye
        if args.orbit:
            ang = f * 0.05
            r = math.dist(args.eye[::2], args.target[::2])
            eye = (args.target[0] + r * math.sin(ang), args.eye[1],
                   args.target[2] + r * math.cos(ang))
        cam = cameralib.camera_settings(
            cameralib.look_at(eye, args.target), settings.camera.fov,
            settings.camera.near, settings.camera.far, args.width,
            args.height, device)
        if anim_idx is not None:
            scene = scene.with_transforms(
                procgen.teapot_motion(base_o2w, anim_idx, f))
        out, _aux, state = render_frame(scene, state, cam, sky,
                                        bn.unitvec3_cosine, bn.scalar,
                                        settings, tile=args.tile,
                                        return_aux=False)
        diag.frame()
        pace()
        if args.all_frames:
            path = args.out.replace(".png", f"_{f:03d}.png")
            write_png(path, out.cpu().numpy())
            print(f"frame {f}: {path}", file=sys.stderr)
    img = out.cpu().numpy()
    dt = time.perf_counter() - t0
    write_png(args.out, img)
    print(f"rendered {args.frames} frames at {args.width}x{args.height} on "
          f"{device} ({args.backend}) in {dt:.2f}s -> {args.out} (mean "
          f"{img.mean():.3f})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
