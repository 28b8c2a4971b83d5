"""The whole frame under ``torch.profiler`` (port of
``tools/profile_frame.py``).

Renders the bench's ``gi`` frame (castle + the animated teapot, moved as
``tools/profile_frame.py`` moves it) for ``--frames`` frames under
``torch.profiler``, writes the Chrome trace into ``--out``, and prints
ms per frame (the trace's own cost included) and the table of the CUDA
kernels that took the most device time (on the CPU: the operators that
took the most host time, their callees included). The reference's HLO dump and
``tools/profile_attrib.py`` read XLA's compiled program, which the port
does not have; they are not ported.

Usage:
  python -m dust_tpu_torch.tools.profile_frame [--frames 8] [--out DIR]
      [--width W] [--height H] [--gi-cache dense|hash] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from dust_tpu_torch.bench import EYE, TARGET

TOP_KERNELS = 15


def profile(width: int, height: int, frames: int, out_dir: str, device,
            gi_cache: str = "dense", log=print) -> dict:
    """Renders ``frames`` profiled frames after two warm-up frames.
    Returns {"ms_per_frame", "trace" (the Chrome trace's path), "top"
    ([(name, device or host ms, calls)])}."""
    import torch
    from torch.profiler import ProfilerActivity

    from dust_tpu_torch.config import RenderSettings
    from dust_tpu_torch.ops import camera as cameralib
    from dust_tpu_torch.ops.noise import load_blue_noise
    from dust_tpu_torch.ops.sky import bake_sky
    from dust_tpu_torch.render.pipeline import make_frame_state, render_frame
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    device = torch.device(device)
    cuda = device.type == "cuda"
    settings = RenderSettings(
        width=width, height=height,
        traversal_backend="pallas" if cuda else "jnp", gi_cache=gi_cache)
    vox = load_vox_scene(procgen.castle_scene_bytes())
    anim = procgen.add_teapot(vox)
    scene = build_device_scene(vox, device)
    state = make_frame_state(settings, scene, device)
    sky = bake_sky(settings.sunlight, device)
    bn = load_blue_noise(device)
    base_o2w = scene.obj_to_world.cpu().numpy()
    cs = cameralib.camera_settings(
        cameralib.look_at(EYE, TARGET), settings.camera.fov,
        settings.camera.near, settings.camera.far, width, height, device)

    def step(state, f=0):
        sc = scene.with_transforms(procgen.teapot_motion(base_o2w, anim, f))
        out, _aux, state = render_frame(sc, state, cs, sky,
                                        bn.unitvec3_cosine, bn.scalar,
                                        settings, return_aux=False)
        return out, state

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    _out, state = step(state)
    sync()
    log(f"warm-up (kernel build, first frame) {time.perf_counter() - t0:.1f}s")
    _out, state = step(state, 1)
    sync()

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for k in range(frames):
            _out, state = step(state, k)
        sync()
        dt = (time.perf_counter() - t0) / frames
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"frame_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    log(f"{dt * 1e3:.3f} ms/frame over {frames} frames (incl. trace "
        f"overhead); Chrome trace {path}")

    # The profiler's raw events: building its Python event tree
    # (``prof.events()``) takes minutes for a frame's hundreds of
    # thousands of operators.
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device != cuda:
            continue
        total, calls = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (total + e.duration_ns(), calls + 1)
    top = sorted(((ns / 1e6, calls, name) for name, (ns, calls)
                  in by_name.items()), reverse=True)[:TOP_KERNELS]
    what = ("CUDA kernels by device" if cuda
            else "operators by host (inclusive)")
    log(f"{what} time over {frames} frames:")
    for ms, calls, name in top:
        log(f"  {ms:10.3f} ms {calls:7d} calls  {name[:100]}")
    return dict(ms_per_frame=1e3 * dt, trace=path,
                top=[(name, ms, calls) for ms, calls, name in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "dustprof"))
    ap.add_argument("--gi-cache", choices=["dense", "hash"], default="dense")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("profile_frame: no CUDA device (pass --device cpu to run the "
              "plain PyTorch versions on the CPU)", file=sys.stderr)
        return 2
    from dust_tpu_torch.bench import card_name

    print(f"# {args.width}x{args.height}, gi cache {args.gi_cache}, device "
          f"{card_name() if device.type == 'cuda' else 'cpu'}")
    profile(args.width, args.height, args.frames, args.out, device,
            args.gi_cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())
