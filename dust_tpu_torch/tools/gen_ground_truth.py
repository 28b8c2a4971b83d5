"""The converged ground truth of the quality gates (port of
``tools/gen_ground_truth.py``).

Renders ``--warmup`` frames (the GI cache and the auto-exposure settle),
then ``--frames`` more of the canonical static scene (castle + the
teapot at rest, :mod:`~dust_tpu_torch.tools.quality_setup`'s settings
and camera) through the whole frame, and averages each frame's raw
radiance composite (``aux["radiance"]``: direct + indirect where a ray
hit, sky elsewhere, before the denoiser) as the blue-noise layers cycle.
The mean over 512 or more frames is a converged estimate of the frame's
signal, which ``tests/test_quality.py`` holds the denoised frames to.

Writes ``--out`` (default ``tests/golden/castle_gt_{W}x{H}.npz``) with
  radiance  (H, W, 3) float32 — the mean raw radiance
  albedo    (H, W, 3) float32 — the albedo image (the first accumulated frame's)
  output    (H, W, 3) float32 — tonemap(radiance, albedo, exposure)
  exposure  ()        float32 — the converged auto-exposure value
  frames, width, height
and the tonemapped PNG beside it (``.npz`` -> ``.png``).

On the card the traces take the HDDA kernel (``pallas``); with
``--device cpu`` (the reference's ``--cpu``) the eager backend
(``jnp``). As in the reference, ``output`` is tonemapped on the CPU,
where the CPU tests recompute it.

Usage:
  python -m dust_tpu_torch.tools.gen_ground_truth [--width 256]
      [--height 256] [--frames 512] [--warmup 64] [--device cuda|cpu]
      [--out PATH]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def ground_truth(width: int, height: int, frames: int, warmup: int, device,
                 log=print) -> dict:
    """The arrays the tool writes: radiance, albedo, output, exposure,
    frames, width, height (numpy)."""
    import torch

    from dust_tpu_torch.ops import exposure as exposurelib
    from dust_tpu_torch.ops import tonemap as tonemaplib
    from dust_tpu_torch.ops.noise import load_blue_noise
    from dust_tpu_torch.ops.sky import bake_sky
    from dust_tpu_torch.render.pipeline import make_frame_state, render_frame
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.tools.quality_setup import gt_camera, gt_settings
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    device = torch.device(device)
    W, H = width, height
    settings = gt_settings(W, H, backend="pallas" if device.type == "cuda"
                           else "jnp")
    vox = load_vox_scene(procgen.castle_scene_bytes())
    procgen.add_teapot(vox)  # the canonical scene, the teapot at rest
    scene = build_device_scene(vox, device)
    state = make_frame_state(settings, scene, device)
    sky = bake_sky(settings.sunlight, device)
    bn = load_blue_noise(device)
    cs = gt_camera(settings, W, H, device)

    acc = torch.zeros((H, W, 3), device=device)
    albedo = None
    for f in range(warmup + frames):
        out, aux, state = render_frame(scene, state, cs, sky,
                                       bn.unitvec3_cosine, bn.scalar, settings)
        if f >= warmup:
            acc = acc + aux["radiance"]
        if f == warmup:
            albedo = aux["albedo"]
        if f % 64 == 0:
            log(f"frame {f}: mean {float(out.float().mean()):.4f}")

    radiance = (acc / frames).cpu()
    exp_value = exposurelib.exposure_value(state.exposure_avg.cpu())
    output = tonemaplib.tonemap(radiance, albedo.cpu(), exp_value,
                                transfer="srgb")
    return dict(radiance=radiance.numpy(),
                albedo=albedo.cpu().numpy().astype(np.float32),
                output=output.numpy().astype(np.float32),
                exposure=np.float32(float(exp_value)), frames=frames,
                width=W, height=H)


def write(path: str, gt: dict) -> None:
    """``gt`` (:func:`ground_truth`'s arrays) as ``path`` (.npz) and the
    tonemapped PNG beside it."""
    from dust_tpu_torch.utils.image import write_png

    np.savez_compressed(path, **gt)
    write_png(path.replace(".npz", ".png"), gt["output"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=64,
                    help="frames before accumulation starts (GI cache + "
                    "auto-exposure convergence)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("gen_ground_truth: no CUDA device (pass --device cpu to run "
              "the plain PyTorch versions on the CPU)", file=sys.stderr)
        return 2
    W, H = args.width, args.height
    gt = ground_truth(W, H, args.frames, args.warmup, device)
    out_path = args.out or f"tests/golden/castle_gt_{W}x{H}.npz"
    write(out_path, gt)
    print(f"wrote {out_path} (exposure {float(gt['exposure']):.4f}, "
          f"{args.frames} frames @ {W}x{H})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
