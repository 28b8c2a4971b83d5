"""Each trace pass alone, on a frame's real rays (port of
``tools/bench_trace.py``).

Builds the canonical castle+teapot scene and the ray sets of a frame:
camera rays in the kernel's 8×128-pixel tile order; sun shadow rays and
cosine GI rays (page 0 of the cosine blue noise) from the primary hits.
Then times each pass through the port's scene entry points
(:func:`~dust_tpu_torch.ops.hdda.trace_scene`,
:func:`~dust_tpu_torch.ops.hdda.trace_scene_ao_fg`): ``--reps`` launches
per timing, each launch's ``t_max`` lowered by 1e-3 per repetition as
the reference's burst does, best of three. For each pass it prints ms
per launch on the host clock (between two ``torch.cuda.synchronize()``)
and on the device (CUDA events), Mrays/s, the hit rate and the checksum
(the sum of the finite hit distances of the last burst).

Usage:
  python -m dust_tpu_torch.tools.bench_trace [--passes primary,shadow,ao,fg,aofg]
      [--reps 12] [--no-teapot] [--width W] [--height H] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and fails without a CUDA device;
``--device cpu`` runs the kernel's plain version (small sizes only).
"""

from __future__ import annotations

import argparse
import sys

from dust_tpu_torch.bench import EYE, TARGET

PASSES = ("primary", "shadow", "ao", "fg", "aofg")
NEAR, FAR = 0.1, 1e5


def build_scene(device, teapot: bool = True):
    """The castle (and the teapot at rest) on ``device``."""
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    vox = load_vox_scene(procgen.castle_scene_bytes())
    if teapot:
        procgen.add_teapot(vox)
    return build_device_scene(vox, device)


def build_rays(scene, width: int, height: int, device):
    """The frame's ray sets, as ``tools/bench_trace.py`` builds them.
    Returns ({pass: (origin, direction, t_min, t_max, mode)}, the primary
    TraceResult)."""
    import torch

    from dust_tpu_torch.config import RenderSettings
    from dust_tpu_torch.ops import camera as cameralib
    from dust_tpu_torch.ops import noise as noiselib
    from dust_tpu_torch.ops import packing as pk
    from dust_tpu_torch.ops import shade
    from dust_tpu_torch.ops.hdda import trace_scene
    from dust_tpu_torch.render.pipeline import _tiling

    W, H = width, height
    n = W * H
    settings = RenderSettings(width=W, height=H)
    cs = cameralib.camera_settings(cameralib.look_at(EYE, TARGET),
                                   settings.camera.fov, NEAR, FAR, W, H,
                                   device)
    to_tiles, _ = _tiling(H, W, True)
    dirs = to_tiles(cameralib.camera_ray_dirs(cs, W, H)).contiguous()
    origins = cs.position.expand(n, 3).contiguous()

    primary = trace_scene(scene, origins, dirs, NEAR, FAR, mode="precise")
    g = shade.resolve_hits(scene, primary, origins, dirs)
    hit, normal = g["hit"], g["normal"]
    hit_loc = g["world_pos"] + normal * 0.01
    bn = noiselib.load_blue_noise(device)
    noise = noiselib.bn_fetch(bn.unitvec3_cosine, 0, (0, 0), 0, H, W)
    cos = to_tiles(noise) * 2.0 - 1.0
    gi_dir = pk.rotate_vector_by_normal(normal, cos)
    up = torch.tensor([0.0, 1.0, 0.0], device=device)
    gi_dir = torch.where(hit[:, None], gi_dir, up)
    sun = torch.tensor(settings.sunlight.direction, dtype=torch.float32,
                       device=device).expand(n, 3).contiguous()

    def where_hit(t):
        return torch.where(hit, t, -1.0)

    rays = {
        "primary": (origins, dirs, NEAR, torch.full((n,), FAR, device=device),
                    "precise"),
        "shadow": (hit_loc, sun, 0.1, where_hit(1e4), "precise"),
        "ao": (hit_loc, gi_dir, 0.1, where_hit(8.0), "ao_threshold"),
        "fg": (hit_loc, gi_dir, 8.0, where_hit(1e5), "rough"),
        # The frame's sun-NEE walk (shadow_mode="reference"): the fused
        # near-threshold DDA and far block-granular rough.
        "aofg": (hit_loc, sun, 0.1, where_hit(1e4), "ao_fg"),
    }
    return rays, primary


def _finite_sum(t):
    import torch

    return torch.where(torch.isfinite(t), t, 0.0).sum()


def trace_pass(scene, rays, j: int = 0):
    """One launch of a pass (its ``t_max`` lowered by ``1e-3 * j``).
    Returns (sum of finite hit distances, rays that hit)."""
    import torch

    from dust_tpu_torch.ops.hdda import trace_scene, trace_scene_ao_fg

    o, d, t_min, tx, mode = rays
    t_max = tx - 1e-3 * j
    if mode == "ao_fg":
        t_ao = torch.where(tx > 0, 8.0, -1.0)
        near, far = trace_scene_ao_fg(scene, o, d, t_min, t_ao, t_max)
        return (_finite_sum(near.t) + _finite_sum(far.t),
                (near.hit | far.hit).sum())
    r = trace_scene(scene, o, d, t_min, t_max, mode=mode)
    return _finite_sum(r.t), r.hit.sum()


def burst(scene, rays, reps: int):
    """``reps`` launches of a pass: (checksum, hits) summed over them."""
    acc, hits = 0.0, 0
    for j in range(reps):
        a, h = trace_pass(scene, rays, j)
        acc, hits = acc + a, hits + h
    return acc, hits


def run(scene, rays, passes, reps: int, device, log=print) -> dict:
    """Times each pass in ``passes`` (a burst of ``reps`` launches, after
    one warm-up burst, best of three) and prints its line. Returns {pass:
    {"ms", "device_ms", "mrays_s", "hit_rate", "checksum",
    "launches"}}: ms per launch (host clock, synced), device ms per
    launch (CUDA events; None on the CPU), and the scene-kernel launches
    the pass made, by mode."""
    from dust_tpu_torch.ops import hdda
    from dust_tpu_torch.utils.profiling import best_of

    out = {}
    for name in passes:
        n = rays[name][0].shape[0]
        before = dict(hdda.LAUNCHES)
        (acc, hits), host_s, dev_ms = best_of(
            lambda: burst(scene, rays[name], reps), 3, device)
        best = host_s / reps
        res = dict(ms=1e3 * best,
                   device_ms=None if dev_ms is None else dev_ms / reps,
                   mrays_s=n / best / 1e6,
                   hit_rate=float(hits) / reps / n, checksum=float(acc),
                   launches={m: hdda.LAUNCHES[m] - before[m]
                             for m in hdda.MODES})
        out[name] = res
        dev = ("" if res["device_ms"] is None
               else f"  device {res['device_ms']:.4f} ms")
        log(f"{name:8s}: {res['ms']:8.4f} ms  ({res['mrays_s']:7.1f} Mrays/s)"
            f"{dev}  hit-rate {res['hit_rate']:.4f}  checksum "
            f"{res['checksum']:.6e}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--no-teapot", action="store_true")
    ap.add_argument("--passes", default=",".join(PASSES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    passes = args.passes.split(",")
    unknown = sorted(set(passes) - set(PASSES))
    if unknown:
        ap.error(f"unknown passes {unknown}; choose from {PASSES}")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_trace: no CUDA device (pass --device cpu to run the "
              "plain PyTorch versions on the CPU)", file=sys.stderr)
        return 2
    from dust_tpu_torch.bench import card_name

    scene = build_scene(device, teapot=not args.no_teapot)
    rays, _ = build_rays(scene, args.width, args.height, device)
    print(f"# {args.width}x{args.height}, {args.reps} launches per timing, "
          f"device {card_name() if device.type == 'cuda' else 'cpu'}")
    run(scene, rays, passes, args.reps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
