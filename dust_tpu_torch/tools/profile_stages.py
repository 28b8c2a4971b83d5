"""Each stage of the frame timed alone (port of ``tools/profile_stages.py``).

Builds the castle scene and the hash frame's settings (``--cap`` slots,
a ``--pool`` surfel pool), then runs render_frame's stages one at a
time on real inputs: the four traces, ``resolve_hits``,
``leaf_attributes``, ``hash_get`` and ``_pool_enqueue_mod`` at the
frame's ray count, the surfel trace, ``hash_get`` and ``hash_insert`` at
the pool's, the denoiser, the exposure histogram and ``tonemap``, and
the full frame. Each is timed best of ``--reps`` calls after a warm-up
call, on the host clock between two ``torch.cuda.synchronize()`` and on
the device between CUDA events. The names and the ``--stages`` groups
(``trace``, ``shade``, ``surfel``, ``post``, ``frame``) are the
reference's. The reference subtracts the round trip of a remote TPU
from each time; a local card has none, so nothing is subtracted here.
The denoiser stage runs on a full-resolution history, the size of its
inputs. The surfel rays come from a seeded torch generator, not from
``jax.random``: the same distribution, not the same values.

Usage:
  python -m dust_tpu_torch.tools.profile_stages [--width W --height H]
      [--pool P] [--cap C] [--reps N] [--stages trace,shade,...]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

from dust_tpu_torch.bench import EYE, TARGET

STAGES = ("trace", "shade", "surfel", "post", "frame")


def profile(width: int, height: int, pool: int, cap: int, reps: int,
            device, stages=(), log=print) -> dict:
    """Times the stages of ``stages`` (every group when empty); prints a
    line per stage. Returns {stage name: (host ms, device ms or None)}."""
    import torch

    from dust_tpu_torch.config import (RenderSettings, SpatialHashSettings,
                                       SurfelSettings)
    from dust_tpu_torch.ops import camera as cameralib
    from dust_tpu_torch.ops import denoise as denoiselib
    from dust_tpu_torch.ops import exposure as exposurelib
    from dust_tpu_torch.ops import packing as pk
    from dust_tpu_torch.ops import shade
    from dust_tpu_torch.ops import sky as skylib
    from dust_tpu_torch.ops import spatial_hash as sh
    from dust_tpu_torch.ops import tonemap as tonemaplib
    from dust_tpu_torch.ops.hdda import trace_scene
    from dust_tpu_torch.ops.noise import load_blue_noise
    from dust_tpu_torch.render.pipeline import (_pool_enqueue_mod,
                                                make_frame_state,
                                                render_frame)
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.utils.profiling import best_of
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    device = torch.device(device)
    W, H = width, height
    n = W * H
    settings = RenderSettings(
        width=W, height=H,
        spatial_hash=SpatialHashSettings(capacity=cap),
        surfels=SurfelSettings(pool_size=pool),
        traversal_backend="pallas" if device.type == "cuda" else "jnp")
    scene = build_device_scene(load_vox_scene(procgen.castle_scene_bytes()),
                               device)
    state = make_frame_state(settings, scene, device)
    sky = skylib.bake_sky(settings.sunlight, device)
    bn = load_blue_noise(device)
    cs = cameralib.camera_settings(cameralib.look_at(EYE, TARGET),
                                   settings.camera.fov, settings.camera.near,
                                   settings.camera.far, W, H, device)
    times = {}

    def bench(name, fn):
        out, host_s, dev_ms = best_of(fn, reps, device)
        times[name] = (1e3 * host_s, dev_ms)
        dev = "-" if dev_ms is None else f"{dev_ms:8.3f}"
        log(f"{name:34s} {1e3 * host_s:8.3f} ms  device {dev} ms")
        return out

    only = set(stages)

    def want(s):
        return not only or s in only

    def trace(o, d, tn, tx, mode):
        return trace_scene(scene, o, d, tn, tx, mode=mode)

    # ---- ray setup (as the frame's, raster order) ----------------------
    dirs = cameralib.camera_ray_dirs(cs, W, H).reshape(n, 3)
    origins = cs.position.expand(n, 3).contiguous()

    def primary_trace():
        return trace(origins, dirs, cs.near, cs.far, "precise")

    primary = (bench("primary trace (precise)", primary_trace)
               if want("trace") else primary_trace())
    g = shade.resolve_hits(scene, primary, origins, dirs)
    hit, normal = g["hit"], g["normal"]
    hit_loc = g["world_pos"] + normal * 0.01
    sun = sky.direction.expand(n, 3).contiguous()

    pix = torch.arange(n, device=device)
    pix_y, pix_x = pix // W, pix % W
    cos = bn.unitvec3_cosine[0, pix_y % 128, pix_x % 128] * 2.0 - 1.0
    gi_dir = pk.rotate_vector_by_normal(normal, cos)
    gi_dir = torch.where(hit[:, None], gi_dir,
                         torch.tensor([0.0, 1.0, 0.0], device=device))

    def ao_trace():
        return trace(hit_loc, gi_dir, 0.1, torch.where(hit, 8.0, -1.0),
                     "ao_threshold")

    def fg_trace(ao):
        return trace(hit_loc, gi_dir, 8.0,
                     torch.where(hit & ~ao.hit, cs.far, -1.0), "rough")

    if want("trace"):
        bench("resolve_hits",
              lambda: shade.resolve_hits(scene, primary, origins, dirs))
        bench("shadow trace (precise)",
              lambda: trace(hit_loc, sun, 0.1,
                            torch.where(hit, 10000.0, -1.0), "precise"))
        ao = bench("AO trace (ao_threshold)", ao_trace)
        fg = bench("FG trace (rough)", lambda: fg_trace(ao))
    else:
        ao = ao_trace()
        fg = fg_trace(ao)

    if want("shade"):
        leaf = bench("leaf_attributes (2M)", lambda: shade.leaf_attributes(
            scene, fg, hit_loc, gi_dir, settings.spatial_hash.cell_size))
        bench("hash_get (2M)",
              lambda: sh.hash_get(state.gi, leaf["qpos"], leaf["face"]))
        rows = torch.cat([leaf["center_world"],
                          leaf["face"].float()[:, None]], dim=-1)
        bench("pool_enqueue_mod (2M->pool)",
              lambda: _pool_enqueue_mod(state.surfels, fg.hit, rows))

    p = pool
    if want("surfel"):
        gen = torch.Generator(device=device).manual_seed(0)
        s_origin = torch.randn((p, 3), generator=gen,
                               device=device).abs() * 50.0
        s_dir = torch.randn((p, 3), generator=gen, device=device)
        bench(f"surfel trace (rough, {p})",
              lambda: trace(s_origin, s_dir, 0.1,
                            torch.full((p,), 10000.0, device=device),
                            "rough"))
        q = torch.trunc(s_origin / 4.0).int()
        f = torch.zeros((p,), dtype=torch.int32, device=device)
        bench(f"hash_get ({p})", lambda: sh.hash_get(state.gi, q, f))
        ones = torch.ones((p, 3), device=device)
        valid = torch.ones((p,), dtype=torch.bool, device=device)
        bench(f"hash_insert ({p})",
              lambda: sh.hash_insert(state.gi, q, f, ones, 0, valid=valid))

    if want("post"):
        radiance = torch.where(hit[:, None], 0.5, 0.1).expand(n, 3) \
            .reshape(H, W, 3).contiguous()
        hitdist = torch.where(hit, 3.0, 1e5).reshape(H, W)
        history = denoiselib.make_denoiser_state(H, W, device)
        eye4 = torch.eye(4, device=device)
        bench("denoise", lambda: denoiselib.denoise(
            history, radiance, hitdist, g["depth"].reshape(H, W),
            normal.reshape(H, W, 3), g["world_pos"].reshape(H, W, 3),
            g["motion"].reshape(H, W, 3), eye4, settings.denoiser))
        bench("exposure histogram", lambda: exposurelib.luminance_histogram(
            radiance, settings.exposure))
        one = torch.tensor(1.0, device=device)
        bench("tonemap", lambda: tonemaplib.tonemap(radiance, radiance, one,
                                                    transfer="srgb"))

    if want("frame"):
        def full(st):
            out, _aux, st = render_frame(scene, st, cs, sky,
                                         bn.unitvec3_cosine, bn.scalar,
                                         settings)
            return out, st

        _out, st = full(state)
        # Every timed frame starts from the same state.
        _res, host_s, dev_ms = best_of(lambda: full(st), reps, device)
        times["FULL FRAME"] = (1e3 * host_s, dev_ms)
        dev = "-" if dev_ms is None else f"{dev_ms:8.3f}"
        log(f"{'FULL FRAME':34s} {1e3 * host_s:8.3f} ms  device {dev} ms"
            f"   ({(4 * n + 2 * p) / host_s / 1e6:.1f} Mrays/s)")
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--pool", type=int, default=720 * 480)
    ap.add_argument("--cap", type=int, default=1 << 22)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--stages", type=str, default="",
                    help=f"comma-separated groups of {STAGES} (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    stages = [s for s in args.stages.split(",") if s]
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}; choose from {STAGES}")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("profile_stages: no CUDA device (pass --device cpu to run the "
              "plain PyTorch versions on the CPU)", file=sys.stderr)
        return 2
    from dust_tpu_torch.bench import card_name

    print(f"# {args.width}x{args.height}, pool {args.pool}, {args.cap} hash "
          f"slots, best of {args.reps}, device "
          f"{card_name() if device.type == 'cuda' else 'cpu'}")
    profile(args.width, args.height, args.pool, args.cap, args.reps, device,
            stages)
    return 0


if __name__ == "__main__":
    sys.exit(main())
