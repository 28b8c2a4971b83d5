"""Edit-loop timing on the PyTorch port (BASELINE config #4: per-frame
voxel edits and refit, with the GI frame re-rendered).

Usage:
  python -m dust_tpu_torch.bench_edits [--interleave] [--edits N]
      [--device cuda|cpu]

The default (isolated) mode times each refit tier alone on the castle:
the full scene build and upload, the floor of one tiny device mutation
and its sync, a leaf edit (a palette change of an existing voxel), a
splice (a voxel in a new leaf) and a rebuild (a slab of new leaves that
crosses the scene's mask-chunk padding).

``--interleave`` times the 1920x1080 castle + teapot dense-GI frame (the
HDDA kernel's backend) while edits land: ms/frame with no edit, with a
leaf edit every frame, and with a splice staged off the render thread
(:meth:`SceneEditor.refit_async`) every ``N/2`` frames, with the frames
each staged splice took to swap in.

``--device`` defaults to ``cuda`` and the run fails without a CUDA
device; ``--device cpu`` runs every kernel's plain version (the
interleaved frame is then 320x180 on the eager traversal, as the
reference's ``--cpu``). The card's name and power limit are printed
beside the numbers.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# The reference bench's camera (tools/bench_edits.py).
EYE = (122.0, 300.61, 54.45)
TARGET = (0.0, 0.0, 0.0)
# The splices' voxels lie at z = SLAB_Y in leaves model 0 lacks (the
# reference bench's list); the rebuild's slab is four layers from
# y = SLAB_Y, above the castle (whose leaves end at y = 104): 4096 new
# leaves, more than one 1024-leaf mask chunk.
SLAB_Y = 200


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--edits", type=int, default=10)
    ap.add_argument("--interleave", action="store_true")
    return ap.parse_args(argv)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def fresh_leaf_voxels(vox) -> list:
    """Voxels of model 0 in leaves it does not have, at z = SLAB_Y."""
    have = {tuple(int(v) for v in o)
            for o in vox.geometries[0].flat.leaf_origin}
    return [(x, y, SLAB_Y) for x in range(0, 256, 4) for y in range(0, 256, 4)
            if (x, y, SLAB_Y) not in have]


def slab_voxels(y0: int = SLAB_Y) -> np.ndarray:
    """Every other voxel of four layers of model 0 from ``y0`` up."""
    xs, ys, zs = np.meshgrid(np.arange(0, 256, 2), np.arange(y0, y0 + 4),
                             np.arange(0, 256, 2), indexing="ij")
    return np.stack([xs.ravel(), ys.ravel(), zs.ravel()], 1)


def setup(device, width=1920, height=1080, backend="pallas") -> dict:
    """The interleaved run's frame: castle + teapot (at rest), dense GI,
    the reference bench's camera; the editor; the first frame's state.
    ``edits`` logs every edit as (model, coords (k, 3), palette index or
    None) in the order made; ``voxels`` holds model 0's voxels as loaded
    (the leaf edits repaint them)."""
    from dust_tpu_torch.config import RenderSettings
    from dust_tpu_torch.ops import camera as cameralib
    from dust_tpu_torch.ops.noise import load_blue_noise
    from dust_tpu_torch.ops.sky import bake_sky
    from dust_tpu_torch.render.edits import SceneEditor
    from dust_tpu_torch.render.pipeline import make_frame_state
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    settings = RenderSettings(width=width, height=height,
                              traversal_backend=backend, gi_cache="dense")
    vox = load_vox_scene(procgen.castle_scene_bytes())
    procgen.add_teapot(vox)
    scene = build_device_scene(vox, device)
    cam = cameralib.camera_settings(
        cameralib.look_at(EYE, TARGET), settings.camera.fov,
        settings.camera.near, settings.camera.far, width, height, device)
    editor = SceneEditor(vox, scene)
    return dict(device=device, settings=settings, vox=vox, scene=scene,
                editor=editor, voxels=editor.voxels(0)[0],
                state=make_frame_state(settings, scene, device),
                sky=bake_sky(settings.sunlight, device),
                bn=load_blue_noise(device), cam=cam, edits=[],
                fresh=fresh_leaf_voxels(vox), splice_swaps=[])


def render(ctx, return_aux=False):
    """One frame of ctx's scene from ctx's state (which it advances).
    Returns the output, or (output, aux) with ``return_aux``."""
    from dust_tpu_torch.render.pipeline import render_frame

    bn = ctx["bn"]
    out, aux, ctx["state"] = render_frame(
        ctx["scene"], ctx["state"], ctx["cam"], ctx["sky"],
        bn.unitvec3_cosine, bn.scalar, ctx["settings"],
        return_aux=return_aux)
    return (out, aux) if return_aux else out


def run(ctx, n, per_frame=None) -> float:
    """ms/frame of ``n`` frames, ``per_frame(f)`` before each (one sync at
    the end, as the reference bench times)."""
    t0 = time.perf_counter()
    for f in range(n):
        if per_frame is not None:
            per_frame(f)
        render(ctx)
    _sync(ctx["device"])
    return (time.perf_counter() - t0) / n * 1e3


def edit(ctx, coords, palette_idx, model=0):
    """Set voxels of ``model`` (logged in ``ctx["edits"]``)."""
    coords = np.asarray(coords, np.int64).reshape(-1, 3)
    ctx["edits"].append((model, coords, palette_idx))
    ctx["editor"].set_voxels(model, coords, palette_idx)


def leaf_edit(ctx, f):
    """A palette change of an existing voxel, refit at once (the leaf
    tier)."""
    ed, coords = ctx["editor"], ctx["voxels"]
    edit(ctx, coords[f % len(coords)], 5 + (f % 3))
    ctx["scene"], ctx["state"] = ed.refit(ctx["state"])
    if ed.last_refit_mode != "leaf":
        raise RuntimeError(f"leaf edit took the {ed.last_refit_mode} tier")


def splice_step(ctx, f, every):
    """Every ``every`` frames with no refit in flight, a voxel in a new
    leaf staged off the render thread; otherwise poll the one in flight
    and swap it in when it has landed (its frame count goes to
    ``ctx["splice_swaps"]``)."""
    ed = ctx["editor"]
    if not ed.refit_in_flight and f % every == 0 and ctx["fresh"]:
        edit(ctx, ctx["fresh"].pop(), 5)
        if ed.refit_async(ctx["state"]) is not None:
            raise RuntimeError("a new-leaf edit did not stage a splice")
        ctx["splice_start"] = f
    elif ed.refit_in_flight:
        landed = ed.poll_refit(ctx["state"])
        if landed is not None:
            ctx["scene"], ctx["state"] = landed
            ctx["splice_swaps"].append(f - ctx["splice_start"])
            if ed.last_refit_mode != "splice":
                raise RuntimeError(f"staged edit took the "
                                   f"{ed.last_refit_mode} tier")


def land_splice(ctx):
    """Wait for a staged splice still in flight and swap it in."""
    ed = ctx["editor"]
    if ed.refit_in_flight:
        ctx["scene"], ctx["state"] = ed.poll_refit(ctx["state"], block=True)


def interleave(ctx, n) -> dict:
    """The three interleaved measurements, each the better of two runs of
    ``n`` frames: ms/frame with no edit, with a leaf edit every frame, and
    with staged splices (and the frames each took to swap in)."""
    render(ctx)
    _sync(ctx["device"])
    base = min(run(ctx, n), run(ctx, n))
    leaf = min(run(ctx, n, lambda f: leaf_edit(ctx, f)),
               run(ctx, n, lambda f: leaf_edit(ctx, f)))
    every = max(n // 2, 1)
    splice = min(run(ctx, n, lambda f: splice_step(ctx, f, every)),
                 run(ctx, n, lambda f: splice_step(ctx, f, every)))
    land_splice(ctx)
    return dict(base_ms=base, leaf_ms=leaf, splice_ms=splice,
                swap_frames=list(ctx["splice_swaps"]))


def isolated(device, edits) -> dict:
    """Each refit tier's latency alone on the castle, synchronised: (ms)
    of the full build + upload, and best / median over ``edits`` runs of
    the dispatch floor, the leaf and splice tiers, and over up to 3 runs
    of the rebuild tier."""
    import torch

    from dust_tpu_torch.render.edits import SceneEditor
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    def read(t):  # one element back to the host: waits for the device
        return int(t.reshape(-1)[0])

    vox = load_vox_scene(procgen.castle_scene_bytes())
    read(torch.zeros(1, device=device))      # the device is up before timing
    t0 = time.perf_counter()
    dev = build_device_scene(vox, device)
    read(dev.cell_info[0, 0, 0])
    build_ms = (time.perf_counter() - t0) * 1e3

    def timed(step, reps):
        ts = []
        for k in range(reps):
            t0 = time.perf_counter()
            read(step(k))
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.min(ts)), float(np.median(ts))

    probe = dev.avg_albedo

    def tiny(k):  # the smallest device mutation: a copy with one add
        nonlocal probe
        probe = probe.clone()
        probe[0, 0] += 0
        return probe[0, 0]

    floor = timed(tiny, edits)
    ed = SceneEditor(vox, dev)

    def tier(name, make_edit):
        def step(k):
            make_edit(k)
            scene = ed.refit()
            if ed.last_refit_mode != name:
                raise RuntimeError(f"{name} edit took the "
                                   f"{ed.last_refit_mode} tier")
            return scene.avg_albedo[0, 0]
        return step

    coords = ed.voxels(0)[0]
    leaf = timed(tier("leaf", lambda k: ed.set_voxel(
        0, tuple(int(v) for v in coords[k % len(coords)]), 5 + (k % 3))),
        edits)
    fresh = fresh_leaf_voxels(vox)
    splice = timed(tier("splice", lambda k: ed.set_voxel(0, fresh[k], 5)),
                   edits)
    rebuild = timed(tier("rebuild", lambda k: ed.set_voxels(
        0, slab_voxels(SLAB_Y + 8 + 4 * k), 4)), min(edits, 3))
    return dict(build_ms=build_ms, floor_ms=floor, leaf_ms=leaf,
                splice_ms=splice, rebuild_ms=rebuild)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_edits: no CUDA device (pass --device cpu to run the "
              "plain PyTorch versions on the CPU)", file=sys.stderr)
        return 2
    if device.type == "cuda":
        from dust_tpu_torch.bench import card_name
        where = card_name()
    else:
        where = "cpu"

    if args.interleave:
        on_card = device.type == "cuda"
        ctx = setup(device, *((1920, 1080) if on_card else (320, 180)),
                    backend="pallas" if on_card else "jnp")
        r = interleave(ctx, args.edits)
        w, h = ctx["settings"].width, ctx["settings"].height
        print(f"# castle+teapot {w}x{h} dense GI, "
              f"{ctx['settings'].traversal_backend} backend [{where}]")
        print(f"frame baseline (no edits):      {r['base_ms']:7.2f} ms/frame")
        print(f"leaf edit EVERY frame:          {r['leaf_ms']:7.2f} ms/frame "
              f"(+{r['leaf_ms'] - r['base_ms']:.2f})")
        print(f"staged splice while rendering:  {r['splice_ms']:7.2f} "
              f"ms/frame (+{r['splice_ms'] - r['base_ms']:.2f}; swap landed "
              f"after {r['swap_frames']} frames)")
        return 0

    r = isolated(device, args.edits)
    print(f"# castle, isolated refit tiers [{where}]")
    print(f"full build + upload:         {r['build_ms']:8.1f} ms")
    for name, key in (("dispatch+sync floor:", "floor_ms"),
                      ("leaf refit (1-voxel edit):", "leaf_ms"),
                      ("splice refit (new leaf):", "splice_ms"),
                      ("rebuild (4096-leaf slab):", "rebuild_ms")):
        best, median = r[key]
        print(f"{name:28s} best {best:7.2f} ms, median {median:7.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
