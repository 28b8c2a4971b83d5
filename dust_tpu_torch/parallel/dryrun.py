"""The multi-device dry run (port of ``__graft_entry__.dryrun_multichip``).

Usage:
  python -m dust_tpu_torch.parallel.dryrun --ranks N --device cpu|cuda

Spawns N ranks, one process per device (NCCL over cuda:0 ... cuda:N-1,
or gloo on the CPU), joined through a ``FileStore`` in a temporary
directory, and runs the reference's four gates on them. Each gate holds
the ray-sharded frame (:func:`render_frame` with a mesh, the image
assembled with :func:`~dust_tpu_torch.parallel.gather_image`) against
the frame without a mesh from the same state, as the reference does:
``isclose(rtol=1e-3, atol=1e-3)`` on more than 99.9% of the values.

1. the castle at 64 x 8N, dense GI, on the eager backend (``jnp``);
2. the same on the kernel's backend (``pallas``);
3. a wide aspect, 48N x 4N, over 2 frames of an orbiting camera;
4. a leaf edit under the mesh: frame, edit, refit, frame.

Prints one line per gate and exits non-zero if any fails. ``--device
cuda`` with more ranks than cards raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np

GATE = 0.999  # the share of values isclose(rtol=1e-3, atol=1e-3) must keep
EYE, TARGET = (150.0, 90.0, 180.0), (0.0, 30.0, 0.0)


def _rank_main(rank, size, device, store_path, results, fn, args):
    """One rank: joins the group, runs ``fn(mesh, *args)`` and puts
    (rank, ok, result or traceback) on ``results``."""
    import torch
    import torch.distributed as dist

    from dust_tpu_torch import parallel

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, size)
        parallel.init_process_group(rank, size, device, store=store)
        results.put((rank, True, fn(parallel.make_mesh(), *args)))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, ranks: int, device: str, *args, timeout_s: float = 900.0,
          store_dir=None):
    """Runs ``fn(mesh, *args)`` on ``ranks`` new processes, rank r on
    ``cuda:r`` (NCCL) or the CPU (gloo, one torch thread per rank),
    joined through a ``FileStore`` in ``store_dir`` (default: a new
    temporary directory). ``fn`` must be importable by name and return
    picklable values. Returns the ranks' results in rank order. Raises if
    a rank fails or the ranks are not done within ``timeout_s``; the
    ranks are killed either way."""
    import torch
    import torch.multiprocessing as mp

    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: cpu or cuda")
    if device == "cuda" and ranks > torch.cuda.device_count():
        raise RuntimeError(f"{ranks} ranks on cuda need {ranks} cards; "
                           f"{torch.cuda.device_count()} present")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with contextlib.ExitStack() as stack:
        if store_dir is None:
            store_dir = stack.enter_context(tempfile.TemporaryDirectory())
        store = os.path.join(store_dir, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            r, ranks, device, store, results, fn, args))
            for r in range(ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < ranks:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    # A rank that died without a word (a crash while it
                    # started, a signal) fails the run now.
                    for r, p in enumerate(procs):
                        if r not in out and p.exitcode not in (None, 0):
                            raise RuntimeError(f"rank {r} exited with code "
                                               f"{p.exitcode}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{ranks} ranks not done in "
                                           f"{timeout_s:.0f} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10.0 if len(out) == ranks else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(ranks)]


def _setup(device, width, height, hash_capacity, pool):
    """The reference dry run's castle (dense GI), camera, sky and
    noise."""
    from dust_tpu_torch.config import (RenderSettings, SpatialHashSettings,
                                       SurfelSettings)
    from dust_tpu_torch.ops.noise import load_blue_noise
    from dust_tpu_torch.ops.sky import bake_sky
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    settings = RenderSettings(
        width=width, height=height,
        spatial_hash=SpatialHashSettings(capacity=hash_capacity),
        surfels=SurfelSettings(pool_size=pool), gi_cache="dense")
    scene = build_device_scene(
        load_vox_scene(procgen.castle_scene_bytes()), device)
    return dict(settings=settings, scene=scene,
                cam=camera(settings, EYE, device),
                sky=bake_sky(settings.sunlight, device),
                bn=load_blue_noise(device))


def camera(settings, eye, device):
    """The dry run's camera at ``eye``, looking at the castle."""
    from dust_tpu_torch.ops import camera as cameralib

    return cameralib.camera_settings(
        cameralib.look_at(eye, TARGET), settings.camera.fov,
        settings.camera.near, settings.camera.far, settings.width,
        settings.height, device)


def orbit_eye(frame: int):
    """The reference dry run's orbit: 0.05 rad a frame about the target."""
    ang = frame * 0.05 + math.atan2(150.0, 180.0)
    r = math.dist((150.0, 180.0), (0.0, 0.0))
    return (r * math.sin(ang), 90.0, r * math.cos(ang))


def _frames(ctx, mesh, cams, state, scene=None):
    """Renders one frame per camera from ``state``, carrying it; returns
    (the last output, the state). With a mesh the output is the rank's
    rows, checked to be that many."""
    from dust_tpu_torch import parallel
    from dust_tpu_torch.render.pipeline import render_frame

    s, bn = ctx["settings"], ctx["bn"]
    scene = ctx["scene"] if scene is None else scene
    out = None
    for cam in cams:
        out, _aux, state = render_frame(
            scene, state, cam, ctx["sky"], bn.unitvec3_cosine, bn.scalar, s,
            return_aux=False, mesh=mesh)
    if mesh is not None:
        a, b = parallel.ray_sharding(mesh, s.height)
        if out.shape[0] != b - a:
            raise AssertionError(f"rank {mesh.rank}: {out.shape[0]} rows, "
                                 f"its chunk is {b - a}")
    return out, state


def _agree(mesh, ref, rows, height) -> float:
    """The share of values of the whole sharded image that are isclose
    to the unsharded ``ref``."""
    from dust_tpu_torch import parallel

    img = parallel.gather_image(mesh, rows, height)
    if not bool(img.isfinite().all()):
        raise AssertionError("the sharded image is not finite")
    return float(np.isclose(ref.cpu().numpy(), img.cpu().numpy(), rtol=1e-3,
                            atol=1e-3).mean())


def _pair(ctx, mesh, cams):
    """The unsharded and the sharded frames from fresh states: agreement."""
    from dust_tpu_torch import parallel
    from dust_tpu_torch.render.pipeline import make_frame_state

    s, dev = ctx["settings"], mesh.device
    ref, _ = _frames(ctx, None, cams,
                     state=make_frame_state(s, ctx["scene"], dev))
    scene = parallel.replicate_scene(ctx["scene"], mesh)
    state = parallel.shard_frame_state(make_frame_state(s, scene, dev), mesh)
    out, _ = _frames(ctx, mesh, cams, state=state, scene=scene)
    return _agree(mesh, ref, out, s.height)


def _edit_frame(ctx, mesh):
    """Gate 4's sequence: frame, a leaf edit, refit, frame; returns the
    last frame (the rank's rows under a mesh)."""
    from dust_tpu_torch import parallel
    from dust_tpu_torch.render.edits import SceneEditor
    from dust_tpu_torch.render.pipeline import make_frame_state
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    dev = ctx["scene"].device
    s = ctx["settings"]
    vox = load_vox_scene(procgen.castle_scene_bytes())
    scene = build_device_scene(vox, dev)
    state = make_frame_state(s, scene, dev)
    if mesh is not None:
        scene = parallel.replicate_scene(scene, mesh)
        state = parallel.shard_frame_state(state, mesh)
    editor = SceneEditor(vox, scene, mesh=mesh)
    mid = sorted(vox.geometries)[0]
    _, state = _frames(ctx, mesh, [ctx["cam"]], state=state, scene=scene)
    editor.set_voxel(mid, tuple(int(v) for v in editor._coords[mid][0]), 7)
    scene, state = editor.refit(state)
    if editor.last_refit_mode != "leaf":
        raise AssertionError(f"refit tier {editor.last_refit_mode}, "
                             f"expected leaf")
    out, _ = _frames(ctx, mesh, [ctx["cam"]], state=state, scene=scene)
    return out


def gates(mesh) -> dict:
    """The four gates on this rank (every rank renders the unsharded
    frames as well); returns {gate: share of isclose values}."""
    n, dev = mesh.size, mesh.device
    # 8 rows of 64 pixels per rank keeps every chunk non-trivial.
    ctx = _setup(dev, 64, 8 * n, hash_capacity=1 << 12, pool=256 * n)
    res = {"jnp": _pair(ctx, mesh, [ctx["cam"]])}
    pl = dict(ctx, settings=dataclasses.replace(ctx["settings"],
                                                traversal_backend="pallas"))
    res["pallas"] = _pair(pl, mesh, [ctx["cam"]])
    # A wide aspect: the à-trous steps and the upsample reach across the
    # ranks' rows, and the orbit moves the camera, so the history fetch
    # does too.
    wide = _setup(dev, 48 * n, 4 * n, hash_capacity=1 << 12, pool=128 * n)
    res["wide-orbit"] = _pair(wide, mesh, [
        camera(wide["settings"], orbit_eye(f), dev) for f in range(2)])
    res["edit"] = _agree(mesh, _edit_frame(ctx, None), _edit_frame(ctx, mesh),
                         ctx["settings"].height)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--device", choices=["cpu", "cuda"], required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    per_rank = spawn(gates, args.ranks, args.device)
    ok = True
    for gate in per_rank[0]:
        share = min(r[gate] for r in per_rank)
        ok &= share > GATE
        print(f"dryrun {args.ranks} ranks on {args.device}, {gate}: sharded "
              f"vs unsharded isclose on {share:.6f} of values "
              f"({'ok' if share > GATE else 'FAILED'})")
    print(f"dryrun: {'OK' if ok else 'FAILED'} in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
