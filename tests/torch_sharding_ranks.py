"""What each rank of the sharding tests runs (tests/test_torch_sharding.py,
tests/test_torch_sharding_edits.py). Spawned processes import this
module by name, so it imports the port and torch only: never jax.

A job is a dict: ``name``; ``scene`` (the reference scene as
``(fields, meta)`` numpy, see tests/torch_parity.py's ``scene_numpy``);
``settings`` (RenderSettings fields, nested settings as dicts); ``c2w``
and ``fov`` (the camera); ``frames``; and for the edit sequence
``edits`` (the teapot's vox scene is rebuilt in the rank). Every result
is numpy: the whole images (``gather_image``), the GI table and
pool, the denoiser history, and the rows the rank returned."""

from __future__ import annotations

import numpy as np
import torch

from dust_tpu_torch import config as tconfig
from dust_tpu_torch import parallel
from dust_tpu_torch.ops import camera as tcam
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops.noise import load_blue_noise
from dust_tpu_torch.ops.sky import bake_sky
from dust_tpu_torch.render import pipeline as tpipe
from dust_tpu_torch.render.scene import scene_from_numpy


def settings_of(fields: dict) -> tconfig.RenderSettings:
    """The port's RenderSettings of a job's ``settings`` dict."""
    f = dict(fields)
    for key, cls in (("spatial_hash", tconfig.SpatialHashSettings),
                     ("surfels", tconfig.SurfelSettings),
                     ("denoiser", tconfig.DenoiserSettings)):
        if key in f:
            f[key] = cls(**f[key])
    return tconfig.RenderSettings(**f)


def camera_of(job, device):
    s = job["settings"]
    return tcam.camera_settings(np.asarray(job["c2w"]), job["fov"], 0.1,
                                10000.0, s["width"], s["height"], device)


def whole_state(mesh, state, scene, settings) -> dict:
    """The state's tables as the unsharded frame holds them (numpy)."""
    table = state.gi.table
    hist = state.denoiser.history
    if mesh is not None:
        if isinstance(state.gi, gilib.DenseGICache):
            table = parallel.gather_rows(mesh, table,
                                         gilib.dense_rows(scene))
        div = 2 if tpipe._half_res(settings) else 1
        hist = parallel.gather_image(mesh, hist, settings.height // div)
    return dict(gi=table.cpu().numpy(), surfels=state.surfels.cpu().numpy(),
                history=hist.cpu().numpy(),
                exposure=float(state.exposure_avg))


def render(mesh, job, device="cpu") -> dict:
    """``job["frames"]`` frames from a fresh state, carrying it; with a
    mesh, ray-sharded. Returns the whole images, depths and the tables."""
    s = settings_of(job["settings"])
    fields, meta = job["scene"]
    scene = scene_from_numpy(fields, meta, device)
    state = tpipe.make_frame_state(s, scene, device)
    if mesh is not None:
        scene = parallel.replicate_scene(scene, mesh)
        state = parallel.shard_frame_state(state, mesh)
    cam = camera_of(job, device)
    sky, bn = bake_sky(s.sunlight, device), load_blue_noise(device)
    out = dict(images=[], depths=[], rows=[])
    for _ in range(job["frames"]):
        img, aux, state = tpipe.render_frame(
            scene, state, cam, sky, bn.unitvec3_cosine, bn.scalar, s,
            mesh=mesh)
        depth = aux["depth"]
        out["rows"].append(img.shape[0])
        if mesh is not None:
            img = parallel.gather_image(mesh, img, s.height)
            depth = parallel.gather_image(mesh, depth, s.height)
        out["images"].append(img.cpu().numpy())
        out["depths"].append(depth.cpu().numpy())
    out.update(whole_state(mesh, state, scene, s))
    return out


def render_jobs(mesh, jobs) -> dict:
    """Every job on this mesh: {name: render(...)}."""
    return {job["name"]: render(mesh, job) for job in jobs}


def edit_sequence(mesh, job, device="cpu") -> dict:
    """tests/test_sharding_edits.py's sequence on the teapot: frame, an
    in-leaf edit (the leaf tier), frame, an out-of-leaf edit (the splice
    tier), frame; with a mesh, ray-sharded. Returns the whole images,
    the refit tiers and the final dense table."""
    from dust_tpu_torch.render.edits import SceneEditor
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    s = settings_of(job["settings"])
    vox = load_vox_scene(procgen.teapot_scene_bytes())
    scene = build_device_scene(vox, device)
    state = tpipe.make_frame_state(s, scene, device)
    if mesh is not None:
        scene = parallel.replicate_scene(scene, mesh)
        state = parallel.shard_frame_state(state, mesh)
    editor = SceneEditor(vox, scene, mesh=mesh)
    mid = sorted(vox.geometries)[0]
    cam = camera_of(job, device)
    sky, bn = bake_sky(s.sunlight, device), load_blue_noise(device)
    out = dict(images=[], modes=[])

    def frame(scene, state):
        img, _aux, state = tpipe.render_frame(
            scene, state, cam, sky, bn.unitvec3_cosine, bn.scalar, s,
            return_aux=False, mesh=mesh)
        if mesh is not None:
            img = parallel.gather_image(mesh, img, s.height)
        out["images"].append(img.cpu().numpy())
        return state

    state = frame(scene, state)
    c0 = editor._coords[mid][0]
    editor.set_voxel(mid, tuple(int(v) for v in c0), 7)
    scene, state = editor.refit(state)
    out["modes"].append(editor.last_refit_mode)
    state = frame(scene, state)
    editor.set_voxel(mid, (2, 2, 2), 11)
    scene, state = editor.refit(state)
    out["modes"].append(editor.last_refit_mode)
    state = frame(scene, state)
    out.update(whole_state(mesh, state, scene, s))
    return out


def edit_jobs(mesh, jobs) -> dict:
    return {job["name"]: edit_sequence(mesh, job) for job in jobs}


def fails(mesh):
    """A rank that raises (the spawn tests)."""
    raise ValueError(f"planted failure on rank {mesh.rank}")


def dies(mesh):
    """A rank that exits without a word (the spawn tests)."""
    import os

    os._exit(3)


def rank_and_size(mesh):
    return mesh.rank, mesh.size, str(mesh.device)
