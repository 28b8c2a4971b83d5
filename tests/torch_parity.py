"""Shared set-up of the PyTorch port's parity tests: the same scene and
inputs, made once with numpy, handed to the JAX reference and to the port.
JAX stays on the CPU (tests/conftest.py); the port runs on CPU tensors,
which takes every kernel's plain version."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dust_tpu.vox import procgen
from dust_tpu.vox.loader import VoxInstance, load_vox_scene

# Static (python) metadata of the reference DeviceScene.
SCENE_META = ("inst_model", "pl_chunks", "leaf_base", "leaf_cap",
              "gi_cell_cap")

# A camera that frames the procgen teapot (world extent about
# [-24, 32] x [-24, 16] x [-20, 20]).
TEAPOT_EYE = (26.0, 14.0, 32.0)
TEAPOT_TARGET = (4.0, -4.0, 0.0)


def teapot_vox():
    return load_vox_scene(procgen.teapot_scene_bytes())


def five_teapots_vox():
    """Five instances of one model spread along x (the multi-instance
    scene of tests/test_scene_multi.py)."""
    scene = teapot_vox()
    inst = scene.instances[0]
    for k in range(1, 5):
        t = inst.transform.copy()
        t[:3, 3] += np.asarray([120.0 * k, 10.0 * k, 15.0 * k], np.float32)
        scene.instances.append(VoxInstance(inst.model_id, t, name=f"tp{k}"))
    return scene


def scene_numpy(jax_scene):
    """A reference DeviceScene as (fields, meta): its array leaves as
    numpy and its static tuples."""
    fields = {f.name: np.asarray(getattr(jax_scene, f.name))
              for f in dataclasses.fields(jax_scene)
              if not f.metadata.get("static")}
    meta = {k: getattr(jax_scene, k) for k in SCENE_META}
    return fields, meta


def port_scene(jax_scene):
    """The reference scene carried into the port (CPU tensors)."""
    from dust_tpu_torch.render.scene import scene_from_numpy

    fields, meta = scene_numpy(jax_scene)
    return scene_from_numpy(fields, meta, "cpu")


def tensor(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x, copy=True, order="C"), dtype=dtype)


def camera_rays(width: int, height: int, eye=TEAPOT_EYE,
                target=TEAPOT_TARGET, fov: float = 1.1):
    """(N, 3) origins and directions of a pinhole camera, raster order,
    from the reference's camera module."""
    from dust_tpu.ops import camera as cam

    cs = cam.camera_settings(cam.look_at(eye, target), fov, 0.1, 10000.0,
                             width, height)
    d = np.array(cam.camera_ray_dirs(cs, width, height)).reshape(-1, 3)
    o = np.broadcast_to(np.array(cs.position), d.shape).copy()
    return o.astype(np.float32), d.astype(np.float32)


def secondary_rays(o, d, t, hit, n, seed):
    """``n`` seeded rays leaving hit points (just short of the hit) in
    uniform random directions."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(np.flatnonzero(hit), n, replace=True)
    so = o[idx] + d[idx] * (t[idx, None] * 0.999)
    sd = rng.normal(size=(n, 3))
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True)
    return so.astype(np.float32), sd.astype(np.float32)


def teapot_ray_sets(js, n_secondary: int = 2048):
    """The teapot's 128×64 camera rays and seeded secondary rays from the
    camera hits, each as (origin, direction, t_min, t_ao, t_max)."""
    import jax.numpy as jnp

    from dust_tpu.ops import pallas_trace as pt

    o, d = camera_rays(128, 64)
    prim = pt.trace_scene_pallas(js, jnp.asarray(o), jnp.asarray(d), 0.1,
                                 10000.0, mode="precise", interpret=True)
    hit = np.asarray(prim.hit)
    assert hit.sum() > 1500, "the camera must see the teapot"
    so, sd = secondary_rays(o, d, np.asarray(prim.t), hit, n_secondary, 7)
    n = len(o)
    return {
        "camera": (o, d, np.full(n, 0.1), np.full(n, 60.0),
                   np.full(n, 10000.0)),
        "secondary": (so, sd, np.full(n_secondary, 0.1),
                      np.full(n_secondary, 8.0),
                      np.full(n_secondary, 10000.0)),
    }
