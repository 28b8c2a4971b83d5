"""The port's HDDA traversal (plain PyTorch version, CPU) against the
reference's Pallas scene kernel run in interpret mode.

Inputs are made once with numpy and fed to both: 128×64 camera rays at
the teapot and 2048 secondary rays from its hit points, in all four
modes; then the same rays with each iteration cap lowered until it binds
on many lanes (the reference kernel rebuilt with the same caps); then a
grazing ray set with exact-zero direction components on block planes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dust_tpu.ops import pallas_trace as pt
from dust_tpu.render.scene import build_device_scene
from dust_tpu_torch.ops import hdda
from tests.torch_parity import (port_scene, teapot_ray_sets, teapot_vox,
                                 tensor)

N_SECONDARY = 2048


@pytest.fixture(scope="module")
def scenes():
    js = build_device_scene(teapot_vox())
    return js, port_scene(js)


@pytest.fixture(scope="module")
def rays(scenes):
    """Camera rays and seeded secondary rays from the camera hits."""
    return teapot_ray_sets(scenes[0], N_SECONDARY)


def _t_max(mode, rs):
    """ao_threshold rays end at the AO threshold, as in the frame."""
    return rs[3] if mode == "ao_threshold" else rs[4]


def _reference(js, mode, rs, rounds=64, march_cap=160, micro_cap=12):
    """The reference scene kernel (interpret mode) with the given caps:
    the body of trace_scene_pallas_batched / _trace_pallas_scene with the
    caps as arguments. Returns numpy outputs in the kernel's order."""
    o, d, tn, ta, _ = rs
    tx = _t_max(mode, rs)
    n = o.shape[0]
    I, M = js.num_instances, js.num_models
    CL = js.pl_mlo.shape[1]
    order = sorted(range(I), key=lambda i: js.inst_model[i])
    counts = tuple(sum(1 for im in js.inst_model if im == m) for m in range(M))
    pad = (-n) % (pt.ROWS * pt.LANES)

    def prep(x, fill=0.0):
        x = np.concatenate([np.asarray(x, np.float32),
                            np.full((pad,), fill, np.float32)])
        return jnp.asarray(x.reshape(-1, pt.LANES))

    fused = mode == "ao_fg"
    kernel = pt._make_scene_kernel(CL, tuple(js.pl_chunks), counts, mode,
                                   rounds, march_cap, micro_cap)
    rows = (n + pad) // pt.LANES
    tab = pl.BlockSpec(memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    ray = pl.BlockSpec((pt.ROWS, pt.LANES), lambda g: (g, 0),
                       memory_space=pltpu.VMEM)
    f32, i32 = jnp.float32, jnp.int32
    kinds = [f32, i32, f32, i32, i32] if fused else [f32, i32, i32, i32]
    args = [js.pl_l1, js.pl_l2w0.reshape(M * 4, 8, 128),
            js.pl_l2w1.reshape(M * 4, 8, 128),
            js.pl_l2r0.reshape(M * 4, 8, 128),
            js.pl_l2r1.reshape(M * 4, 8, 128),
            js.pl_mlo.reshape(M * CL, 8, 128),
            js.pl_mhi.reshape(M * CL, 8, 128),
            jnp.asarray(order, jnp.int32),
            js.world_to_obj[np.asarray(order)].reshape(I, 12),
            jnp.concatenate([js.model_aabb_min, js.model_aabb_max], axis=-1),
            prep(o[:, 0]), prep(o[:, 1]), prep(o[:, 2]),
            prep(d[:, 0], 1.0), prep(d[:, 1], 1.0), prep(d[:, 2], 1.0),
            prep(tn), prep(tx, -1.0)] + ([prep(ta, -1.0)] if fused else [])
    out = pl.pallas_call(
        kernel, grid=(rows // pt.ROWS,),
        in_specs=[tab] * 7 + [smem] * 3 + [ray] * (len(args) - 10),
        out_specs=[ray] * len(kinds),
        out_shape=[jax.ShapeDtypeStruct((rows, pt.LANES), k) for k in kinds],
        interpret=True)(*args)
    return [np.asarray(x).reshape(-1)[:n] for x in out]


def _port(ts, mode, rs):
    o, d, tn, ta, _ = rs
    models, ids, aff, aabb = hdda._scene_args(ts)
    out = hdda.hdda(ts.hdda_l1, ts.hdda_l2, ts.hdda_mask, models, ids, aff,
                    aabb, tensor(o), tensor(d), tensor(tn),
                    tensor(_t_max(mode, rs)),
                    t_ao=tensor(ta) if mode == "ao_fg" else None, mode=mode)
    return [x.numpy() for x in out]


def _assert_exact(ref, got):
    """Ids equal; t equal where finite (rtol 1e-5), inf in the same lanes."""
    for a, b in zip(ref, got):
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-5)
        else:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("ray_set", ["camera", "secondary"])
@pytest.mark.parametrize("mode", ["precise", "ao_threshold", "rough", "ao_fg"])
def test_matches_reference_kernel(scenes, rays, mode, ray_set):
    js, ts = scenes
    rs = rays[ray_set]
    ref = _reference(js, mode, rs)
    got = _port(ts, mode, rs)
    assert (ref[1] >= 0).sum() > 100, "the ray set must hit"
    if mode in ("precise", "ao_threshold"):
        _assert_exact(ref, got)
        return
    # rough and ao_fg: the reference's own agreement bound (block-entry
    # rejection sits on an fp boundary, tests/test_scene_multi.py).
    hit_ref, hit_got = ref[1] >= 0, got[1] >= 0
    assert (hit_ref == hit_got).mean() >= 0.999
    for k in range(1, len(ref)):
        if ref[k].dtype.kind == "i":
            assert (ref[k] == got[k]).mean() >= 0.999


# (cap lowered, the caps compared against) — each lowered cap must change
# some lanes' results, and the port must follow the reference there.
_CAPS = {
    "rounds": (dict(rounds=2), dict()),
    "march": (dict(march_cap=2, rounds=4), dict(rounds=4)),
    "micro": (dict(micro_cap=4), dict()),
}
_PORT_NAMES = {"rounds": "ROUNDS", "march_cap": "MARCH_CAP",
               "micro_cap": "MICRO_CAP"}


def _with_caps(monkeypatch, caps):
    monkeypatch.setattr(hdda, "ROUNDS", 64)
    monkeypatch.setattr(hdda, "MARCH_CAP", 160)
    monkeypatch.setattr(hdda, "MICRO_CAP", 12)
    for k, v in caps.items():
        monkeypatch.setattr(hdda, _PORT_NAMES[k], v)


@pytest.mark.parametrize("cap", sorted(_CAPS))
def test_iteration_caps_bind_like_reference(scenes, rays, monkeypatch, cap):
    js, ts = scenes
    lowered, base = _CAPS[cap]
    rs = tuple(np.concatenate([a, b]) for a, b in
               zip(rays["camera"], rays["secondary"]))
    mode = "precise"
    ref = _reference(js, mode, rs, **lowered)
    _with_caps(monkeypatch, lowered)
    got = _port(ts, mode, rs)
    _assert_exact(ref, got)
    _with_caps(monkeypatch, base)
    free = _port(ts, mode, rs)
    changed = (free[1] != got[1]) | (free[2] != got[2]) | (free[3] != got[3])
    assert changed.sum() >= 5, f"the {cap} cap did not bind"


def test_grazing_rays_on_block_planes(scenes, monkeypatch):
    """Directions with exact-zero components, origins on block and voxel
    boundary planes: the zero-direction guards, and rays that creep along
    a plane (1e-4 per march step) until the default march cap ends each
    round. Rounds are cut to 4 so the creeping lanes end quickly."""
    js, ts = scenes
    w2o = np.asarray(js.world_to_obj)[0]
    o2w = np.asarray(js.obj_to_world)[0]
    rng = np.random.default_rng(3)
    n = 256
    obj = rng.integers(8, 60, size=(n, 3)).astype(np.float32)
    obj[: n // 2] = np.floor(obj[: n // 2] / 4.0) * 4.0   # on block planes
    obj[:, 0] = -4.0                                      # start outside
    dirs = np.zeros((n, 3), np.float32)
    dirs[:, 0] = 1.0
    tilt = rng.integers(0, 3, size=n)
    dirs[tilt == 1, 1] = 0.5
    dirs[tilt == 2, 2] = -0.25
    dw = dirs @ o2w[:, :3].T
    ow = obj @ o2w[:, :3].T + o2w[:, 3]
    assert np.allclose(ow @ w2o[:, :3].T + w2o[:, 3], obj)
    rs = (ow.astype(np.float32), dw.astype(np.float32), np.full(n, 0.1),
          np.full(n, 20.0), np.full(n, 10000.0))
    _with_caps(monkeypatch, dict(rounds=4))
    for mode in ("precise", "rough"):
        ref = _reference(js, mode, rs, rounds=4)
        got = _port(ts, mode, rs)
        assert (ref[1] >= 0).sum() > 20
        _assert_exact(ref, got)
