"""The port's eager traversal backend (``traversal_backend="jnp"``)
against the reference's XLA wavefront (:mod:`dust_tpu.ops.traverse`).

The ray sets are those of tests/test_traverse.py (48×48 camera rays at
the teapot; 512 rays from random points inside it) and of
tests/test_pallas_trace.py (2048 AO-length rays and 1024 interior rays
from random points; the castle's 64×36 camera rays, whose model spans 15
leaf-mask chunks), made with numpy from the same seeds, plus grazing
rays: directions with exact-zero components, origins on block planes.
Every mode, at the default ``max_iters=256`` and at 6, which binds on
a third to two thirds of the lanes that hit. ``(inst, row, bit)`` must
be equal; ``t`` finite in the same lanes and within 1e-6 relative where
finite (measured: bit-equal on every set). The per-instance affine and the march positions round as the
reference's compiler fuses them (``traverse.dot_point``, ``fp.fma``):
with each product and sum rounded on its own, t differs in the last bits
on 2-5% of the hits and a few rough-mode hits change.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dust_tpu.ops import camera as jcam
from dust_tpu.ops import traverse as jt
from dust_tpu.render import scene as jscene
from dust_tpu.vox import procgen
from dust_tpu.vox.loader import load_vox_scene
from dust_tpu_torch.ops import traverse as tt
from dust_tpu_torch.render import scene as tscene
from tests.torch_parity import port_scene, teapot_vox, tensor

MODES = ("precise", "rough", "ao_threshold")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread, as in the other port tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    js = jscene.build_device_scene(teapot_vox())
    return js, port_scene(js)


def _camera(w, h, eye, target, fov):
    cs = jcam.camera_settings(jcam.look_at(eye, target), fov, 0.1, 1000.0,
                              w, h)
    d = np.array(jcam.camera_ray_dirs(cs, w, h)).reshape(-1, 3)
    return np.broadcast_to(np.array(cs.position), d.shape).copy(), d


def _ray_sets():
    """World-space (origin, direction, t_min, t_max, t_max of
    ao_threshold) of each set."""
    sets = {}
    o, d = _camera(48, 48, (90, 60, 90), (0, 0, 0), np.pi / 3)
    n = len(o)
    # The AO plane of the camera rays cuts through the teapot.
    sets["camera"] = (o, d, np.full(n, 0.1), np.full(n, 1000.0),
                      np.full(n, 140.0))
    rng = np.random.default_rng(3)
    o = rng.uniform(-40, 40, size=(512, 3))
    d = rng.normal(size=(512, 3))
    sets["inside"] = (o, d / np.linalg.norm(d, axis=1, keepdims=True),
                      np.full(512, 0.1), np.full(512, 500.0),
                      np.full(512, 8.0))
    rng = np.random.default_rng(11)
    o = rng.uniform(-30, 30, size=(2048, 3))
    d = rng.normal(size=(2048, 3))
    sets["ao"] = (o, d, np.full(2048, 0.1), np.full(2048, 1000.0),
                  np.full(2048, 8.0))
    rng = np.random.default_rng(5)
    o = rng.uniform(-40, 40, size=(1024, 3))
    d = rng.normal(size=(1024, 3))
    sets["interior"] = (o, d, np.full(1024, 0.1), np.full(1024, 500.0),
                        np.full(1024, 8.0))
    return {k: tuple(np.asarray(x, np.float32) for x in v)
            for k, v in sets.items()}


RAY_SETS = _ray_sets()


def _grazing(js):
    """Axis-aligned and tilted rays with exact-zero direction components,
    starting outside the model, half of them on block planes (object
    space), carried to world space."""
    o2w = np.asarray(js.obj_to_world)[0]
    rng = np.random.default_rng(3)
    n = 256
    obj = rng.integers(8, 60, size=(n, 3)).astype(np.float32)
    obj[: n // 2] = np.floor(obj[: n // 2] / 4.0) * 4.0
    obj[:, 0] = -4.0
    d = np.zeros((n, 3), np.float32)
    d[:, 0] = 1.0
    tilt = rng.integers(0, 3, size=n)
    d[tilt == 1, 1] = 0.5
    d[tilt == 2, 2] = -0.25
    return (obj @ o2w[:, :3].T + o2w[:, 3], d @ o2w[:, :3].T,
            np.full(n, 0.1, np.float32), np.full(n, 1000.0, np.float32),
            np.full(n, 40.0, np.float32))


def _assert_same(ref, got, min_hits=1):
    """Ids equal; t finite in the same lanes, within 1e-6 relative."""
    t_r = np.asarray(ref[0])
    t_g = got[0].numpy()
    fin = np.isfinite(t_r)
    np.testing.assert_array_equal(np.isfinite(t_g), fin)
    np.testing.assert_allclose(t_g[fin], t_r[fin], rtol=1e-6)
    for a, b in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert fin.sum() >= min_hits


def _scene_both(js, ts, rs, mode, max_iters, **port_kw):
    o, d, tn, tx, ta = rs
    tmax = ta if mode == "ao_threshold" else tx
    ref = jt.trace_scene(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tn),
                         jnp.asarray(tmax), mode=mode, max_iters=max_iters)
    got = tt.trace_scene(ts, tensor(o), tensor(d), tensor(tn), tensor(tmax),
                         mode=mode, max_iters=max_iters, **port_kw)
    return ref, got


@pytest.mark.parametrize("max_iters", [256, 6])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ray_set", sorted(RAY_SETS))
def test_trace_scene_matches_reference(scenes, ray_set, mode, max_iters):
    js, ts = scenes
    ref, got = _scene_both(js, ts, RAY_SETS[ray_set], mode, max_iters)
    _assert_same(ref, got, min_hits=20)


def test_max_iters_binds(scenes):
    """At 6 iterations lanes that hit at 256 end as misses."""
    js, ts = scenes
    lost = 0
    for rs in RAY_SETS.values():
        long = _scene_both(js, ts, rs, "precise", 256)[1]
        short = _scene_both(js, ts, rs, "precise", 6)[1]
        lost += int(((long.inst >= 0) & (short.inst < 0)).sum())
        assert bool((short.inst[short.inst >= 0]
                     == long.inst[short.inst >= 0]).all())
    assert lost > 200


@pytest.mark.parametrize("mode", MODES)
def test_grazing_rays(scenes, mode):
    js, ts = scenes
    ref, got = _scene_both(js, ts, _grazing(js), mode, 256)
    _assert_same(ref, got, min_hits=20)


@pytest.mark.parametrize("sync_every", [1, 3, 256])
def test_lane_retirement_changes_no_result(scenes, sync_every, monkeypatch):
    """How often the walk drops finished lanes changes no ray's result."""
    js, ts = scenes
    rs = RAY_SETS["ao"]
    o, d, tn, tx, ta = (tensor(x) for x in rs)
    w2o = ts.world_to_obj[0]
    args = (ts.cell_info[0], ts.mask_lo[0], ts.mask_hi[0],
            tt.dot_point(w2o, o), tt.dot_dir(w2o, d), tn, tx)
    base = tt.trace_instance(*args)
    monkeypatch.setattr(tt, "SYNC_EVERY", sync_every)
    other = tt.trace_instance(*args)
    for a, b in zip(base, other):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_trace_scene_tiled_matches_reference(scenes, mode):
    js, ts = scenes
    o, d, tn, tx, ta = RAY_SETS["ao"]
    tmax = ta if mode == "ao_threshold" else tx
    ref = jt.trace_scene_tiled(js, jnp.asarray(o), jnp.asarray(d), 0.1,
                               jnp.asarray(tmax), mode=mode, tile=512)
    got = tt.trace_scene_tiled(ts, tensor(o), tensor(d), 0.1, tensor(tmax),
                               mode=mode, tile=300)
    _assert_same(ref, got, min_hits=20)


@pytest.fixture(scope="module")
def castle():
    vox = load_vox_scene(procgen.castle_scene_bytes())
    geo = vox.geometries[0]
    w2o = np.linalg.inv(np.asarray(vox.instances[0].transform,
                                   np.float64)).astype(np.float32)
    return geo, w2o


@pytest.mark.parametrize("mode", MODES)
def test_trace_instance_on_the_castle(castle, mode):
    """Object-space rays through one model of many leaf-mask chunks."""
    geo, w2o = castle
    cs = jcam.camera_settings(jcam.look_at((122.0, 300.61, 54.45), (0, 0, 0)),
                              0.6, 0.1, 10000.0, 64, 36)
    d = np.array(jcam.camera_ray_dirs(cs, 64, 36)).reshape(-1, 3)
    o = np.broadcast_to(np.array(cs.position), d.shape)
    o = (o @ w2o[:3, :3].T + w2o[:3, 3]).astype(np.float32)
    d = (d @ w2o[:3, :3].T).astype(np.float32)
    n = len(o)
    tn = np.full(n, 0.1, np.float32)
    tx = np.full(n, 10000.0, np.float32)
    cell = jnp.asarray(jscene.cell_info_grid(geo.flat.leaf_grid))
    masks = (jnp.asarray(geo.flat.mask_lo), jnp.asarray(geo.flat.mask_hi))
    if mode == "ao_threshold":
        # The AO plane at the median camera hit: half the hits lie past it.
        t = np.asarray(jt.trace_instance(cell, *masks, jnp.asarray(o),
                                         jnp.asarray(d), jnp.asarray(tn),
                                         jnp.asarray(tx))[0])
        tx[:] = np.median(t[np.isfinite(t)])
    ref = jt.trace_instance(cell, *masks, jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(tn), jnp.asarray(tx), mode=mode)
    got = tt.trace_instance(
        torch.from_numpy(tscene.cell_info_grid(geo.flat.leaf_grid)),
        tensor(geo.flat.mask_lo.view(np.int32), torch.int32),
        tensor(geo.flat.mask_hi.view(np.int32), torch.int32),
        tensor(o), tensor(d), tensor(tn), tensor(tx), mode=mode)
    _assert_same(ref, got, min_hits=500)


def test_trace_instance_rejects_unknown_mode(scenes):
    _, ts = scenes
    z = torch.zeros((1, 3))
    with pytest.raises(ValueError):
        tt.trace_instance(ts.cell_info[0], ts.mask_lo[0], ts.mask_hi[0], z,
                          z + 1.0, torch.zeros(1), torch.ones(1), mode="ao_fg")


@pytest.mark.parametrize("name", ["teapot", "castle"])
def test_cell_grid_matches_reference(name):
    data = (procgen.teapot_scene_bytes() if name == "teapot"
            else procgen.castle_scene_bytes())
    grid = load_vox_scene(data).geometries[0].flat.leaf_grid
    occ = grid >= 0
    np.testing.assert_array_equal(tscene.chebyshev_distance_field(occ),
                                  jscene.chebyshev_distance_field(occ))
    np.testing.assert_array_equal(tscene.cell_info_grid(grid),
                                  jscene.cell_info_grid(grid))


def test_distance_field_values():
    """tests/test_traverse.py's hand-checked distances."""
    occ = np.zeros((64, 64, 64), bool)
    occ[10, 10, 10] = True
    d = tscene.chebyshev_distance_field(occ)
    assert (d[10, 10, 10], d[11, 11, 11], d[10, 10, 13], d[30, 10, 10]) == (
        0, 1, 3, 20)


def test_argmin_takes_the_first_minimum():
    """The micro step's axis pick on exact ties: both libraries take the
    first minimum (NaN-free input, as the walk's tmax3 is)."""
    rng = np.random.default_rng(0)
    t = rng.integers(0, 3, size=(4096, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        torch.from_numpy(t).argmin(dim=-1).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(t), axis=-1)))
