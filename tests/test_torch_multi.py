"""Many instances: the port's scene traces and frame at more than two
instances against the reference's.

On the five-teapot scene (five instances of one model along a line, so
near ones occlude far ones): the batched route's front-to-back sweep
order, the batched route against ``trace_scene_pallas`` (the Pallas scene
kernel in interpret mode), the loop route (``DUST_PALLAS_SCENE=loop``)
against the reference's loop route, every mode, exact; the two routes of
the port against each other with the reference's own bounds; three
frames whose surfel refresh rotates through ``dense_refresh_budget``
slices against the reference's frame. On the 11-instance stress scene:
the carried-across scene, element for element, and the frame's ray
count.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dust_tpu.config import RenderSettings
from dust_tpu.ops import camera as jcam
from dust_tpu.ops import pallas_trace as pt
from dust_tpu.ops.gi_cache import dense_rows
from dust_tpu.ops.noise import load_blue_noise as jnoise
from dust_tpu.ops.sky import bake_sky as jsky
from dust_tpu.render import pipeline as jpipe
from dust_tpu.render.scene import build_device_scene
from dust_tpu.vox import procgen
from dust_tpu_torch.ops import camera as tcam
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops import hdda
from dust_tpu_torch.ops.noise import load_blue_noise as tnoise
from dust_tpu_torch.ops.sky import bake_sky as tsky
from dust_tpu_torch.render import pipeline as tpipe
from tests.test_torch_scene import _assert_scene_equal
from tests.torch_parity import (camera_rays, five_teapots_vox, port_scene,
                                secondary_rays, tensor)
from tools.rmse import rmse

MODES = ("precise", "ao_threshold", "rough", "ao_fg")
# Eyes on the line of teapots (behind the first, past the last) and above.
EYES = ((-240.0, -20.0, -30.0), (720.0, 60.0, 90.0), (240.0, 180.0, 420.0))
N_PER_EYE = 1024
N_SECONDARY = 2048


@pytest.fixture(scope="module")
def scenes():
    js = build_device_scene(five_teapots_vox())
    return js, port_scene(js)


def _aimed_rays(js, eye, n, seed):
    """``n`` rays from ``eye`` at seeded points around the instances' box
    centres."""
    rng = np.random.default_rng(seed)
    o2w = np.asarray(js.obj_to_world)
    c_m = 0.5 * (np.asarray(js.model_aabb_min) + np.asarray(js.model_aabb_max))
    centres = np.stack([o2w[i, :, :3] @ c_m[m] + o2w[i, :, 3]
                        for i, m in enumerate(js.inst_model)])
    aim = centres[rng.integers(0, len(centres), n)] + rng.uniform(
        -24.0, 24.0, size=(n, 3))
    o = np.broadcast_to(np.asarray(eye, np.float32), (n, 3)).copy()
    return o, (aim - o).astype(np.float32)


@pytest.fixture(scope="module")
def rays(scenes):
    """Aimed primary rays from every eye, then seeded secondary rays from
    their hits, as one set: (origin, direction, t_min, t_ao, t_max)."""
    js, _ = scenes
    parts = [_aimed_rays(js, e, N_PER_EYE, k) for k, e in enumerate(EYES)]
    o = np.concatenate([p[0] for p in parts])
    d = np.concatenate([p[1] for p in parts])
    prim = pt.trace_scene_pallas(js, jnp.asarray(o), jnp.asarray(d), 0.1,
                                 10000.0, mode="precise", interpret=True)
    hit = np.asarray(prim.hit)
    assert len(set(np.asarray(prim.inst)[hit].tolist())) == 5
    so, sd = secondary_rays(o, d, np.asarray(prim.t), hit, N_SECONDARY, 5)
    n, ns = len(o), N_SECONDARY
    return (np.concatenate([o, so]), np.concatenate([d, sd]),
            np.full(n + ns, 0.1, np.float32),
            np.concatenate([np.full(n, 60.0, np.float32),
                            np.full(ns, 8.0, np.float32)]),
            np.full(n + ns, 10000.0, np.float32))


def _t_max(mode, rs):
    """ao_threshold rays end at the AO threshold, as in the frame."""
    return rs[3] if mode == "ao_threshold" else rs[4]


def _reference(js, mode, rs):
    o, d, tn, ta, tx = (jnp.asarray(x) for x in rs)
    if mode == "ao_fg":
        ao, fg = pt.trace_scene_pallas_ao_fg(js, o, d, tn, ta, tx,
                                             interpret=True)
        return [np.asarray(x) for x in (ao.t, ao.inst, fg.t, fg.inst, fg.row)]
    r = pt.trace_scene_pallas(js, o, d, tn, jnp.asarray(_t_max(mode, rs)),
                              mode=mode, interpret=True)
    return [np.asarray(x) for x in r]


def _port(ts, mode, rs):
    o, d, tn, ta, tx = (tensor(x) for x in rs)
    if mode == "ao_fg":
        ao, fg = hdda.trace_scene_ao_fg(ts, o, d, tn, ta, tx)
        return [x.numpy() for x in (ao.t, ao.inst, fg.t, fg.inst, fg.row)]
    r = hdda.trace_scene(ts, o, d, tn, tensor(_t_max(mode, rs)), mode=mode)
    return [x.numpy() for x in r]


def _assert_exact(ref, got):
    """Ids equal; t equal where finite (rtol 1e-5), inf in the same lanes."""
    for a, b in zip(ref, got):
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-5)
        else:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("eye", range(len(EYES)))
def test_front_to_back_ids_match_reference(scenes, eye):
    js, ts = scenes
    o, _ = _aimed_rays(js, EYES[eye], 256, eye)
    order = sorted(range(js.num_instances), key=lambda i: js.inst_model[i])
    ids_r, aff_r = pt._front_to_back_ids(js, jnp.asarray(o), order,
                                         (js.num_instances,))
    ids_t, aff_t = hdda.front_to_back_ids(ts, tensor(o))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_r))
    np.testing.assert_array_equal(aff_t.numpy(), np.asarray(aff_r))
    assert ids_t.dtype == torch.int32


def test_front_to_back_order_is_near_to_far(scenes):
    """From either end of the line of teapots the sweep runs along it."""
    js, ts = scenes
    for eye, order in ((EYES[0], [0, 1, 2, 3, 4]), (EYES[1], [4, 3, 2, 1, 0])):
        o, _ = _aimed_rays(js, eye, 64, 0)
        ids, _ = hdda.front_to_back_ids(ts, tensor(o))
        assert ids.tolist() == order


@pytest.mark.parametrize("mode", MODES)
def test_batched_route_matches_reference(scenes, rays, mode, monkeypatch):
    monkeypatch.delenv("DUST_PALLAS_SCENE", raising=False)
    js, ts = scenes
    ref = _reference(js, mode, rays)
    assert (ref[1] >= 0).sum() > 200, "the rays must hit"
    _assert_exact(ref, _port(ts, mode, rays))


@pytest.mark.parametrize("mode", MODES)
def test_loop_route_matches_reference(scenes, rays, mode, monkeypatch):
    monkeypatch.setenv("DUST_PALLAS_SCENE", "loop")
    js, ts = scenes
    ref = _reference(js, mode, rays)
    assert (ref[1] >= 0).sum() > 200, "the rays must hit"
    _assert_exact(ref, _port(ts, mode, rays))


def _route_rays(ts):
    """The ray sets of the reference's own route comparison
    (tests/test_scene_multi.py): 128×64 camera rays over the line of
    teapots, and secondary rays in seeded uniform directions from their
    hits."""
    cam_o, cam_d = camera_rays(128, 64, eye=(250.0, 180.0, 420.0),
                               target=(240.0, 30.0, 30.0))
    n = len(cam_o)
    prim = hdda.trace_scene(ts, tensor(cam_o), tensor(cam_d), 0.1, 1e4)
    t0 = torch.where(prim.hit, prim.t, 0.0).numpy()
    so = (cam_o + cam_d * t0[:, None] * 0.999).astype(np.float32)
    sd = np.random.default_rng(5).normal(size=(n, 3))
    sd = (sd / np.linalg.norm(sd, axis=-1, keepdims=True)).astype(np.float32)
    act = prim.hit.numpy()
    camera = (cam_o, cam_d, np.full(n, 0.1, np.float32),
              np.full(n, 60.0, np.float32), np.full(n, 1e4, np.float32))
    secondary = (so, sd, np.full(n, 0.1, np.float32),
                 np.where(act, 8.0, -1.0).astype(np.float32),
                 np.where(act, 1e4, -1.0).astype(np.float32))
    return camera, secondary


@pytest.mark.parametrize("mode", MODES)
def test_routes_agree(scenes, mode, monkeypatch):
    """The port's two routes against each other, on the reference's own
    ray sets and with its own bounds between its routes: precise exact;
    the other modes on >= 99.9% of rays (the loop route normalises
    directions by division on the host, the batched kernel by a
    reciprocal in the kernel: an ulp can move a block entry). Each route
    equals its reference route exactly (tests above), so the port's
    routes differ where the reference's do."""
    _, ts = scenes
    camera, secondary = _route_rays(ts)
    rs = camera if mode in ("precise", "rough") else secondary
    monkeypatch.delenv("DUST_PALLAS_SCENE", raising=False)
    a = _port(ts, mode, rs)
    monkeypatch.setenv("DUST_PALLAS_SCENE", "loop")
    b = _port(ts, mode, rs)
    assert (a[1] >= 0).sum() > 50, "the rays must hit"
    if mode == "precise":
        _assert_exact(a, b)
        return
    for x, y in zip(a, b):
        if x.dtype.kind == "i":
            assert (x == y).mean() >= 0.999
        else:
            assert (np.isfinite(x) == np.isfinite(y)).mean() >= 0.999


def test_loop_route_launches_per_instance(scenes, monkeypatch):
    """The loop route calls the single-instance kernel once per instance,
    in index order; the batched route never calls it."""
    _, ts = scenes
    o, d = _aimed_rays(scenes[0], EYES[0], 256, 0)
    calls = []
    launch = hdda.hdda_instance

    def record(*args, **kw):
        calls.append(kw["mode"])
        return launch(*args, **kw)

    monkeypatch.setattr(hdda, "hdda_instance", record)
    monkeypatch.delenv("DUST_PALLAS_SCENE", raising=False)
    hdda.trace_scene(ts, tensor(o), tensor(d), 0.1, 1e4, "rough")
    assert calls == []
    monkeypatch.setenv("DUST_PALLAS_SCENE", "loop")
    hdda.trace_scene(ts, tensor(o), tensor(d), 0.1, 1e4, "rough")
    hdda.trace_scene_ao_fg(ts, tensor(o), tensor(d), 0.1, 8.0, 1e4)
    assert calls == ["rough"] * 5 + ["ao_fg"] * 5


# ---------------------------------------------------------------------------
# The stress scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stress():
    vox, anim = procgen.stress_scene(grid=3)
    js = build_device_scene(vox)
    return vox, anim, js


def test_stress_scene_carried_element_for_element(stress):
    _, _, js = stress
    assert js.num_instances == 11 and js.num_models == 2
    _assert_scene_equal(port_scene(js), js)


def test_stress_frame_ray_count_matches_bench(stress):
    """bench.py's accounting: four full-resolution launches plus two rays
    per valid cell of the budgeted refresh slice."""
    vox, _, js = stress
    from dust_tpu_torch.render.scene import build_device_scene as tbuild

    s = RenderSettings(width=1920, height=1080, gi_cache="dense")
    valid = (np.asarray(js.mask_lo) | np.asarray(js.mask_hi)) != 0
    cells = int(valid.sum(axis=1)[np.asarray(js.inst_model)].sum()) * 6
    rows = dense_rows(js)
    budget = s.surfels.dense_refresh_budget
    assert rows > budget
    expected = 1920 * 1080 * 4 + int(budget * cells / rows) * 2
    assert tpipe.frame_ray_count(tbuild(vox, "cpu"), s) == expected


# ---------------------------------------------------------------------------
# The frame with a rotating refresh budget
# ---------------------------------------------------------------------------

FRAMES = 3
# Down the line of teapots from behind the first: all five in view.
FRAME_EYE, FRAME_TARGET = (-100.0, 30.0, 60.0), (240.0, 20.0, 30.0)
FOV = 0.6


def _frame_settings(ts):
    rows = gilib.dense_rows(ts)
    budget = rows // 4 + 100         # 5 slices, the last one clamped
    s = RenderSettings(width=96, height=54, gi_cache="dense",
                       traversal_backend="pallas")
    return dataclasses.replace(
        s, surfels=dataclasses.replace(s.surfels,
                                       dense_refresh_budget=budget))


def _jax_state_numpy(st):
    return dict(gi=np.asarray(st.gi.table), surfels=np.asarray(st.surfels),
                denoiser=np.asarray(st.denoiser.history),
                exposure_avg=np.asarray(st.exposure_avg),
                frame_index=int(st.frame_index),
                prev_view_proj=np.asarray(st.prev_view_proj))


@pytest.fixture(scope="module")
def frames(scenes):
    """Both renderers over FRAMES frames, each carrying its own state (the
    reference on its XLA traversal backend, as tests/test_torch_frame.py
    runs it); also the reference's state after every frame."""
    js, ts = scenes
    s = _frame_settings(ts)
    c2w = jcam.look_at(FRAME_EYE, FRAME_TARGET)
    jc = jcam.camera_settings(c2w, FOV, s.camera.near, s.camera.far,
                              s.width, s.height)
    tc = tcam.camera_settings(c2w, FOV, s.camera.near, s.camera.far,
                              s.width, s.height, "cpu")
    jsk, tsk = jsky(s.sunlight), tsky(s.sunlight, "cpu")
    jbn, tbn = jnoise(), tnoise("cpu")
    jset = dataclasses.replace(s, traversal_backend="jnp")
    jst = jpipe.make_frame_state(jset, js)
    tst = tpipe.make_frame_state(s, ts, "cpu")
    out = dict(jax=[], torch=[], jax_states=[], settings=s,
               scenes=(ts, tc, tsk, tbn))
    for _ in range(FRAMES):
        jo, jaux, jst = jpipe.render_frame(js, jst, jc, jsk,
                                           jbn.unitvec3_cosine, jbn.scalar,
                                           jset)
        to, taux, tst = tpipe.render_frame(ts, tst, tc, tsk,
                                           tbn.unitvec3_cosine, tbn.scalar, s)
        out["jax"].append((np.asarray(jo), np.asarray(jaux["depth"])))
        out["torch"].append((to.numpy(), taux["depth"].numpy()))
        out["jax_states"].append(_jax_state_numpy(jst))
    return out


@pytest.mark.parametrize("frame", range(FRAMES))
def test_budgeted_frame_matches_reference(frames, frame):
    """Output RMSE < 0.01 and G-buffer hit masks on >= 99.5% of pixels,
    the bounds of tests/test_torch_frame.py."""
    jo, jdepth = frames["jax"][frame]
    to, tdepth = frames["torch"][frame]
    assert to.shape == jo.shape == (54, 96, 3)
    assert np.isfinite(to).all()
    hit_j, hit_t = np.isfinite(jdepth), np.isfinite(tdepth)
    assert hit_j.mean() > 0.08, "the camera must see the teapots"
    assert (hit_j == hit_t).mean() >= 0.995
    err = rmse(jo, to)
    assert err < 0.01, err


def _cache_rows(table):
    c = gilib.DenseGICache(table=torch.as_tensor(np.array(table)))
    return c.radiance.numpy(), c.count.numpy(), np.asarray(table)[:, 2]


def test_budgeted_refresh_rotates_like_reference(frames):
    """Reference state after frame 1 carried into the port: after frame 2
    the port's cache matches the reference's on >= 99% of live rows (the
    bound of tests/test_torch_frame.py), and only frame 2's slice of rows
    changed."""
    ts, tc, tsk, tbn = frames["scenes"]
    s = frames["settings"]
    state1 = tpipe.state_from_numpy(frames["jax_states"][0], "cpu")
    _out, _aux, state2 = tpipe.render_frame(ts, state1, tc, tsk,
                                            tbn.unitvec3_cosine, tbn.scalar, s)
    before = frames["jax_states"][0]["gi"]
    rad_r, cnt_r, alb_r = _cache_rows(frames["jax_states"][1]["gi"])
    rad_t, cnt_t, alb_t = _cache_rows(state2.gi.table.numpy())
    live = (cnt_r > 0) | (cnt_t > 0)
    assert live.sum() > 1000
    match = ((cnt_r == cnt_t) & (alb_r == alb_t)
             & np.isclose(rad_t, rad_r, rtol=1e-2, atol=1e-3).all(axis=1))
    assert match[live].mean() >= 0.99, match[live].mean()
    budget = s.surfels.dense_refresh_budget
    start = 1 * budget                                # frame index 1
    changed = np.flatnonzero((state2.gi.table.numpy() != before).any(axis=1))
    assert changed.min() >= start and changed.max() < start + budget
    assert len(changed) > budget // 10


def test_loop_route_frame_matches_batched_route(frames, monkeypatch):
    """The port's frame through both scene-trace routes: RMSE < 0.01."""
    ts, tc, tsk, tbn = frames["scenes"]
    s = frames["settings"]
    st = tpipe.make_frame_state(s, ts, "cpu")
    monkeypatch.delenv("DUST_PALLAS_SCENE", raising=False)
    a, _, _ = tpipe.render_frame(ts, st, tc, tsk, tbn.unitvec3_cosine,
                                 tbn.scalar, s)
    monkeypatch.setenv("DUST_PALLAS_SCENE", "loop")
    b, _, _ = tpipe.render_frame(ts, st, tc, tsk, tbn.unitvec3_cosine,
                                 tbn.scalar, s)
    assert rmse(a.numpy(), b.numpy()) < 0.01
