"""The frame branches beyond the headline frame, the port against the
reference: the primary+shadow frame (no GI), the full-resolution denoise
(the indirect alone, and direct and indirect lumped), precise sun
shadows, the debug view with GI off, and the dense and hash frames on
the eager traversal backend (``traversal_backend="jnp"``).

The teapot at 128×72 (129×72 for the lumped case, so that the rays go in
raster order on the kernel's backend), three frames with carried state,
the teapot moving as in every ``bench.py`` config. The reference runs its
XLA wavefront traversal; the port runs the case's backend. Bounds, those
of tests/test_torch_frame.py: output RMSE < 0.01 and G-buffer hit masks
agreeing on >= 99.5% of pixels; on the eager backend the hit masks must
agree on every pixel. Measured: RMSE 5e-8 (primary+shadow), 1.7e-4 to
4.4e-4 (the others); hit masks equal everywhere.

With the teapot at rest a full-resolution frame reprojects every pixel
centre exactly onto a pixel corner of the history, where the reference's
compiled frame reads the corner rows and the bilinear weights through
differently rounded copies of one coordinate; there a few pixels keep or
drop their history by the last bit (RMSE 0.017). The port's full-
resolution denoiser is held to the reference's function as written, op
by op, on such a frame instead (test_full_res_denoiser_matches_reference).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dust_tpu import config as jconfig
from dust_tpu.ops import camera as jcam
from dust_tpu.ops import denoise as jden
from dust_tpu.ops.noise import load_blue_noise as jnoise
from dust_tpu.ops.sky import bake_sky as jsky
from dust_tpu.render import pipeline as jpipe
from dust_tpu.render.scene import build_device_scene
from dust_tpu.vox import procgen as jprocgen
from dust_tpu_torch import config as tconfig
from dust_tpu_torch.ops import camera as tcam
from dust_tpu_torch.ops import denoise as tden
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops import hdda
from dust_tpu_torch.ops.noise import load_blue_noise as tnoise
from dust_tpu_torch.ops.sky import bake_sky as tsky
from dust_tpu_torch.render import pipeline as tpipe
from tests.test_torch_hash_frame import _assert_table
from tests.torch_parity import (TEAPOT_EYE, TEAPOT_TARGET, port_scene,
                                teapot_vox)
from tools.rmse import rmse

FRAMES = 3
FOV = 0.9
NO_GI = dict(contribution_secondary_spatial_hash=False,
             contribution_secondary_skylight=False)
# name -> (settings fields, port backend, the port's kernel launches per
# frame: None on the eager backend, which launches none).
CASES = {
    "primary_shadow": (dict(NO_GI, contribution_secondary_sunlight=False),
                       "pallas", ["precise", "ao_fg"]),
    "full_res_split": (dict(denoiser=dict(half_res_indirect=False,
                                          split_direct=True)), "jnp", None),
    "full_res_lumped": (dict(width=129,
                             denoiser=dict(half_res_indirect=False)),
                        "pallas", ["precise", "ao_fg", "ao_threshold",
                                   "rough", "rough", "rough"]),
    "precise_shadows": (dict(shadow_mode="precise"), "pallas",
                        ["precise", "precise", "ao_threshold", "rough",
                         "rough", "rough"]),
    "debug_view_without_gi": (dict(NO_GI, debug_visualize_spatial_hash=True),
                              "jnp", None),
    "dense_eager": (dict(), "jnp", None),
    "hash_eager": (dict(gi_cache="hash", spatial_hash=dict(capacity=1 << 14),
                        surfels=dict(pool_size=1024)), "jnp", None),
}
NESTED = {"denoiser": "DenoiserSettings",
          "spatial_hash": "SpatialHashSettings", "surfels": "SurfelSettings"}


def _settings(config, backend, fields):
    """RenderSettings of one package from plain fields (nested settings
    as dicts), at 128×72 unless the fields say otherwise."""
    kw = dict(width=128, height=72, gi_cache="dense",
              traversal_backend=backend)
    for k, v in fields.items():
        kw[k] = getattr(config, NESTED[k])(**v) if k in NESTED else v
    return config.RenderSettings(**kw)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread, as in the other port tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    js = build_device_scene(teapot_vox())
    ts = port_scene(js)
    jbn, tbn = jnoise(), tnoise("cpu")
    return dict(js=js, ts=ts, base_o2w=np.asarray(js.obj_to_world), jbn=jbn,
                tbn=tbn)


def _cameras(s):
    c2w = jcam.look_at(TEAPOT_EYE, TEAPOT_TARGET)
    return (jcam.camera_settings(c2w, FOV, s.camera.near, s.camera.far,
                                 s.width, s.height),
            tcam.camera_settings(c2w, FOV, s.camera.near, s.camera.far,
                                 s.width, s.height, "cpu"))


def _state_numpy(st):
    return dict(gi=np.asarray(st.gi.table), surfels=np.asarray(st.surfels),
                frame_index=int(st.frame_index))


def _render_case(inputs, name, monkeypatch):
    """Both renderers over FRAMES frames of one case, the teapot moving;
    the port's kernel launch modes of each frame are recorded."""
    fields, backend, _ = CASES[name]
    js_set = _settings(jconfig, "jnp", fields)
    ts_set = _settings(tconfig, backend, fields)
    jc, tc = _cameras(ts_set)
    jsk, tsk = jsky(js_set.sunlight), tsky(ts_set.sunlight, "cpu")
    jbn, tbn = inputs["jbn"], inputs["tbn"]
    jst = jpipe.make_frame_state(js_set, inputs["js"])
    tst = tpipe.make_frame_state(ts_set, inputs["ts"], "cpu")
    modes = []
    launch = hdda.hdda

    def record(*args, **kw):
        modes[-1].append(kw["mode"])
        return launch(*args, **kw)

    monkeypatch.setattr(hdda, "hdda", record)
    out = dict(ref=[], port=[], ref_states=[], port_states=[], modes=modes,
               first_port_state=tst)
    for f in range(FRAMES):
        o2w = jprocgen.teapot_motion(inputs["base_o2w"], 0, f)
        modes.append([])
        jo, ja, jst = jpipe.render_frame(
            inputs["js"].with_transforms(jnp.asarray(o2w)), jst, jc, jsk,
            jbn.unitvec3_cosine, jbn.scalar, js_set)
        to, ta, tst = tpipe.render_frame(
            inputs["ts"].with_transforms(o2w), tst, tc, tsk,
            tbn.unitvec3_cosine, tbn.scalar, ts_set)
        out["ref"].append((np.asarray(jo), np.asarray(ja["depth"])))
        out["port"].append((to.numpy(), ta["depth"].numpy()))
        out["ref_states"].append(_state_numpy(jst))
        out["port_states"].append(tst)
    out["settings"] = ts_set
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_branch_matches_reference(inputs, name, monkeypatch):
    res = _render_case(inputs, name, monkeypatch)
    s = res["settings"]
    exact_hits = CASES[name][1] == "jnp"
    for (jo, jdepth), (to, tdepth) in zip(res["ref"], res["port"]):
        assert to.shape == jo.shape == (s.height, s.width, 3)
        assert np.isfinite(to).all()
        hit_j, hit_t = np.isfinite(jdepth), np.isfinite(tdepth)
        assert hit_j.mean() > 0.3, "the camera must see the teapot"
        agree = (hit_j == hit_t).mean()
        assert agree == 1.0 if exact_hits else agree >= 0.995, agree
        err = rmse(jo, to)
        assert err < 0.01, err
    launches = CASES[name][2]
    assert res["modes"] == [launches or []] * FRAMES


def test_primary_shadow_carries_the_state(inputs, monkeypatch):
    """Without GI the cache, the pool and the denoiser history carry over
    unchanged, and the frame counts 2·W·H rays."""
    res = _render_case(inputs, "primary_shadow", monkeypatch)
    first, last = res["first_port_state"], res["port_states"][-1]
    assert torch.equal(first.gi.table, last.gi.table)
    assert torch.equal(first.denoiser.history, last.denoiser.history)
    assert last.frame_index == FRAMES
    assert tpipe.frame_ray_count(inputs["ts"], res["settings"]) == 2 * 128 * 72


def test_eager_dense_cache_matches_reference(inputs, monkeypatch):
    """The dense cache after each eager frame: every row's sample count
    and albedo equal, and the radiance within rtol 1e-2 on >= 99% of the
    live rows (the sky the surfel pass inserts is the reference's bf16
    sky; tests/test_torch_frame.py). Measured: 3 of 18,432 values past
    rtol 1e-2, the largest 1.4% off."""
    res = _render_case(inputs, "dense_eager", monkeypatch)
    for ref, port in zip(res["ref_states"], res["port_states"]):
        a = gilib.DenseGICache(table=torch.as_tensor(ref["gi"].copy()))
        b = port.gi
        live = (a.count > 0).numpy()
        assert live.sum() > 500
        np.testing.assert_array_equal(b.count.numpy(), a.count.numpy())
        np.testing.assert_array_equal(b.table[:, 2].numpy(),
                                      a.table[:, 2].numpy())
        close = np.isclose(b.radiance.numpy(), a.radiance.numpy(),
                           rtol=1e-2, atol=1e-3).all(axis=1)
        assert close[live].mean() >= 0.99, close[live].mean()


def test_eager_hash_tables_match_reference(inputs, monkeypatch):
    """The hash table and surfel pool after each eager frame, held as in
    tests/test_torch_hash_frame.py. On the eager backend the rays stay in
    raster order, so pool slot i % P is the reference's."""
    res = _render_case(inputs, "hash_eager", monkeypatch)
    for f, (ref, port) in enumerate(zip(res["ref_states"],
                                        res["port_states"])):
        _assert_table(ref, port, min_occupied=10 * (f + 1))


def test_eager_backend_keeps_raster_order():
    """Only the kernel's backend tiles the rays."""
    img = torch.arange(72 * 256 * 3, dtype=torch.float32).reshape(72, 256, 3)
    raster, _ = tpipe._tiling(72, 256, False)
    tiled, _ = tpipe._tiling(72, 256, True)
    assert torch.equal(raster(img), img.reshape(-1, 3))
    assert not torch.equal(tiled(img), img.reshape(-1, 3))


def test_default_settings_render(inputs):
    """RenderSettings() as constructed (the hash cache, the eager backend,
    reference shadows, half-resolution denoise) makes its state, and
    renders at a small size."""
    s = tconfig.RenderSettings()
    assert (s.traversal_backend, s.gi_cache) == ("jnp", "hash")
    st = tpipe.make_frame_state(s, inputs["ts"], "cpu")
    assert tuple(st.denoiser.history.shape) == (s.height // 2, s.width // 2,
                                                3)
    small = dataclasses.replace(s, width=96, height=54)
    _jc, tc = _cameras(small)
    tbn = inputs["tbn"]
    st = tpipe.make_frame_state(small, inputs["ts"], "cpu")
    out, _aux, st = tpipe.render_frame(inputs["ts"], st, tc,
                                       tsky(small.sunlight, "cpu"),
                                       tbn.unitvec3_cosine, tbn.scalar, small)
    assert out.shape == (54, 96, 3) and bool(torch.isfinite(out).all())
    assert st.frame_index == 1


def test_full_res_denoiser_matches_reference(inputs):
    """The full-resolution denoiser on the inputs of a frame with the
    teapot at rest, after one frame of history: the port's ``denoise``
    against the reference's run op by op (outside jit), outputs within
    1e-4 of the largest radiance, history words equal."""
    fields, _, _ = CASES["full_res_lumped"]
    s = _settings(tconfig, "jnp", dict(fields, width=128))
    _jc, tc = _cameras(s)
    tbn = inputs["tbn"]
    calls = []
    st = tpipe.make_frame_state(s, inputs["ts"], "cpu")
    for _ in range(2):
        orig = tden.denoise

        def record(*args):
            calls.append(args)
            return orig(*args)

        tden.denoise = record
        try:
            _out, _aux, st = tpipe.render_frame(
                inputs["ts"], st, tc, tsky(s.sunlight, "cpu"),
                tbn.unitvec3_cosine, tbn.scalar, s)
        finally:
            tden.denoise = orig
    state, *images, vp, den = calls[-1]
    ref_out, ref_hd, ref_state = jden.denoise(
        jden.DenoiserState(history=jnp.asarray(
            state.history.numpy().view(np.uint32))),
        *(jnp.asarray(x.numpy()) for x in images), jnp.asarray(vp.numpy()),
        jconfig.DenoiserSettings(half_res_indirect=False))
    out, hd, new_state = tden.denoise(state, *images, vp, den)
    scale = float(images[0].abs().max())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_array_equal(new_state.history.numpy(),
                                  np.asarray(ref_state.history).view(np.int32))
