"""The slice as a whole: the port's frame against the reference's frame.

The teapot at 128×72 (a tiled ray order), dense GI cache, reference-mode
sun shadows, half-resolution indirect denoise, three frames with carried
state. The reference runs its XLA wavefront traversal
(``traversal_backend="jnp"``); the port runs the plain version of its
HDDA kernel, which follows the Pallas kernel. The two traversal backends
differ on epsilon ties, so the bounds are those of
tests/test_backend_parity.py: output RMSE < 0.01 and G-buffer hit masks
agreeing on >= 99.5% of pixels.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dust_tpu.config import RenderSettings
from dust_tpu.ops import camera as jcam
from dust_tpu.ops.noise import load_blue_noise as jnoise
from dust_tpu.ops.sky import bake_sky as jsky
from dust_tpu.render import pipeline as jpipe
from dust_tpu.render.scene import build_device_scene
from dust_tpu_torch.ops import camera as tcam
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops import hdda
from dust_tpu_torch.ops.noise import load_blue_noise as tnoise
from dust_tpu_torch.ops.sky import bake_sky as tsky
from dust_tpu_torch.render import pipeline as tpipe
from tests.torch_parity import TEAPOT_EYE, TEAPOT_TARGET, port_scene, teapot_vox
from tools.rmse import rmse

FRAMES = 3
FOV = 0.9
SETTINGS = RenderSettings(width=128, height=72, gi_cache="dense",
                          traversal_backend="pallas")


def _jax_state_numpy(st):
    return dict(gi=np.asarray(st.gi.table), surfels=np.asarray(st.surfels),
                denoiser=np.asarray(st.denoiser.history),
                exposure_avg=np.asarray(st.exposure_avg),
                frame_index=int(st.frame_index),
                prev_view_proj=np.asarray(st.prev_view_proj))


def render_both():
    """Both renderers over FRAMES frames, each carrying its own state; also
    the reference's state after every frame."""
    s = SETTINGS
    js = build_device_scene(teapot_vox())
    ts = port_scene(js)
    c2w = jcam.look_at(TEAPOT_EYE, TEAPOT_TARGET)
    jc = jcam.camera_settings(c2w, FOV, s.camera.near, s.camera.far,
                              s.width, s.height)
    tc = tcam.camera_settings(c2w, FOV, s.camera.near, s.camera.far,
                              s.width, s.height, "cpu")
    jsk, tsk = jsky(s.sunlight), tsky(s.sunlight, "cpu")
    jbn, tbn = jnoise(), tnoise("cpu")
    jset = dataclasses.replace(s, traversal_backend="jnp")

    jst = jpipe.make_frame_state(jset, js)
    tst = tpipe.make_frame_state(s, ts, "cpu")
    out = dict(jax=[], torch=[], jax_states=[])
    for _ in range(FRAMES):
        jo, jaux, jst = jpipe.render_frame(js, jst, jc, jsk,
                                           jbn.unitvec3_cosine, jbn.scalar,
                                           jset)
        to, taux, tst = tpipe.render_frame(ts, tst, tc, tsk,
                                           tbn.unitvec3_cosine, tbn.scalar, s)
        out["jax"].append((np.asarray(jo), np.asarray(jaux["depth"])))
        out["torch"].append((to.numpy(), taux["depth"].numpy()))
        out["jax_states"].append(_jax_state_numpy(jst))
    out["scenes"] = (ts, tc, tsk, tbn)
    return out


@pytest.fixture(scope="module")
def frames():
    return render_both()


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frame_matches_reference(frames, frame):
    jo, jdepth = frames["jax"][frame]
    to, tdepth = frames["torch"][frame]
    assert to.shape == jo.shape == (SETTINGS.height, SETTINGS.width, 3)
    assert np.isfinite(to).all()
    hit_j, hit_t = np.isfinite(jdepth), np.isfinite(tdepth)
    assert hit_j.mean() > 0.3, "the camera must see the teapot"
    assert (hit_j == hit_t).mean() >= 0.995
    err = rmse(jo, to)
    assert err < 0.01, err


def _cache_rows(table):
    t = torch.as_tensor(table)
    c = gilib.DenseGICache(table=t)
    return c.radiance.numpy(), c.count.numpy(), t[:, 2].numpy()


def test_carried_state_gives_the_reference_cache(frames):
    """Reference state after frame 1, carried into the port: the port's
    cache after frame 2 matches the reference's on >= 99% of its rows.
    A row matches when its sample count and albedo word are equal and its
    f16 radiance agrees within rtol 1e-2: the surfel pass inserts sky
    radiance, which the reference evaluates in bf16 (see test_torch_ops)."""
    ts, tc, tsk, tbn = frames["scenes"]
    state1 = tpipe.state_from_numpy(frames["jax_states"][0], "cpu")
    np.testing.assert_array_equal(state1.gi.table.numpy(),
                                  frames["jax_states"][0]["gi"])
    _out, _aux, state2 = tpipe.render_frame(ts, state1, tc, tsk,
                                            tbn.unitvec3_cosine, tbn.scalar,
                                            SETTINGS)
    rad_r, cnt_r, alb_r = _cache_rows(frames["jax_states"][1]["gi"])
    rad_t, cnt_t, alb_t = _cache_rows(state2.gi.table.numpy())
    live = (cnt_r > 0) | (cnt_t > 0)
    assert live.sum() > 1000 and (cnt_r[live] == 2).mean() > 0.5
    match = ((cnt_r == cnt_t) & (alb_r == alb_t)
             & np.isclose(rad_t, rad_r, rtol=1e-2, atol=1e-3).all(axis=1))
    assert match[live].mean() >= 0.99, match[live].mean()
    assert state2.frame_index == 2


def test_frame_runs_six_traces(frames, monkeypatch):
    """One frame traces six times: precise, ao_fg, ao_threshold, and
    three rough walks (final gather, surfel sun, surfel cosine)."""
    ts, tc, tsk, tbn = frames["scenes"]
    modes = []
    launch = hdda.hdda

    def record(*args, **kw):
        modes.append(kw["mode"])
        return launch(*args, **kw)

    monkeypatch.setattr(hdda, "hdda", record)
    st = tpipe.make_frame_state(SETTINGS, ts, "cpu")
    tpipe.render_frame(ts, st, tc, tsk, tbn.unitvec3_cosine, tbn.scalar,
                       SETTINGS)
    assert modes == ["precise", "ao_fg", "ao_threshold", "rough", "rough",
                     "rough"]


# Every setting renders now (tests/test_torch_branches.py,
# tests/test_torch_materials.py); a material type that nobody registered
# raises, as in the reference.
@pytest.mark.parametrize("change", [
    pytest.param(dict(instance_materials=(7,)), id="change3"),
])
def test_unported_settings_raise(frames, change):
    ts, tc, tsk, tbn = frames["scenes"]
    s = dataclasses.replace(SETTINGS, **change)
    with pytest.raises(KeyError, match="not registered"):
        st = tpipe.make_frame_state(SETTINGS, ts, "cpu")
        tpipe.render_frame(ts, st, tc, tsk, tbn.unitvec3_cosine, tbn.scalar, s)
