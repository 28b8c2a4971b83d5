"""The spatial-hash frame of the port against the reference's frame.

The teapot at 128×72 (a tiled ray order), the default GI cache
(``gi_cache="hash"``) at capacity 2^14 with a 1024-surfel pool,
reference-mode sun shadows, half-resolution indirect denoise, three
frames with carried state. The reference runs its XLA wavefront
traversal (``traversal_backend="jnp"``); the port runs the plain version
of its HDDA kernel. Bounds:

* output RMSE < 0.01 and G-buffer hit masks agreeing on >= 99.5% of
  pixels (tests/test_backend_parity.py's bounds, as in
  tests/test_torch_frame.py);
* the hash table: over the slots occupied in either table, fingerprint,
  last frame and sample count equal on >= 99%, and on those slots the
  LogLuv word within 4 log-luminance steps (0.68% in luminance) and 2
  steps of u and of v. The surfel pass inserts sky radiance, which the
  reference evaluates in bfloat16 (tests/test_torch_ops.py), so the
  running means differ in their last bits and a code may move;
* the surfel pool: rows equal on >= 99% (a pool row is written by the
  blue-noise enqueue and requeue, whose draws depend on sample counts,
  and counts are held exactly);
* the working set under rotation: sample counts and albedo words equal
  on >= 99.9% of rows, and where the counts agree the radiance within
  rtol 3e-2: its float16 words carry the decoded LogLuv radiance, and
  the code bounds above allow 0.68% in luminance and 2/820 in each
  chroma coordinate, which the XYZ -> ACEScg matrix spreads over RGB.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dust_tpu.config import RenderSettings as JSettings
from dust_tpu.config import SpatialHashSettings as JHash
from dust_tpu.config import SurfelSettings as JSurfels
from dust_tpu.ops import camera as jcam
from dust_tpu.ops import gi_cache as jgi
from dust_tpu.ops import spatial_hash as jsh
from dust_tpu.ops.noise import load_blue_noise as jnoise
from dust_tpu.ops.sky import bake_sky as jsky
from dust_tpu.render import pipeline as jpipe
from dust_tpu.render.scene import build_device_scene
from dust_tpu_torch.config import (RenderSettings, SpatialHashSettings,
                                   SurfelSettings)
from dust_tpu_torch.ops import camera as tcam
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops import hdda
from dust_tpu_torch.ops.noise import load_blue_noise as tnoise
from dust_tpu_torch.ops.sky import bake_sky as tsky
from dust_tpu_torch.render import pipeline as tpipe
from tests.torch_parity import (TEAPOT_EYE, TEAPOT_TARGET, port_scene,
                                teapot_vox)
from tools.rmse import rmse

FRAMES = 3
FOV = 0.9
SETTINGS = RenderSettings(
    width=128, height=72, traversal_backend="pallas",
    spatial_hash=SpatialHashSettings(capacity=1 << 14),
    surfels=SurfelSettings(pool_size=1024))
# Working-set probe in 3 rotating slices, the pool refreshed 512 slots a
# frame, and an insert cap that binds.
ROTATING = dataclasses.replace(
    SETTINGS,
    spatial_hash=SpatialHashSettings(capacity=1 << 14, ws_refresh_slices=3,
                                     insert_cap=16),
    surfels=SurfelSettings(pool_size=1024, pool_refresh_budget=512))


def _ref_settings(s):
    """The same settings for the reference, on its XLA traversal (the
    fields these tests leave at their defaults are equal in both
    packages: tests/test_torch_standalone.py)."""
    return JSettings(
        width=s.width, height=s.height, gi_cache=s.gi_cache,
        debug_visualize_spatial_hash=s.debug_visualize_spatial_hash,
        spatial_hash=JHash(**dataclasses.asdict(s.spatial_hash)),
        surfels=JSurfels(**dataclasses.asdict(s.surfels)),
        traversal_backend="jnp")


def _state_numpy(st):
    """A reference FrameState as numpy (before the next frame donates it)."""
    return dict(gi=np.asarray(st.gi.table), surfels=np.asarray(st.surfels),
                denoiser=np.asarray(st.denoiser.history),
                exposure_avg=np.asarray(st.exposure_avg),
                frame_index=int(st.frame_index),
                prev_view_proj=np.asarray(st.prev_view_proj),
                gi_ws=None if st.gi_ws is None else np.asarray(st.gi_ws.table))


def _ref_state(fields, template):
    """A reference FrameState from numpy fields (the hash mode's)."""
    return template._replace(
        gi=jsh.SpatialHash(table=jnp.asarray(fields["gi"])),
        surfels=jnp.asarray(fields["surfels"]),
        denoiser=type(template.denoiser)(
            history=jnp.asarray(fields["denoiser"])),
        exposure_avg=jnp.asarray(fields["exposure_avg"]),
        frame_index=jnp.asarray(fields["frame_index"], jnp.int32),
        prev_view_proj=jnp.asarray(fields["prev_view_proj"]),
        gi_ws=None if fields["gi_ws"] is None else jgi.DenseGICache(
            table=jnp.asarray(fields["gi_ws"])))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread here: at these sizes threads buy
    little, and idle OpenMP workers would contend with other test
    processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    js = build_device_scene(teapot_vox())
    ts = port_scene(js)
    s = SETTINGS
    c2w = jcam.look_at(TEAPOT_EYE, TEAPOT_TARGET)
    jc = jcam.camera_settings(c2w, FOV, s.camera.near, s.camera.far,
                              s.width, s.height)
    tc = tcam.camera_settings(c2w, FOV, s.camera.near, s.camera.far,
                              s.width, s.height, "cpu")
    jbn, tbn = jnoise(), tnoise("cpu")
    return dict(ref=(js, jc, jsky(s.sunlight), jbn.unitvec3_cosine,
                     jbn.scalar),
                port=(ts, tc, tsky(s.sunlight, "cpu"), tbn.unitvec3_cosine,
                      tbn.scalar))


def _render_ref(inputs, state, settings):
    js, jc, jsk, jcos, jscal = inputs["ref"]
    out, aux, state = jpipe.render_frame(js, state, jc, jsk, jcos, jscal,
                                         _ref_settings(settings))
    return np.asarray(out), np.asarray(aux["depth"]), state


def _render_port(inputs, state, settings):
    ts, tc, tsk, tcos, tscal = inputs["port"]
    out, aux, state = tpipe.render_frame(ts, state, tc, tsk, tcos, tscal,
                                         settings)
    return out.numpy(), aux["depth"].numpy(), state


def _render_both(inputs, settings):
    jst = jpipe.make_frame_state(_ref_settings(settings), inputs["ref"][0])
    tst = tpipe.make_frame_state(settings, inputs["port"][0], "cpu")
    out = dict(ref=[], port=[], ref_states=[], port_states=[])
    for _ in range(FRAMES):
        *r, jst = _render_ref(inputs, jst, settings)
        *t, tst = _render_port(inputs, tst, settings)
        out["ref"].append(r)
        out["port"].append(t)
        out["ref_states"].append(_state_numpy(jst))
        out["port_states"].append(tst)
    out["template"] = jst
    return out


@pytest.fixture(scope="module")
def frames(inputs):
    return _render_both(inputs, SETTINGS)


@pytest.fixture(scope="module")
def rotating(inputs):
    return _render_both(inputs, ROTATING)


def _assert_image(ref, port):
    (jo, jdepth), (to, tdepth) = ref, port
    assert to.shape == jo.shape == (SETTINGS.height, SETTINGS.width, 3)
    assert np.isfinite(to).all()
    hit_j, hit_t = np.isfinite(jdepth), np.isfinite(tdepth)
    assert hit_j.mean() > 0.3, "the camera must see the teapot"
    assert (hit_j == hit_t).mean() >= 0.995
    err = rmse(jo, to)
    assert err < 0.01, err


def _assert_table(ref_fields, port_state, min_occupied):
    a = ref_fields["gi"].reshape(-1, 4)
    b = port_state.gi.table.numpy().reshape(-1, 4)
    occ = (a[:, 0] != 0) | (b[:, 0] != 0)
    assert occ.sum() >= min_occupied, occ.sum()
    same = (a[:, 0] == b[:, 0]) & (a[:, 2] == b[:, 2]) & (a[:, 3] == b[:, 3])
    assert same[occ].mean() >= 0.99, same[occ].mean()
    wa = a[occ & same, 1].astype(np.int64) & 0xFFFFFFFF
    wb = b[occ & same, 1].astype(np.int64) & 0xFFFFFFFF
    assert np.abs((wa >> 18) - (wb >> 18)).max(initial=0) <= 4
    assert np.abs(((wa >> 9) & 511) - ((wb >> 9) & 511)).max(initial=0) <= 2
    assert np.abs((wa & 511) - (wb & 511)).max(initial=0) <= 2
    pool = (ref_fields["surfels"] == port_state.surfels.numpy()).all(axis=1)
    assert pool.mean() >= 0.99, pool.mean()
    assert port_state.frame_index == ref_fields["frame_index"]


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frame_matches_reference(frames, frame):
    _assert_image(frames["ref"][frame], frames["port"][frame])


@pytest.mark.parametrize("frame", range(FRAMES))
def test_table_and_pool_match_reference(frames, frame):
    _assert_table(frames["ref_states"][frame], frames["port_states"][frame],
                  min_occupied=10 * (frame + 1))


def test_carried_state_gives_the_reference_frame(frames, inputs):
    """The reference's state after frame 2, carried into the port: both
    render frame 3 alike, and leave alike tables and pools."""
    fields = frames["ref_states"][1]
    state = tpipe.state_from_numpy(fields, "cpu")
    np.testing.assert_array_equal(state.gi.table.numpy(), fields["gi"])
    assert isinstance(state.gi, tpipe.sh.SpatialHash) and state.gi_ws is None
    *t, state3 = _render_port(inputs, state, SETTINGS)
    _assert_image(frames["ref"][2], t)
    _assert_table(frames["ref_states"][2], state3, min_occupied=30)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_rotating_slices_match_reference(rotating, frame):
    """ws_refresh_slices=3, pool_refresh_budget=512, insert_cap=16."""
    _assert_image(rotating["ref"][frame], rotating["port"][frame])
    ref = rotating["ref_states"][frame]
    port = rotating["port_states"][frame]
    _assert_table(ref, port, min_occupied=5)
    # At most insert_cap groups written a frame.
    assert (port.gi.table.numpy().reshape(-1, 4)[:, 0] != 0).sum() <= \
        16 * (frame + 1) * 3
    ws_r = gilib.DenseGICache(table=torch.tensor(ref["gi_ws"]))
    ws_t = port.gi_ws
    cnt_r, cnt_t = ws_r.count.numpy(), ws_t.count.numpy()
    assert (cnt_r == cnt_t).mean() >= 0.999
    agree = cnt_r == cnt_t
    np.testing.assert_allclose(ws_t.radiance.numpy()[agree],
                               ws_r.radiance.numpy()[agree], rtol=3e-2,
                               atol=1e-3)
    np.testing.assert_array_equal(ws_t.table.numpy()[:, 2],
                                  ref["gi_ws"][:, 2])


@pytest.mark.parametrize("cache", ["dense", "hash"])
def test_debug_visualize_spatial_hash(frames, inputs, cache):
    """The cache shown directly: from the reference's state after frame 3
    (hash) or after one dense frame (dense), one frame each."""
    s = dataclasses.replace(SETTINGS, debug_visualize_spatial_hash=True,
                            gi_cache=cache)
    if cache == "hash":
        fields = frames["ref_states"][2]
        jst = _ref_state(fields, frames["template"])
        tst = tpipe.state_from_numpy(fields, "cpu")
    else:
        jst = jpipe.make_frame_state(_ref_settings(s), inputs["ref"][0])
        tst = tpipe.make_frame_state(s, inputs["port"][0], "cpu")
        *_r, jst = _render_ref(inputs, jst, s)
        *_t, tst = _render_port(inputs, tst, s)
    ref = _render_ref(inputs, jst, s)[:2]
    port = _render_port(inputs, tst, s)[:2]
    _assert_image(ref, port)
    plain = _render_port(inputs, tst, dataclasses.replace(
        s, debug_visualize_spatial_hash=False))[0]
    assert rmse(plain, port[0]) > 1e-3, "the debug view must show the cache"


def test_default_cache_renders(inputs, monkeypatch):
    """RenderSettings' own GI cache (hash, 2^20 slots, a 345,600-surfel
    pool) through make_frame_state and render_frame: six traces, a finite
    image, and the state's shapes."""
    s = RenderSettings(width=96, height=54, traversal_backend="pallas")
    assert s.gi_cache == "hash"
    ts, tc, tsk, tcos, tscal = inputs["port"]
    tc = tcam.camera_settings(tcam.look_at(TEAPOT_EYE, TEAPOT_TARGET), FOV,
                              s.camera.near, s.camera.far, s.width, s.height,
                              "cpu")
    modes = []
    launch = hdda.hdda

    def record(*args, **kw):
        modes.append(kw["mode"])
        return launch(*args, **kw)

    monkeypatch.setattr(hdda, "hdda", record)
    st = tpipe.make_frame_state(s, ts, "cpu")
    out, _aux, st = tpipe.render_frame(ts, st, tc, tsk, tcos, tscal, s)
    assert modes == ["precise", "ao_fg", "ao_threshold", "rough", "rough",
                     "rough"]
    assert out.shape == (54, 96, 3) and torch.isfinite(out).all()
    assert tuple(st.gi.table.shape) == (1 << 18, 16)
    assert tuple(st.surfels.shape) == (720 * 480, 4)
    assert bool((st.surfels[:, 3] < 6).any()), "the pool must fill"
    assert st.frame_index == 1 and st.gi_ws is None


@pytest.mark.parametrize("budget", [0, 512])
def test_frame_ray_count(inputs, budget):
    """bench.py's accounting: four full-resolution launches and two rays
    per pool slot, or per slot of the budget's slice."""
    ts = inputs["port"][0]
    s = dataclasses.replace(SETTINGS, surfels=SurfelSettings(
        pool_size=1024, pool_refresh_budget=budget))
    assert tpipe.frame_ray_count(ts, s) == 4 * 128 * 72 + 2 * (budget or 1024)
    full = RenderSettings(spatial_hash=SpatialHashSettings(capacity=1 << 25))
    assert tpipe.frame_ray_count(ts, full) == 8_985_600


def test_cli_renders_hash_frame_on_cpu(tmp_path):
    """The port's CLI with the reference CLI's hash flags, on the CPU (on
    one thread, as the rest of this file)."""
    out = tmp_path / "h.png"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "dust_tpu_torch.app.castle", "--width", "128",
         "--height", "72", "--frames", "2", "--teapot", "--gi-cache", "hash",
         "--hash-capacity", "65536", "--surfels", "4096", "--device", "cpu",
         "--backend", "pallas", "--out", str(out)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    from dust_tpu_torch.utils.image import read_png
    img = np.asarray(read_png(str(out)), np.float64)
    assert img.shape[:2] == (72, 128)
    assert 0.02 < img.mean() < 0.98 * 255
