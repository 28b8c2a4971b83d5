"""The port's utilities against the reference's: checkpoint / resume
(round trip, the reference's four rejections, a bit-exact dense resume),
the crash log, frame diagnostics and the device sync, the trace, the
CLI's frame pacing, the luminance histogram and the NRD packing helpers.

Tolerances: the histogram is held count for count; the packing helpers
within 1e-6 (float32 products the reference's compiler may fuse)."""

import dataclasses
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dust_tpu.config import ExposureSettings as JExposure
from dust_tpu.ops import exposure as jex
from dust_tpu.ops import packing as jpk
from dust_tpu_torch.config import (ExposureSettings, RenderSettings,
                                   SpatialHashSettings, SurfelSettings)
from dust_tpu_torch.ops import camera as tcam
from dust_tpu_torch.ops import exposure as tex
from dust_tpu_torch.ops import packing as tpk
from dust_tpu_torch.ops.noise import load_blue_noise
from dust_tpu_torch.ops.sky import bake_sky
from dust_tpu_torch.render import pipeline as tpipe
from dust_tpu_torch.render.scene import build_device_scene
from dust_tpu_torch.utils import checkpoint as ckpt
from dust_tpu_torch.utils import crashlog, profiling
from dust_tpu_torch.utils.checkpoint import load_state, save_state
from dust_tpu_torch.vox import procgen
from dust_tpu_torch.vox.loader import load_vox_scene
from tests.torch_parity import TEAPOT_EYE, TEAPOT_TARGET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread here: at these sizes threads buy
    little, and idle OpenMP workers would contend with other test
    processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- checkpoint ----------------------------------------------------------


def _hash_settings(w, h):
    return RenderSettings(width=w, height=h,
                          spatial_hash=SpatialHashSettings(capacity=256),
                          surfels=SurfelSettings(pool_size=64))


def test_frame_state_round_trip(tmp_path):
    settings = _hash_settings(16, 16)
    state = tpipe.make_frame_state(settings, None, "cpu")
    state = dataclasses.replace(
        state, frame_index=42, exposure_avg=torch.tensor(0.25),
        gi=type(state.gi)(table=torch.arange(
            state.gi.table.numel(), dtype=torch.int32).reshape(
            state.gi.table.shape)))
    path = str(tmp_path / "state.npz")
    save_state(path, state)
    loaded = load_state(path, tpipe.make_frame_state(settings, None, "cpu"))
    assert loaded.frame_index == 42 and isinstance(loaded.frame_index, int)
    assert float(loaded.exposure_avg) == 0.25
    assert torch.equal(loaded.gi.table, state.gi.table)
    assert torch.equal(loaded.surfels, state.surfels)
    assert loaded.gi_ws is None and type(loaded) is type(state)


def test_structure_mismatch_rejected(tmp_path):
    path = str(tmp_path / "t.npz")
    save_state(path, {"a": torch.zeros(4), "b": torch.ones(4)})
    with pytest.raises(ValueError, match="structure"):
        load_state(path, {"a": torch.zeros(4), "c": torch.ones(4)})


def test_dtype_mismatch_rejected(tmp_path):
    path = str(tmp_path / "d.npz")
    save_state(path, {"a": torch.zeros(4, dtype=torch.float32)})
    with pytest.raises(ValueError, match="dtype"):
        load_state(path, {"a": torch.zeros(4, dtype=torch.int32)})


def test_version_mismatch_rejected(tmp_path):
    path = str(tmp_path / "v.npz")
    np.savez(path, leaf_0=np.zeros(4, np.float32),
             __version__=np.asarray([999], np.int32))
    with pytest.raises(ValueError, match="version"):
        load_state(path, {"a": torch.zeros(4)})
    assert ckpt.FORMAT_VERSION == 1


def test_shape_mismatch_rejected(tmp_path):
    s1 = tpipe.make_frame_state(_hash_settings(8, 8), None, "cpu")
    s2 = tpipe.make_frame_state(_hash_settings(16, 16), None, "cpu")
    path = str(tmp_path / "s.npz")
    save_state(path, s1)
    with pytest.raises(ValueError, match="shape"):
        load_state(path, s2)


def test_missing_leaf_rejected(tmp_path):
    path = str(tmp_path / "m.npz")
    np.savez(path, __version__=np.asarray([1], np.int32))
    with pytest.raises(ValueError, match="missing leaf 0 of 1"):
        load_state(path, {"a": torch.zeros(4)})


def test_dense_checkpoint_resume_bit_exact(tmp_path):
    """Two 48x32 dense frames of the teapot, saved; a fresh state loaded
    from the file renders the third frame word for word as the run that
    never stopped."""
    settings = RenderSettings(width=48, height=32, gi_cache="dense",
                              traversal_backend="pallas")
    scene = build_device_scene(load_vox_scene(procgen.teapot_scene_bytes()),
                               "cpu")
    cam = tcam.camera_settings(tcam.look_at(TEAPOT_EYE, TEAPOT_TARGET), 0.9,
                               0.1, 10000.0, 48, 32, "cpu")
    sky, bn = bake_sky(settings.sunlight, "cpu"), load_blue_noise("cpu")

    def frame(state):
        return tpipe.render_frame(scene, state, cam, sky, bn.unitvec3_cosine,
                                  bn.scalar, settings)

    state = tpipe.make_frame_state(settings, scene, "cpu")
    for _ in range(2):
        _, _, state = frame(state)
    path = str(tmp_path / "dense.npz")
    save_state(path, state)
    resumed = load_state(path, tpipe.make_frame_state(settings, scene, "cpu"))
    assert resumed.frame_index == state.frame_index == 2
    out_a, _, a = frame(state)
    out_b, _, b = frame(resumed)
    assert torch.equal(out_a, out_b)
    assert torch.equal(a.gi.table, b.gi.table)
    assert torch.equal(a.denoiser.history, b.denoiser.history)


# ---- crash log, diagnostics, trace ---------------------------------------


def test_capture_writes_report(tmp_path):
    try:
        raise RuntimeError("boom")
    except RuntimeError:
        path = crashlog.capture(*sys.exc_info(), extra={"scene": "castle"},
                                directory=str(tmp_path))
    with open(path) as f:
        data = json.load(f)
    assert "boom" in data["exception"]
    assert data["context"]["scene"] == "castle"
    assert "devices" in data["device"] or "error" in data["device"]
    assert data["device"]["torch_version"] == torch.__version__
    assert os.path.dirname(path) == str(tmp_path)


def test_device_sync_is_the_finite_checksum():
    x = torch.tensor([1.5, float("nan"), 2.0, float("inf"), -0.5])
    assert profiling.device_sync(x) == 3.0
    assert profiling.device_sync(torch.arange(4, dtype=torch.int32)) == 6.0


def test_frame_diagnostics_reports(caplog):
    diag = profiling.FrameDiagnostics(report_every=3)
    with caplog.at_level(logging.INFO, logger="dust_tpu_torch"):
        for _ in range(4):
            diag.frame(torch.ones(3))
    records = [r for r in caplog.records if "frame time avg" in r.message]
    assert len(records) == 1
    assert diag._times == []


def test_trace_records_annotations(tmp_path):
    profiling.start_trace(str(tmp_path))
    with profiling.trace_annotation("edit_refit_span"):
        torch.ones(8).sum()
    path = profiling.stop_trace()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        assert "edit_refit_span" in f.read()
    with pytest.raises(RuntimeError, match="no trace"):
        profiling.stop_trace()


# ---- the CLI's frame pacing ----------------------------------------------


@pytest.mark.parametrize("in_flight", [0, 1])
def test_cli_frames_in_flight(tmp_path, in_flight):
    out = tmp_path / "c.png"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "dust_tpu_torch.app.castle", "--width", "48",
         "--height", "32", "--frames", "3", "--device", "cpu", "--backend",
         "pallas", "--frames-in-flight", str(in_flight), "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert out.exists() and "rendered 3 frames" in r.stderr


# ---- the luminance histogram and the NRD packing helpers ------------------


def _seeded(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def test_luminance_histogram_matches_reference():
    img = np.exp(_seeded((32, 48, 3), 1, 4.0)).astype(np.float32)
    img[:4] = 0.0                                     # black: bin 0
    hist = tex.luminance_histogram(torch.as_tensor(img), ExposureSettings())
    want = np.asarray(jex.luminance_histogram(jnp.asarray(img), JExposure()))
    assert hist.dtype == torch.int32 and hist.shape == (256,)
    np.testing.assert_array_equal(hist.numpy(), want)
    assert int(hist.sum()) == 32 * 48 and int(hist[0]) >= 4 * 48


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                               atol=1e-6)


def test_ycocg_and_radiance_hitdist_match_reference():
    rgb = np.abs(_seeded((256, 3), 2, 3.0))
    hd = np.abs(_seeded((256,), 3))
    hd[::7] = 0.0
    hd[1::7] = 1e-9
    t = torch.as_tensor
    _close(tpk.linear_to_ycocg(t(rgb)), jpk.linear_to_ycocg(jnp.asarray(rgb)))
    y = _seeded((256, 3), 4)
    _close(tpk.ycocg_to_linear(t(y)), jpk.ycocg_to_linear(jnp.asarray(y)))
    packed = tpk.pack_radiance_hitdist(t(rgb), t(hd))
    _close(packed, jpk.pack_radiance_hitdist(jnp.asarray(rgb),
                                             jnp.asarray(hd)))
    rad, dist = tpk.unpack_radiance_hitdist(packed)
    jrad, jdist = jpk.unpack_radiance_hitdist(jnp.asarray(packed.numpy()))
    _close(rad, jrad)
    _close(dist, jdist)
    _close(rad, rgb)


@pytest.mark.parametrize("signed", [False, True])
def test_oct_normals_match_reference(signed):
    n = _seeded((512, 3), 5)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    enc = tpk.encode_oct_normal(torch.as_tensor(n), signed=signed)
    _close(enc, jpk.encode_oct_normal(jnp.asarray(n), signed=signed))
    for normalize in (False, True):
        _close(tpk.decode_oct_normal(enc, signed=signed, normalize=normalize),
               jpk.decode_oct_normal(jnp.asarray(enc.numpy()), signed=signed,
                                     normalize=normalize))


def test_normal_roughness_match_reference():
    n = _seeded((128, 3), 6)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rough = np.abs(_seeded((128,), 7)) % 1.0
    mat = np.arange(128) % 5
    p = tpk.pack_normal_roughness(torch.as_tensor(n), torch.as_tensor(rough),
                                  torch.as_tensor(mat))
    _close(p, jpk.pack_normal_roughness(jnp.asarray(n), jnp.asarray(rough),
                                        jnp.asarray(mat)))
    _close(tpk.pack_normal_roughness(torch.as_tensor(n), 0.5, 2),
           jpk.pack_normal_roughness(jnp.asarray(n), 0.5, 2))
    for a, b in zip(tpk.unpack_normal_roughness(p),
                    jpk.unpack_normal_roughness(jnp.asarray(p.numpy()))):
        _close(a, b)
