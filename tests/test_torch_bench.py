"""The port's entry points on the CPU: the bench module
(``python -m dust_tpu_torch.bench``) prints the reference bench's one
JSON line, counts rays as ``bench.py`` counts them for every config, and
fails without a card unless the CPU is asked for; the CLI reaches a
``.vox`` file and the reference CLI's orbit and per-frame output on its
default (eager) backend. Subprocesses run torch on one thread."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dust_tpu.ops.gi_cache import dense_rows
from dust_tpu.render.scene import build_device_scene as jbuild
from dust_tpu.vox import procgen as jprocgen
from dust_tpu.vox.loader import load_vox_scene as jload
from dust_tpu_torch import bench
from dust_tpu_torch.render import pipeline as tpipe
from dust_tpu_torch.render.scene import build_device_scene as tbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ["metric", "value", "unit", "vs_baseline"]


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("extra", [
    ["--config", "primary-shadow"],
    ["--config", "hash-reference", "--hash-capacity", "4096"],
])
def test_bench_prints_one_json_line(extra):
    r = _run(["-m", "dust_tpu_torch.bench", "--device", "cpu", "--small",
              "--width", "64", "--height", "36", "--frames", "1"] + extra)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, r.stdout
    out = json.loads(lines[0])
    assert list(out) == KEYS
    assert out["metric"].startswith("Mrays/s/chip (castle+teapot 64x36, ")
    assert out["unit"] == "Mrays/s" and out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / 500.0,
                                               abs=1e-4)
    assert "backend jnp" in r.stderr and "device cpu" in r.stderr


def test_bench_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["-m", "dust_tpu_torch.bench", "--config", "gi"])
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


@pytest.fixture(scope="module")
def scenes():
    """(reference scene, port scene) of the castle + teapot and of the
    stress grid."""
    castle = jload(jprocgen.castle_scene_bytes())
    jprocgen.add_teapot(castle)
    stress, _ = jprocgen.stress_scene()
    return {"castle": (jbuild(castle), tbuild(castle, "cpu")),
            "stress": (jbuild(stress), tbuild(stress, "cpu"))}


def _bench_py_rays(js, args, width, height):
    """bench.py's ray accounting (bench.py:280-303) on the reference
    scene: four full-resolution launches and two rays per refreshed
    cell or pool slot; the primary and shadow launches alone without
    GI."""
    if args.gi_cache == "dense":
        valid = (np.asarray(js.mask_lo) | np.asarray(js.mask_hi)) != 0
        patch = int(valid.sum(axis=1)[np.asarray(js.inst_model)].sum()) * 6
        total = dense_rows(js)
        budget = 345_600   # SurfelSettings.dense_refresh_budget
        if budget and total > budget:
            patch = int(budget * patch / total)
    else:
        pool = 720 * 480
        patch = min(pool, args.pool_budget) if args.pool_budget else pool
    if args.config == "primary-shadow":
        return width * height * 2
    return width * height * 4 + patch * 2


@pytest.mark.parametrize("config", bench.CONFIGS)
def test_frame_ray_count_matches_bench_py(scenes, config):
    args = bench.parse_args(["--config", config])
    settings = bench.settings_for(args)
    assert settings.surfels.dense_refresh_budget == 345_600
    js, ts = scenes["stress" if config == "stress" else "castle"]
    want = _bench_py_rays(js, args, settings.width, settings.height)
    assert tpipe.frame_ray_count(ts, settings) == want
    size = (3840, 2160) if config in ("gi-4k", "flythrough") else (1920, 1080)
    assert (settings.width, settings.height) == size


def test_flythrough_orbits():
    """The flythrough eye circles the target at the reference CLI's rate,
    at a fixed height; the other configs keep their eye."""
    args = bench.parse_args(["--config", "flythrough"])
    e0, e1 = bench.eye_for(args, 0), bench.eye_for(args, 20)
    r0 = np.hypot(e0[0], e0[2])
    assert np.hypot(e1[0], e1[2]) == pytest.approx(r0, rel=1e-9)
    assert np.arctan2(e1[0], e1[2]) - np.arctan2(e0[0], e0[2]) == \
        pytest.approx(1.0)
    assert e0[1] == e1[1] == bench.EYE[1]
    gi = bench.parse_args(["--config", "gi"])
    assert bench.eye_for(gi, 20) == bench.EYE


def test_cli_renders_a_vox_file_on_its_default_backend(tmp_path):
    """--scene, --orbit and --all-frames; the default backend is the eager
    one, as the reference CLI's."""
    scene = tmp_path / "teapot.vox"
    scene.write_bytes(jprocgen.teapot_scene_bytes())
    out = tmp_path / "t.png"
    r = _run(["-m", "dust_tpu_torch.app.castle", "--scene", str(scene),
              "--width", "64", "--height", "36", "--frames", "2", "--orbit",
              "--all-frames", "--eye", "26", "14", "32", "--target", "4",
              "-4", "0", "--device", "cpu", "--out", str(out)])
    assert r.returncode == 0, r.stderr
    assert "(jnp)" in r.stderr
    from dust_tpu_torch.utils.image import read_png
    for path in (out, tmp_path / "t_000.png", tmp_path / "t_001.png"):
        img = np.asarray(read_png(str(path)), np.float64)
        assert img.shape[:2] == (36, 64)
        assert 0.02 < img.mean() < 0.98 * 255
