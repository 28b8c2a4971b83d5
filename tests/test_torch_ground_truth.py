"""The port's ground-truth generator (``dust_tpu_torch.tools.
gen_ground_truth``) against the reference's ``tools/gen_ground_truth.py``,
run as its users run it: from the repository root in a subprocess
(it sets JAX's global configuration and imports ``tests.quality_setup``),
with ``--cpu``, at 64x64 with one warm-up frame and two accumulated
frames. The port runs the same on the CPU (the eager backend, as the
reference's ``--cpu`` takes ``jnp``).

Tolerances: albedo and output (sRGB in [0, 1]) RMSE below 0.01; the
radiance, linear HDR (0 to about 120 here), RMSE below 0.01 of its RMS,
since the bf16 sky of both packages agrees to a few bf16 ulps (ROADMAP
Queue 3), which at radiances of 20 to 100 is 0.1 to 0.5 units; the
exposure within 1%. The output is tonemapped on the CPU by both, so the
reference's tonemap of the port's arrays gives the port's output.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dust_tpu_torch.tools import gen_ground_truth

REPO = Path(__file__).resolve().parents[1]
W = H = 64
WARMUP, FRAMES = 1, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread here (as tests/test_torch_hash.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gt")
    ref_path = tmp / "ref.npz"
    # The reference tool points JAX's persistent compilation cache at a
    # directory of its own; the test turns that cache off.
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               JAX_ENABLE_COMPILATION_CACHE="false")
    r = subprocess.run(
        [sys.executable, "tools/gen_ground_truth.py", "--cpu", "--width",
         str(W), "--height", str(H), "--warmup", str(WARMUP), "--frames",
         str(FRAMES), "--out", str(ref_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    port = gen_ground_truth.ground_truth(W, H, FRAMES, WARMUP, "cpu",
                                         log=lambda s: None)
    port_path = tmp / "port.npz"
    gen_ground_truth.write(str(port_path), port)
    return dict(np.load(ref_path)), port, port_path


def test_ground_truth_matches_the_reference(both):
    ref, port, _ = both
    for name in ("albedo", "output"):
        assert port[name].shape == (H, W, 3), name
        assert _rmse(port[name], ref[name]) < 0.01, name
    rad = _rmse(port["radiance"], ref["radiance"])
    scale = _rmse(ref["radiance"], 0.0)
    assert scale > 1.0 and rad < 0.01 * scale, (rad, scale)
    assert abs(float(port["exposure"]) / float(ref["exposure"]) - 1) < 0.01


def test_ground_truth_file_has_the_reference_fields(both):
    ref, _, port_path = both
    got = np.load(port_path)
    assert sorted(got.files) == sorted(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        assert got[name].shape == ref[name].shape, name
    for name in ("frames", "width", "height"):
        assert int(got[name]) == int(ref[name]), name
    png = port_path.with_suffix(".png")
    from dust_tpu_torch.utils.image import read_png
    assert read_png(str(png)).shape == (H, W, 3)


def test_output_is_the_reference_tonemap_of_the_port_arrays(both):
    from dust_tpu.ops import tonemap as jtonemap

    _, port, _ = both
    want = np.asarray(jtonemap.tonemap(
        jnp.asarray(port["radiance"]), jnp.asarray(port["albedo"]),
        jnp.asarray(float(port["exposure"])), transfer="srgb"))
    np.testing.assert_allclose(port["output"], want, rtol=0, atol=1e-6)
