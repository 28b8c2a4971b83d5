"""The primary stage's G-buffer kernels (``csrc/gbuffer.cu``, bound by
``ops/gbuffer.py``): their entry points ``camera.primary_rays`` and
``shade.resolve_primary`` run the plain versions for CPU tensors and launch
nothing (the frame's rays and G-buffer as before); the library is built
with the HDDA kernel's flags; no kernel name holds ``hdda``. The tests
marked ``gpu`` hold both kernels, and a frame through them, equal to the
plain versions on the card (``chip_smoke.py``'s phase 25 at small
shapes); run them there with ``--noconftest``."""

import hashlib
import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

from dust_tpu_torch import bench, config
from dust_tpu_torch.ops import camera as cameralib
from dust_tpu_torch.ops import gbuffer, hdda, shade
from dust_tpu_torch.ops import packing as pk
from dust_tpu_torch.ops import sky as skylib
from dust_tpu_torch.ops.noise import load_blue_noise
from dust_tpu_torch.render import pipeline
from dust_tpu_torch.render.scene import build_device_scene
from dust_tpu_torch.vox import procgen
from dust_tpu_torch.vox.loader import load_vox_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EYE, TARGET = (26.0, 14.0, 32.0), (4.0, -4.0, 0.0)


@pytest.fixture(scope="module")
def teapot():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield build_device_scene(load_vox_scene(procgen.teapot_scene_bytes()),
                             "cpu")
    torch.set_num_threads(threads)


def _camera(width, height, device="cpu"):
    return cameralib.camera_settings(cameralib.look_at(EYE, TARGET), 0.9,
                                     0.1, 1e4, width, height, device)


def _launches():
    return dict(gbuffer.LAUNCHES)


@pytest.mark.parametrize("height, width, tiled, lo, hi", [
    (64, 256, True, 0, None), (64, 256, True, 1000, 9000),
    (72, 100, False, 0, None), (72, 100, False, 17, 7000),
    (16, 128, True, 2048, 2048)])
def test_primary_rays_plain_is_the_frame_order(height, width, tiled, lo,
                                               hi):
    """The rays [lo, hi) in the trace's order: the frame's former
    ``to_tiles(camera_ray_dirs(...))[lo:hi]`` and the expanded camera
    position, equal; on the CPU no launch."""
    cam = _camera(width, height)
    before = _launches()
    o, d = cameralib.primary_rays(cam, width, height, tiled, lo, hi)
    n = width * height
    hi = n if hi is None else hi
    to_tiles, _ = pipeline._tiling(height, width, tiled)
    assert pipeline._tiled(height, width, tiled) == tiled
    ref = to_tiles(cameralib.camera_ray_dirs(cam, width, height))[lo:hi]
    assert torch.equal(d, ref)
    assert torch.equal(o, cam.position.expand(hi - lo, 3))
    assert o.is_contiguous() and d.is_contiguous()
    assert _launches() == before


@pytest.mark.parametrize("args", [
    (100, 72, True, 0, None),       # does not divide into 8x128 tiles
    (256, 64, True, 10, 5),         # lo > hi
    (256, 64, False, 0, 256 * 64 + 1),
    (256, 64, False, -1, 10)])
def test_primary_rays_checks_its_range(args):
    width, height, tiled, lo, hi = args
    with pytest.raises(ValueError):
        cameralib.primary_rays(_camera(width, height), width, height, tiled,
                               lo, hi)


def test_resolve_primary_on_the_cpu_is_the_plain_version(teapot):
    """CPU tensors: resolve_primary is resolve_hits_plain, with
    ``sky_out`` the frame's former sky of the normalised directions, and
    resolve_hits the same without it; nothing launches."""
    cam = _camera(96, 54)
    o, d = cameralib.primary_rays(cam, 96, 54, False)
    res = hdda.trace_scene(teapot, o, d, cam.near, cam.far, "precise")
    sky_state = skylib.bake_sky(config.SunlightSettings(), "cpu")
    before = _launches()
    g = shade.resolve_primary(teapot, res, o, d, sky_state)
    plain = shade.resolve_hits_plain(teapot, res, o, d)
    assert _launches() == before
    assert int(plain["hit"].sum()) > 100 and int((~plain["hit"]).sum()) > 100
    assert list(g) == list(plain) + ["sky_out"]
    for k, v in plain.items():
        assert torch.equal(g[k], v), k
    assert list(shade.resolve_hits(teapot, res, o, d)) == list(plain)
    dirs_n = d / pk.norm3(d, keepdim=True)
    sky = (skylib.sky_radiance(sky_state, dirs_n)
           + skylib.sun_radiance(sky_state, dirs_n)) / 3.14
    assert torch.equal(g["sky_out"], sky)
    assert torch.equal(skylib.primary_sky(sky_state, d), sky)


def test_frame_on_the_cpu_launches_nothing(teapot):
    """A dense GI frame on CPU tensors takes the plain versions: the
    G-buffer kernels' counts stay as they were and nothing is built."""
    settings = config.RenderSettings(width=128, height=16, gi_cache="dense",
                                     traversal_backend="pallas")
    bn = load_blue_noise("cpu")
    state = pipeline.make_frame_state(settings, teapot, "cpu")
    before = _launches()
    lib = gbuffer._LIB
    img, aux, _ = pipeline.render_frame(
        teapot, state, _camera(128, 16),
        skylib.bake_sky(settings.sunlight, "cpu"), bn.unitvec3_cosine,
        bn.scalar, settings)
    assert img.shape == (16, 128, 3) and bool(torch.isfinite(img).all())
    assert _launches() == before
    assert gbuffer._LIB is lib


def test_wrappers_launch_only_on_cuda_tensors(teapot):
    """Called with CPU tensors, the launch wrappers raise: the entry
    points take the plain version there, nothing falls back."""
    cam = _camera(128, 8)
    o, d = cameralib.primary_rays(cam, 128, 8, True)
    res = hdda.trace_scene(teapot, o, d, cam.near, cam.far, "precise")
    with pytest.raises(ValueError, match="unsupported device"):
        gbuffer.rays(cam, 128, 8, True, 0, 1024)
    with pytest.raises(ValueError, match="unsupported device"):
        gbuffer.resolve(teapot, res, o, d)


def test_no_kernel_name_holds_hdda():
    """The benchmark counts every kernel whose name holds ``hdda`` as the
    traversal's; the G-buffer kernels' time is the glue's."""
    src = open(os.path.join(REPO, "dust_tpu_torch", "csrc",
                            "gbuffer.cu")).read()
    names = re.findall(r"__global__\s+void\s+"
                       r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert sorted(names) == ["gbuffer_resolve_kernel", "primary_rays_kernel"]
    assert not [n for n in names if "hdda" in n.lower()]


def test_built_with_the_hdda_flags(tmp_path, monkeypatch):
    """``gbuffer.build_library`` runs nvcc with ``hdda.NVCC_FLAGS``
    (``-fmad=false`` among them) on ``csrc/gbuffer.cu`` into
    ``libgbuffer_<hash>.so``, once; the HDDA library keeps its name."""
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(hdda, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(hdda, "_nvcc", lambda source=None: "/fake/nvcc")
    monkeypatch.setattr(hdda.subprocess, "run", fake_run)
    assert "-fmad=false" in hdda.NVCC_FLAGS
    for module, stem in ((gbuffer, "gbuffer"), (hdda, "hdda")):
        out = module.build_library()
        src = module._SOURCE.read_bytes()
        tag = hashlib.sha256(
            src + " ".join(hdda.NVCC_FLAGS).encode()).hexdigest()[:16]
        assert out == tmp_path / f"lib{stem}_{tag}.so" and out.exists()
        cmd = cmds[-1]
        assert cmd[0] == "/fake/nvcc"
        assert cmd[1:1 + len(hdda.NVCC_FLAGS)] == hdda.NVCC_FLAGS
        assert cmd[-1] == str(module._SOURCE)
        assert module.build_library() == out       # cached: no second run
    assert len(cmds) == 2
    assert gbuffer._SOURCE.name == "gbuffer.cu"


def test_no_compiler_raises_and_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(hdda, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(hdda.shutil, "which", lambda name: None)
    real_exists = os.path.exists
    monkeypatch.setattr(hdda.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc")
                        else real_exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gbuffer.build_library()
    left = tmp_path / "build"
    assert not left.exists() or not list(left.iterdir())


def test_importing_builds_nothing():
    code = ("import dust_tpu_torch.render.pipeline\n"
            "from dust_tpu_torch.ops import gbuffer\n"
            "assert gbuffer._LIB is None\n"
            "assert gbuffer.LAUNCHES == {'primary_rays': 0, "
            "'gbuffer_resolve': 0}\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


# ----------------------------------------------------------- on the card

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_gbuffer", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tiled", "chunk", "raster", "stress"])
def test_kernels_match_plain_on_the_card(card, case):
    """Both kernels equal to their plain versions in every field and bit
    (castle + teapot, or the 11-instance stress scene), at small shapes."""
    smoke = _chip_smoke()
    ctx = smoke._setup(card, 256, 64, "stress" if case == "stress" else "gi")
    width, height, tiled, lo, hi, instances = {
        "tiled": (256, 64, True, 0, None, 2),
        "chunk": (256, 64, True, 4096, 8192, 0),
        "raster": (200, 72, False, 0, None, 0),
        "stress": (256, 64, True, 0, None, 1)}[case]
    s = ctx["settings"]
    cam = cameralib.camera_settings(
        cameralib.look_at(bench.eye_for(ctx["args"], 0), bench.TARGET),
        s.camera.fov, s.camera.near, s.camera.far, width, height, card)
    smoke._gbuffer_case(f"gbuffer {case}", ctx["scene"], cam, ctx["sky"],
                        width, height, tiled, lo=lo, hi=hi,
                        instances=instances)


@pytest.mark.gpu
def test_frame_matches_plain_on_the_card(card):
    """A dense GI frame through the kernels and through the plain
    versions, from one state: output, aux and new state equal."""
    smoke = _chip_smoke()
    smoke._gbuffer_frame_equal("gbuffer frame", smoke._setup(card, 256, 128))
