"""The denoiser's kernels (``csrc/denoise.cu``, bound by ``ops/denoise.py``):
``denoise`` on CPU tensors is ``denoise_plain`` and launches nothing (the
sharded rows too, as ranks on threads); the wrapper raises off CUDA and on
wrong shapes and dtypes; the launch arguments' ctypes layout is the
source's; no kernel name holds ``hdda``; the library is built with the
HDDA kernel's flags at first use. The tests marked ``gpu`` hold both
kernels and the whole step equal to the plain version on the card
(``chip_smoke.py``'s phase 27); run them there with ``--noconftest``."""

import dataclasses
import hashlib
import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

from dust_tpu_torch import config
from dust_tpu_torch.ops import camera as cameralib
from dust_tpu_torch.ops import denoise as denoiselib
from dust_tpu_torch.ops import hdda
from dust_tpu_torch.ops import sky as skylib
from dust_tpu_torch.ops.noise import load_blue_noise
from dust_tpu_torch.render import pipeline
from dust_tpu_torch.render.scene import build_device_scene
from dust_tpu_torch.vox import procgen
from dust_tpu_torch.vox.loader import load_vox_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "dust_tpu_torch", "csrc", "denoise.cu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_denoise", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _settings(passes=3):
    return dataclasses.replace(config.DenoiserSettings(),
                               atrous_iterations=passes)


def _steps(height, width, edge=False, seed=0, device="cpu"):
    return _chip_smoke()._denoise_inputs(height, width, device, seed, edge)


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("height, width, passes, edge", [
    (54, 96, 3, False), (64, 128, 4, False), (30, 40, 1, False),
    (40, 64, 0, False), (32, 64, 3, True)])
def test_cpu_is_the_plain_version(height, width, passes, edge):
    """Two steps (still, then moved) on CPU tensors: ``denoise`` gives
    ``denoise_plain``'s results in every bit, launches nothing and builds
    nothing; the moved step keeps some history and loses some."""
    smoke = _chip_smoke()
    lib, before = denoiselib._LIB, dict(denoiselib.LAUNCHES)
    out = smoke._denoise_case("cpu", "cpu", height, width, passes,
                              edge=edge)
    assert 0.05 < out["history_kept_b"] < 0.98
    assert denoiselib.LAUNCHES == before and denoiselib._LIB is lib


def test_edge_inputs_land_on_the_edges():
    """The edge case's reprojected pixel centres land exactly on 0.5 and
    W - 0.5 (and H's), and some just outside."""
    b = _steps(32, 64, edge=True)["b"]
    xy, w = denoiselib._project(b["prev_view_proj"],
                                b["world_pos"] + b["motion"], 64, 32)
    x, y = xy[..., 0], xy[..., 1]
    assert bool((w == 1.0).all())
    for v, hi in ((x, 64), (y, 32)):
        assert int((v == 0.5).sum()) > 0 and int((v == hi - 0.5).sum()) > 0
        assert int((v < 0.5).sum()) > 0 and int((v > hi - 0.5).sum()) > 0


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_cpu_sharded_rows_are_the_whole_step(ranks):
    """``rows=(lo, hi, gather)`` on ranks run as threads (the sharded
    frame's calls): the ranks' rows joined equal the whole image's step,
    every bit."""
    _chip_smoke()._denoise_sharded_case("cpu sharded", "cpu", 45, 80, 3,
                                        ranks=ranks)


def _meta(steps):
    return {k: v.to("meta") for k, v in steps.items()}


def test_wrapper_raises_off_cuda():
    """Tensors on a device that is neither the CPU nor CUDA: the kernels'
    wrapper checks them and raises; called directly with CPU tensors it
    raises too (``denoise`` takes the plain version there)."""
    a = _steps(16, 32)["a"]
    state = denoiselib.make_denoiser_state(16, 32, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        denoiselib.denoise(state, settings=_settings(), **_meta(a))
    cpu_state = denoiselib.make_denoiser_state(16, 32, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        denoiselib._denoise_kernels(cpu_state, settings=_settings(),
                                    rows=None, **a)


@pytest.mark.parametrize("field, bad, error", [
    ("radiance", lambda t: t[:-1], ValueError),
    ("radiance", lambda t: t.double(), TypeError),
    ("hitdist", lambda t: t[:, :-1], ValueError),
    ("depth", lambda t: t.half(), TypeError),
    ("depth", lambda t: t[None], ValueError),
    ("normal", lambda t: t[..., :2], ValueError),
    ("world_pos", lambda t: t.int(), TypeError),
    ("motion", lambda t: t[1:], ValueError),
    ("prev_view_proj", lambda t: t[:3], ValueError),
    ("history", lambda t: t.float(), TypeError),
    ("history", lambda t: t[:, :-1], ValueError)])
def test_wrapper_checks_shapes_and_dtypes(field, bad, error):
    a = _meta(_steps(16, 32)["a"])
    state = denoiselib.make_denoiser_state(16, 32, "meta")
    if field == "history":
        state = denoiselib.DenoiserState(history=bad(state.history))
    else:
        a[field] = bad(a[field])
    with pytest.raises(error):
        denoiselib.denoise(state, settings=_settings(), **a)


@pytest.mark.parametrize("changes, match", [
    (dict(normal_sigma=31.5), "normal_sigma"),
    (dict(normal_sigma=0.0), "normal_sigma")])
def test_wrapper_takes_a_positive_integer_normal_power(changes, match):
    a = _meta(_steps(16, 32)["a"])
    state = denoiselib.make_denoiser_state(16, 32, "meta")
    with pytest.raises(ValueError, match=match):
        denoiselib.denoise(state, settings=dataclasses.replace(
            _settings(), **changes), **a)


def test_wrapper_checks_the_rows_window():
    a = _meta(_steps(16, 32)["a"])
    state = denoiselib.make_denoiser_state(16, 32, "meta")
    with pytest.raises(ValueError, match="rows"):
        denoiselib.denoise(state, settings=_settings(),
                           rows=(4, 12, lambda x: x), **a)


@pytest.mark.parametrize("c_name, cls", [
    ("TemporalArgs", denoiselib._TemporalArgs),
    ("AtrousArgs", denoiselib._AtrousArgs)])
def test_launch_arguments_match_the_source(c_name, cls):
    """The ctypes structures list the source's members in its order, a
    pointer for each pointer, an int for each int, a float for each
    float."""
    src = open(SOURCE).read()
    body = re.sub(r"//[^\n]*", "", re.search(
        r"struct %s \{(.*?)\};" % c_name, src, re.S).group(1))
    members = re.findall(r"([\w\s]+?\*?)\s*(\w+)\s*;", body)
    assert [n for _t, n in members] == [f[0] for f in cls._fields_]
    for (ctype, _n), (_name, py) in zip(members, cls._fields_):
        want = (denoiselib.ctypes.c_void_p if "*" in ctype else
                denoiselib.ctypes.c_int if ctype.strip() == "int" else
                denoiselib.ctypes.c_float)
        assert py is want, (ctype, _n)


def test_no_kernel_name_holds_hdda():
    """The benchmark counts every kernel whose name holds ``hdda`` as the
    traversal's and reads ``denoise_device_ms`` from those holding
    ``denoise_``."""
    src = open(SOURCE).read()
    names = re.findall(r"__global__\s+void\s+"
                       r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert sorted(names) == ["denoise_atrous_kernel",
                             "denoise_temporal_kernel"]
    assert all("denoise_" in n and "hdda" not in n.lower() for n in names)


def test_built_with_the_hdda_flags(tmp_path, monkeypatch):
    """``denoise.build_library`` runs nvcc with ``hdda.NVCC_FLAGS``
    (``-fmad=false`` among them) on ``csrc/denoise.cu`` into
    ``libdenoise_<hash>.so``, once."""
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(hdda, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(hdda, "_nvcc", lambda source=None: "/fake/nvcc")
    monkeypatch.setattr(hdda.subprocess, "run", fake_run)
    assert "-fmad=false" in hdda.NVCC_FLAGS
    out = denoiselib.build_library()
    src = denoiselib._SOURCE.read_bytes()
    tag = hashlib.sha256(
        src + " ".join(hdda.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert out == tmp_path / f"libdenoise_{tag}.so" and out.exists()
    assert cmds[-1][0] == "/fake/nvcc"
    assert cmds[-1][1:1 + len(hdda.NVCC_FLAGS)] == hdda.NVCC_FLAGS
    assert cmds[-1][-1] == str(denoiselib._SOURCE) == SOURCE
    assert denoiselib.build_library() == out      # cached: no second run
    assert len(cmds) == 1


def test_no_compiler_raises_and_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(hdda, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(hdda.shutil, "which", lambda name: None)
    real_exists = os.path.exists
    monkeypatch.setattr(hdda.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc")
                        else real_exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        denoiselib.build_library()
    left = tmp_path / "build"
    assert not left.exists() or not list(left.iterdir())


def test_importing_builds_nothing():
    code = ("import dust_tpu_torch.render.pipeline\n"
            "from dust_tpu_torch.ops import denoise\n"
            "assert denoise._LIB is None\n"
            "assert denoise.LAUNCHES == {'denoise_temporal': 0, "
            "'denoise_atrous': 0}\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


@pytest.fixture(scope="module")
def teapot():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield build_device_scene(load_vox_scene(procgen.teapot_scene_bytes()),
                             "cpu")
    torch.set_num_threads(threads)


@pytest.mark.parametrize("half", [True, False])
def test_frame_on_the_cpu_launches_nothing(teapot, half):
    """A dense GI frame on CPU tensors, half and full resolution: the
    denoiser's counts stay as they were and nothing is built."""
    settings = config.RenderSettings(width=128, height=16, gi_cache="dense",
                                     traversal_backend="pallas")
    settings = dataclasses.replace(settings, denoiser=dataclasses.replace(
        settings.denoiser, half_res_indirect=half))
    bn = load_blue_noise("cpu")
    state = pipeline.make_frame_state(settings, teapot, "cpu")
    cam = cameralib.camera_settings(
        cameralib.look_at((26.0, 14.0, 32.0), (4.0, -4.0, 0.0)), 0.9, 0.1,
        1e4, 128, 16, "cpu")
    before, lib = dict(denoiselib.LAUNCHES), denoiselib._LIB
    img, _aux, new = pipeline.render_frame(
        teapot, state, cam, skylib.bake_sky(settings.sunlight, "cpu"),
        bn.unitvec3_cosine, bn.scalar, settings)
    assert img.shape == (16, 128, 3) and bool(torch.isfinite(img).all())
    shape = (8, 64, 3) if half else (16, 128, 3)
    assert new.denoiser.history.shape == shape
    assert denoiselib.LAUNCHES == before and denoiselib._LIB is lib


# ----------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("height, width, passes, edge", [
    (1080, 1920, 3, False),   # the 4K frame's half-resolution step
    (540, 960, 3, False),     # the 1080p frames' half-resolution step
    (1080, 1920, 4, False),   # the full-resolution 1080p step
    (1080, 1920, 0, False),   # the temporal kernel alone
    (128, 256, 3, True)])     # reprojection onto the edges and past them
def test_kernels_match_plain_on_the_card(card, height, width, passes, edge):
    _chip_smoke()._denoise_case(f"denoise {height}x{width}", card, height,
                                width, passes, edge=edge, seed=int(edge))


@pytest.mark.gpu
def test_sharded_rows_match_plain_on_the_card(card):
    _chip_smoke()._denoise_sharded_case("denoise sharded", card, 540, 960, 3)


@pytest.mark.gpu
def test_frame_matches_plain_on_the_card(card):
    """A dense GI frame through the kernels and through the plain
    version, from one state: output, aux and new state equal."""
    smoke = _chip_smoke()
    smoke._denoise_frame_equal("denoise frame", smoke._setup(card, 256, 128))
