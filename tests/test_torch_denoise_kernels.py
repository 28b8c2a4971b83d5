"""The denoiser's kernels (``csrc/denoise.cu``, bound by ``ops/denoise.py``):
``denoise`` on CPU tensors is ``denoise_plain`` and launches nothing (the
sharded rows too, as ranks on threads); the wrapper raises on wrong shapes
and dtypes (its build, names, bindings and the raise off CUDA are
``tests/test_torch_csrc.py``'s). The tests marked ``gpu`` hold both
kernels and the whole step equal to the plain version on the card
(``chip_smoke.py``'s phase 27); run them there with ``--noconftest``."""

import dataclasses

import pytest
import torch
from torch_card import card, chip_smoke  # noqa: F401

from dust_tpu_torch import config
from dust_tpu_torch.ops import camera as cameralib
from dust_tpu_torch.ops import denoise as denoiselib
from dust_tpu_torch.ops import sky as skylib
from dust_tpu_torch.ops.noise import load_blue_noise
from dust_tpu_torch.render import pipeline
from dust_tpu_torch.render.scene import build_device_scene
from dust_tpu_torch.vox import procgen
from dust_tpu_torch.vox.loader import load_vox_scene

def _settings(passes=3):
    return dataclasses.replace(config.DenoiserSettings(),
                               atrous_iterations=passes)


def _steps(height, width, edge=False, seed=0, device="cpu"):
    return chip_smoke()._denoise_inputs(height, width, device, seed, edge)


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("height, width, passes, edge", [
    (54, 96, 3, False), (64, 128, 4, False), (30, 40, 1, False),
    (40, 64, 0, False), (32, 64, 3, True)])
def test_cpu_is_the_plain_version(height, width, passes, edge):
    """Two steps (still, then moved) on CPU tensors: ``denoise`` gives
    ``denoise_plain``'s results in every bit, launches nothing and builds
    nothing; the moved step keeps some history and loses some."""
    smoke = chip_smoke()
    handle, before = denoiselib.LIBRARY.handle, dict(denoiselib.LAUNCHES)
    out = smoke._denoise_case("cpu", "cpu", height, width, passes,
                              edge=edge)
    assert 0.05 < out["history_kept_b"] < 0.98
    assert denoiselib.LAUNCHES == before
    assert denoiselib.LIBRARY.handle is handle


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
    chip_smoke()._denoise_sharded_case("cpu sharded", "cpu", 45, 80, 3,
                                        ranks=ranks)


def _meta(steps):
    return {k: v.to("meta") for k, v in steps.items()}


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
    before, handle = dict(denoiselib.LAUNCHES), denoiselib.LIBRARY.handle
    img, _aux, new = pipeline.render_frame(
        teapot, state, cam, skylib.bake_sky(settings.sunlight, "cpu"),
        bn.unitvec3_cosine, bn.scalar, settings)
    assert img.shape == (16, 128, 3) and bool(torch.isfinite(img).all())
    shape = (8, 64, 3) if half else (16, 128, 3)
    assert new.denoiser.history.shape == shape
    assert denoiselib.LAUNCHES == before
    assert denoiselib.LIBRARY.handle is handle


# ----------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("height, width, passes, edge", [
    (1080, 1920, 3, False),   # the 4K frame's half-resolution step
    (540, 960, 3, False),     # the 1080p frames' half-resolution step
    (1080, 1920, 4, False),   # the full-resolution 1080p step
    (1080, 1920, 0, False),   # the temporal kernel alone
    (128, 256, 3, True)])     # reprojection onto the edges and past them
def test_kernels_match_plain_on_the_card(card, height, width, passes, edge):
    chip_smoke()._denoise_case(f"denoise {height}x{width}", card, height,
                                width, passes, edge=edge, seed=int(edge))


@pytest.mark.gpu
def test_sharded_rows_match_plain_on_the_card(card):
    chip_smoke()._denoise_sharded_case("denoise sharded", card, 540, 960, 3)


@pytest.mark.gpu
def test_frame_matches_plain_on_the_card(card):
    """A dense GI frame through the kernels and through the plain
    version, from one state: output, aux and new state equal."""
    smoke = chip_smoke()
    smoke._denoise_frame_equal("denoise frame", smoke._setup(card, 256, 128))
