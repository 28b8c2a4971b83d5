"""The primary stage's G-buffer kernels (``csrc/gbuffer.cu``, bound by
``ops/gbuffer.py``): their entry points ``camera.primary_rays`` and
``shade.resolve_primary`` run the plain versions for CPU tensors and launch
nothing (the frame's rays and G-buffer as before). The library's build,
names and bindings are ``tests/test_torch_csrc.py``'s. The tests marked
``gpu`` hold both kernels, and a frame through them, equal to the plain
versions on the card (``chip_smoke.py``'s phase 25 at small shapes); run
them there with ``--noconftest``."""

import pytest
import torch
from torch_card import card, chip_smoke  # noqa: F401

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
    handle = gbuffer.LIBRARY.handle
    img, aux, _ = pipeline.render_frame(
        teapot, state, _camera(128, 16),
        skylib.bake_sky(settings.sunlight, "cpu"), bn.unitvec3_cosine,
        bn.scalar, settings)
    assert img.shape == (16, 128, 3) and bool(torch.isfinite(img).all())
    assert _launches() == before
    assert gbuffer.LIBRARY.handle is handle


# ----------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tiled", "chunk", "raster", "stress"])
def test_kernels_match_plain_on_the_card(card, case):
    """Both kernels equal to their plain versions in every field and bit
    (castle + teapot, or the 11-instance stress scene), at small shapes."""
    smoke = chip_smoke()
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
    smoke = chip_smoke()
    smoke._gbuffer_frame_equal("gbuffer frame", smoke._setup(card, 256, 128))
