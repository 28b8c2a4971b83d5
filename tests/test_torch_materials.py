"""The port's material registry against the reference's: the registry's
API and errors, the palette-only identity (a frame with
``instance_materials=(0, 0)`` renders), and an emissive frame held
against the reference's at 96x54 (output RMSE < 0.01, the frame tests'
bound) that is brighter on the emissive instance's pixels. Every test
leaves both registries as it found them."""

import dataclasses

import numpy as np
import pytest
import torch

from dust_tpu.config import RenderSettings as JSettings
from dust_tpu.ops import camera as jcam
from dust_tpu.ops.noise import load_blue_noise as jnoise
from dust_tpu.ops.sky import bake_sky as jsky
from dust_tpu.render import materials as jmat
from dust_tpu.render import pipeline as jpipe
from dust_tpu.render.scene import build_device_scene as jbuild
from dust_tpu_torch.config import RenderSettings
from dust_tpu_torch.ops import camera as tcam
from dust_tpu_torch.ops.noise import load_blue_noise as tnoise
from dust_tpu_torch.ops.sky import bake_sky as tsky
from dust_tpu_torch.render import materials as tmat
from dust_tpu_torch.render import pipeline as tpipe
from tests.torch_parity import (TEAPOT_EYE, TEAPOT_TARGET, five_teapots_vox,
                                port_scene)
from tools.rmse import rmse

W, H, FOV = 96, 54, 0.9
STRENGTH = 6.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread here: at these sizes threads buy
    little, and idle OpenMP workers would contend with other test
    processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def registries():
    """Both packages' registries restored after each test."""
    saved = dict(tmat._REGISTRY), dict(jmat._REGISTRY)
    yield
    for reg, old in zip((tmat._REGISTRY, jmat._REGISTRY), saved):
        reg.clear()
        reg.update(old)


def test_registry_api():
    reg = tmat.material_registry()
    assert list(reg) == [0] and isinstance(reg[0], tmat.PaletteMaterial)
    reg[5] = tmat.EmissiveMaterial()          # a copy: the registry is kept
    assert 5 not in tmat.material_registry()
    tmat.register_material(3, tmat.EmissiveMaterial(strength=2.0))
    assert tmat.material_registry()[3] == tmat.EmissiveMaterial(strength=2.0)
    with pytest.raises(ValueError, match="palette baseline"):
        tmat.register_material(0, tmat.EmissiveMaterial())
    assert tmat.Material().shade({}, None) == {}
    assert (tmat.PaletteMaterial().name, tmat.EmissiveMaterial().name,
            tmat.EmissiveMaterial().strength) == (
        jmat.PaletteMaterial().name, jmat.EmissiveMaterial().name,
        jmat.EmissiveMaterial().strength)


def _gbuffer(n=8):
    rng = np.random.default_rng(4)
    albedo = rng.random((n, 4)).astype(np.float32)
    hit = np.arange(n) % 3 != 0
    inst = np.arange(n) % 2
    return ({"hit": torch.as_tensor(hit), "inst": torch.as_tensor(inst),
             "albedo": torch.as_tensor(albedo)},
            {"hit": hit, "inst": inst, "albedo": albedo})


@pytest.mark.parametrize("ids", [(), (0,), (0, 0)])
def test_palette_only_is_identity(ids):
    g, _ = _gbuffer()
    g2, em = tmat.apply_materials(g, ids)
    assert g2 is g
    assert em.shape == (8, 3) and not bool(em.any())


def test_unregistered_type_raises():
    g, _ = _gbuffer()
    with pytest.raises(KeyError, match="not registered"):
        tmat.apply_materials(g, (0, 9))


@pytest.mark.parametrize("ids", [(0, 1), (1, 0), (1, 1)])
def test_emission_lanes_match_reference(ids):
    """Lanes chosen by instance and hit, the same emission as the
    reference's on the same G-buffer."""
    import jax.numpy as jnp

    tmat.register_material(1, tmat.EmissiveMaterial(strength=STRENGTH))
    jmat.register_material(1, jmat.EmissiveMaterial(strength=STRENGTH))
    g, gn = _gbuffer()
    _, em = tmat.apply_materials(g, ids)
    _, jem = jmat.apply_materials({k: jnp.asarray(v) for k, v in gn.items()},
                                  ids)
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    assert bool(em.any())


def test_replacement_albedo_applies_to_its_lanes():
    @dataclasses.dataclass(frozen=True)
    class Grey(tmat.Material):
        def shade(self, g, lanes):
            return {"albedo": torch.full_like(g["albedo"], 0.5)}

    tmat.register_material(2, Grey())
    g, gn = _gbuffer()
    g2, _ = tmat.apply_materials(g, (0, 2))
    lanes = gn["hit"] & (gn["inst"] == 1)
    want = np.where(lanes[:, None], 0.5, gn["albedo"])
    np.testing.assert_array_equal(g2["albedo"].numpy(), want)
    assert g["albedo"] is not g2["albedo"]


@pytest.fixture(scope="module")
def scenes():
    """Two teapots side by side: the second one is made emissive."""
    vox = five_teapots_vox()
    del vox.instances[2:]
    js = jbuild(vox)
    return js, port_scene(js)


def _cameras():
    c2w = jcam.look_at((TEAPOT_EYE[0] + 60.0, TEAPOT_EYE[1] + 20.0,
                        TEAPOT_EYE[2] + 90.0),
                       (TEAPOT_TARGET[0] + 60.0, TEAPOT_TARGET[1] + 5.0,
                        TEAPOT_TARGET[2] + 7.0))
    return (jcam.camera_settings(c2w, FOV, 0.1, 10000.0, W, H),
            tcam.camera_settings(c2w, FOV, 0.1, 10000.0, W, H, "cpu"))


def _port_frame(ts, settings):
    _, tc = _cameras()
    bn = tnoise("cpu")
    state = tpipe.make_frame_state(settings, ts, "cpu")
    out, aux, _ = tpipe.render_frame(ts, state, tc, tsky(settings.sunlight,
                                                         "cpu"),
                                     bn.unitvec3_cosine, bn.scalar, settings,
                                     tile=2048)
    return out.numpy(), aux["voxel_id"].numpy()


def test_palette_instances_render_as_no_materials(scenes):
    """The repaired fault: all-palette ids render, and render the frame
    without materials."""
    _, ts = scenes
    s = RenderSettings(width=W, height=H, gi_cache="dense")
    plain, _ = _port_frame(ts, s)
    same, _ = _port_frame(ts, dataclasses.replace(s,
                                                  instance_materials=(0, 0)))
    np.testing.assert_array_equal(same, plain)


def test_emissive_frame_matches_reference(scenes):
    js, ts = scenes
    tmat.register_material(1, tmat.EmissiveMaterial(strength=STRENGTH))
    jmat.register_material(1, jmat.EmissiveMaterial(strength=STRENGTH))
    s = RenderSettings(width=W, height=H, gi_cache="dense")
    lit_s = dataclasses.replace(s, instance_materials=(0, 1))
    plain, vid = _port_frame(ts, s)
    lit, _ = _port_frame(ts, lit_s)

    jc, _ = _cameras()
    jset = JSettings(width=W, height=H, gi_cache="dense",
                     instance_materials=(0, 1))
    bn = jnoise()
    jout, _, _ = jpipe.render_frame(js, jpipe.make_frame_state(jset, js), jc,
                                    jsky(jset.sunlight), bn.unitvec3_cosine,
                                    bn.scalar, jset, tile=2048)
    err = rmse(np.asarray(jout), lit)
    assert err < 0.01, err

    px = (vid & 0xFFFF) == 1                  # the emissive instance
    assert px.sum() > 20
    assert lit[px].mean() > plain[px].mean() + 0.02
