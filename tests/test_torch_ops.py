"""The port's per-ray and per-pixel operators against the reference's, on
the same numpy inputs: camera, sky, packing, blue noise and its frame
fetch, the PCG frame hash and the ray tiling, hit shading, the dense GI
cache, the denoiser, exposure and tonemap.

Tolerances: float32 results within 1e-6 (absolute or relative, as each
test states) where the computation is the same op for op; the denoiser,
exposure and tonemap within rtol 1e-5, atol 1e-5 (both run float32 on
the CPU, only the summation order and the exp/log/pow implementations
differ); the sky model past its arccos within bf16 precision, because the
reference evaluates it in bfloat16 and XLA places the bf16 roundings
differently from PyTorch's per-op rounding. Packed words (the GI cache,
R10G10B10A2, the PCG hash) are compared bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dust_tpu.config import DenoiserSettings, ExposureSettings, RenderSettings
from dust_tpu.ops import camera as jcam
from dust_tpu.ops import denoise as jden
from dust_tpu.ops import exposure as jexp
from dust_tpu.ops import gi_cache as jgi
from dust_tpu.ops import noise as jnoise
from dust_tpu.ops import packing as jpk
from dust_tpu.ops import shade as jshade
from dust_tpu.ops import sky as jsky
from dust_tpu.ops import tonemap as jtone
from dust_tpu.ops.pallas_trace import trace_scene_pallas
from dust_tpu.render import pipeline as jpipe
from dust_tpu.render.scene import build_device_scene
from dust_tpu.utils import color as jcolor
from dust_tpu.vox.geometry import unpack_r10g10b10a2 as junpack
from dust_tpu_torch.ops import camera as tcam
from dust_tpu_torch.ops import denoise as tden
from dust_tpu_torch.ops import exposure as texp
from dust_tpu_torch.ops import gi_cache as tgi
from dust_tpu_torch.ops import noise as tnoise
from dust_tpu_torch.ops import packing as tpk
from dust_tpu_torch.ops import shade as tshade
from dust_tpu_torch.ops import sky as tsky
from dust_tpu_torch.ops import tonemap as ttone
from dust_tpu_torch.ops.traverse import TraceResult
from dust_tpu_torch.render import pipeline as tpipe
from dust_tpu_torch.utils import color as tcolor
from dust_tpu_torch.vox.geometry import unpack_r10g10b10a2 as tunpack
from tests.torch_parity import (TEAPOT_EYE, TEAPOT_TARGET, camera_rays,
                                port_scene, teapot_vox, tensor)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------- camera

def test_camera():
    c2w = tcam.look_at(TEAPOT_EYE, TEAPOT_TARGET)
    np.testing.assert_array_equal(c2w, jcam.look_at(TEAPOT_EYE, TEAPOT_TARGET))
    np.testing.assert_array_equal(tcam.perspective_infinite_reverse(1.1, 1.7, 0.1),
                                  jcam.perspective_infinite_reverse(1.1, 1.7, 0.1))
    tc = tcam.camera_settings(c2w, 1.1, 0.1, 5000.0, 96, 54, "cpu")
    jc = jcam.camera_settings(c2w, 1.1, 0.1, 5000.0, 96, 54)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    _close(tcam.camera_ray_dirs(tc, 96, 54), jcam.camera_ray_dirs(jc, 96, 54))


# ---------------------------------------------------------------- sky

@pytest.fixture(scope="module")
def skies():
    s = RenderSettings().sunlight
    return jsky.bake_sky(s), tsky.bake_sky(s, "cpu")


def test_sky_bake(skies):
    js, ts = skies
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_sky_and_sun_radiance(skies):
    js, ts = skies
    rng = np.random.default_rng(0)
    d = _unit(rng, 4096)
    d[0] = np.asarray(js.direction)                  # inside the sun disc
    # bf16 model: the reference rounds to bf16 at XLA's places, the port
    # after every op; both agree to a few bf16 ulps (2^-8 relative each).
    _close(tsky.sky_radiance(ts, tensor(d)), jsky.sky_radiance(js, d),
           rtol=3e-2, atol=1e-3)
    _close(tsky.sun_radiance(ts, tensor(d)), jsky.sun_radiance(js, d),
           rtol=1e-5, atol=1e-6)
    assert float(tsky.sun_radiance(ts, tensor(d))[0].sum()) > 0.0


# ---------------------------------------------------------------- packing

def test_packing():
    rng = np.random.default_rng(1)
    n = _unit(rng, 2048)
    n[:6] = np.eye(3).repeat(2, 0) * np.array([1, -1] * 3)[:, None]
    n[6] = (0.0, 0.0, -1.0)                          # degenerate quaternion
    t = _unit(rng, 2048)
    _close(tpk.rotate_vector_by_normal(tensor(n), tensor(t)),
           jpk.rotate_vector_by_normal(jnp.asarray(n), jnp.asarray(t)))
    faces = np.arange(2048, dtype=np.int32) % 6
    fn = tpk.face_id_to_normal(torch.as_tensor(faces))
    np.testing.assert_array_equal(_np(fn), np.asarray(
        jpk.face_id_to_normal(jnp.asarray(faces))))
    cube = tpk.cubed_normalize(tensor(n))
    np.testing.assert_array_equal(_np(cube),
                                  np.asarray(jpk.cubed_normalize(jnp.asarray(n))))
    np.testing.assert_array_equal(_np(tpk.normal_to_face_id(fn)), faces)
    np.testing.assert_array_equal(
        _np(tpk.normal_to_face_id(cube)),
        np.asarray(jpk.normal_to_face_id(jpk.cubed_normalize(jnp.asarray(n)))))
    _close(tpk.encode_oct_normal(tensor(n)), jpk.encode_oct_normal(jnp.asarray(n)))
    p = rng.uniform(size=(2048, 2)).astype(np.float32)
    _close(tpk.decode_oct_normal(tensor(p)), jpk.decode_oct_normal(jnp.asarray(p)))


# ---------------------------------------------------------------- noise

@pytest.fixture(scope="module")
def noises():
    return jnoise.load_blue_noise(), tnoise.load_blue_noise("cpu")


def test_blue_noise_tables(noises):
    jb, tb = noises
    for name in ("scalar", "vec2", "vec3", "unitvec2", "unitvec3",
                 "unitvec3_cosine"):
        np.testing.assert_array_equal(_np(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)))


def _jax_bn_fetch(table, layer, offset, rand, H, W):
    """pipeline.py:279-293 (the frame's closure), unjitted."""
    th, tw = table.shape[1], table.shape[2]
    page = table[layer]
    sy = (offset[1] + rand) % th
    page = jnp.roll(page, shift=(-sy, -(offset[0] + rand) % tw), axis=(0, 1))
    return jnp.tile(page, (-(-H // th), -(-W // tw), 1))[:H, :W]


def _jax_bn_fetch_pool(table, layer, offset, rand, p):
    """pipeline.py:601-613, unjitted."""
    th, tw = table.shape[1], table.shape[2]
    page = table[layer]
    sy = (offset[1] + rand) % th
    page = jnp.roll(page, shift=(-sy, -(offset[0] + rand) % tw), axis=(0, 1))
    return jnp.tile(page.reshape(th * tw, -1), (-(-p // (th * tw)), 1))[:p]


@pytest.mark.parametrize("frame", [0, 1, 37, 64, 1000])
def test_blue_noise_frame_fetch(noises, frame):
    jb, tb = noises
    rand = int(jpipe._pcg_scalar(jnp.int32(frame)))
    assert tpipe._pcg_scalar(frame) == rand
    layer = frame % 64
    for off, (H, W) in (((7, 183), (72, 136)), ((3, 5), (300, 260))):
        np.testing.assert_array_equal(
            _np(tnoise.bn_fetch(tb.unitvec3_cosine, layer, off, rand, H, W)),
            np.asarray(_jax_bn_fetch(jb.unitvec3_cosine, layer, off, rand, H, W)))
    for p in (1000, 40000):
        np.testing.assert_array_equal(
            _np(tnoise.bn_fetch_pool(tb.unitvec3_cosine, layer, (16, 47), rand, p)),
            np.asarray(_jax_bn_fetch_pool(jb.unitvec3_cosine, layer, (16, 47),
                                          rand, p)))


def test_pcg_scalar():
    v = np.concatenate([np.arange(0, 4096), [2**31 - 1, 123456789]])
    ref = np.asarray(jax.vmap(jpipe._pcg_scalar)(jnp.asarray(v, jnp.int32)))
    got = tpipe._pcg_scalar(torch.as_tensor(v, dtype=torch.int64)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert [tpipe._pcg_scalar(int(x)) for x in v[:50]] == list(ref[:50])


@pytest.mark.parametrize("H, W", [(16, 256), (72, 128), (18, 30)])
def test_ray_tiling(H, W):
    to_tiles, from_tiles = tpipe._tiling(H, W, True)
    img = np.arange(H * W * 3, dtype=np.float32).reshape(H, W, 3)
    flat = to_tiles(torch.as_tensor(img))
    if H % 8 == 0 and W % 128 == 0:
        x = img.reshape(H // 8, 8, W // 128, 128, 3)
        ref = np.moveaxis(x, 2, 0).reshape(-1, 3)  # pipeline.py:261-266
    else:
        ref = img.reshape(-1, 3)
    np.testing.assert_array_equal(flat.numpy(), ref)
    np.testing.assert_array_equal(from_tiles(flat).numpy(), img)


# ---------------------------------------------------------------- shading

@pytest.fixture(scope="module")
def teapot():
    js = build_device_scene(teapot_vox())
    return js, port_scene(js)


def _trace_both(js, o, d, mode):
    r = trace_scene_pallas(js, jnp.asarray(o), jnp.asarray(d), 0.1, 10000.0,
                           mode=mode, interpret=True)
    tr = TraceResult(*(torch.as_tensor(np.array(x)) for x in r))
    return r, tr


def test_resolve_hits_and_entry_face(teapot):
    js, ts = teapot
    o, d = camera_rays(64, 48)
    jr, tr = _trace_both(js, o, d, "precise")
    assert int(np.asarray(jr.hit).sum()) > 300
    jg = jshade.resolve_hits(js, jr, jnp.asarray(o), jnp.asarray(d))
    tg = tshade.resolve_hits(ts, tr, tensor(o), tensor(d))
    for k in ("hit", "inst", "albedo", "palette_idx"):
        np.testing.assert_array_equal(_np(tg[k]), np.asarray(jg[k]), err_msg=k)
    np.testing.assert_array_equal(_np(tg["voxel_id"]),
                                  np.asarray(jg["voxel_id"]).astype(np.int64))
    np.testing.assert_array_equal(_np(tg["depth"]), np.asarray(jg["depth"]))
    for k in ("normal", "world_pos", "motion"):
        _close(tg[k], jg[k], rtol=1e-6, atol=1e-5)

    jr2, tr2 = _trace_both(js, o, d, "rough")
    np.testing.assert_array_equal(
        _np(tshade.entry_face(ts, tr2, tensor(o), tensor(d))),
        np.asarray(jshade.entry_face(js, jr2, jnp.asarray(o), jnp.asarray(d))))


def test_unpack_and_colour():
    rng = np.random.default_rng(2)
    w = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        _np(tunpack(torch.as_tensor(w.view(np.int32)))),
        np.asarray(junpack(jnp.asarray(w), xp=jnp)))
    c = rng.uniform(-0.1, 4.0, size=(4096, 3)).astype(np.float32)
    for tf, jf in ((tcolor.srgb_to_acescg, jcolor.srgb_to_acescg),
                   (tcolor.acescg_to_srgb, jcolor.acescg_to_srgb),
                   (tcolor.xyz_to_acescg, jcolor.xyz_to_acescg)):
        _close(tf(tensor(c)), jf(jnp.asarray(c), xp=jnp), rtol=1e-6, atol=2e-6)
    _close(tcolor.srgb_eotf(tensor(c)), jcolor.srgb_eotf(jnp.asarray(c), xp=jnp),
           rtol=2e-6)


# ---------------------------------------------------------------- dense GI

def test_dense_gi_cache_updates_bit_equal(teapot):
    js, ts = teapot
    assert tgi.dense_rows(ts) == jgi.dense_rows(js)
    jc, tc = jgi.make_dense_gi_cache(js), tgi.make_dense_gi_cache(ts)
    np.testing.assert_array_equal(_np(tc.table), np.asarray(jc.table))
    R = tc.table.shape[0]
    rng = np.random.default_rng(3)
    for step in range(3):
        val = rng.uniform(0.0, 8.0, size=(R, 3)).astype(np.float32)
        ok = rng.uniform(size=R) < 0.8
        jc = jgi.dense_update(jc, jnp.asarray(val), jnp.asarray(ok))
        tc = tgi.dense_update(tc, tensor(val), torch.as_tensor(ok))
        np.testing.assert_array_equal(_np(tc.table), np.asarray(jc.table),
                                      err_msg=f"update {step}")
    start, n = 1000, 2048
    val = rng.uniform(0.0, 8.0, size=(n, 3)).astype(np.float32)
    ok = rng.uniform(size=n) < 0.5
    jc2 = jgi.dense_update_slice(jc, jnp.int32(start), jnp.asarray(val),
                                 jnp.asarray(ok))
    tc2 = tgi.dense_update_slice(tc, start, tensor(val), torch.as_tensor(ok))
    np.testing.assert_array_equal(_np(tc2.table), np.asarray(jc2.table))

    inst = rng.integers(-1, 1, size=4096).astype(np.int32)
    row = rng.integers(-1, 2000, size=4096).astype(np.int32)
    face = rng.integers(0, 6, size=4096).astype(np.int32)
    ji = jgi.dense_index(js, jnp.asarray(inst), jnp.asarray(row),
                         jnp.asarray(face))
    ti = tgi.dense_index(ts, torch.as_tensor(inst), torch.as_tensor(row),
                         torch.as_tensor(face))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    valid = rng.uniform(size=4096) < 0.7
    jget = jgi.dense_get(jc, ji, jnp.asarray(valid))
    tget = tgi.dense_get(tc, ti, torch.as_tensor(valid))
    for a, b in zip(tget[:3], jget[:3]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(tget[3]),
                                  np.asarray(jget[3]).astype(np.int64))


def test_cell_enumeration(teapot):
    js, ts = teapot
    jc, jv = jpipe._cell_enumeration(js)
    tc, tv = tpipe._cell_enumeration(ts)
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    _close(tc, jc, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- post

def _gbuffer(rng, H, W, sky_frac=0.2):
    depth = rng.uniform(5.0, 60.0, size=(H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < sky_frac] = np.inf
    normal = np.zeros((H, W, 3), np.float32)
    normal[..., 1] = 1.0
    normal[: H // 2, :, :] = _unit(rng, (H // 2) * W).reshape(H // 2, W, 3)
    pos = rng.uniform(-30, 30, size=(H, W, 3)).astype(np.float32)
    motion = rng.normal(scale=0.05, size=(H, W, 3)).astype(np.float32)
    rad = rng.gamma(2.0, 0.3, size=(H, W, 3)).astype(np.float32)
    hd = rng.uniform(0.0, 30.0, size=(H, W)).astype(np.float32)
    return rad, hd, depth, normal, pos, motion


def test_downsample_upsample():
    rng = np.random.default_rng(4)
    H, W = 48, 64
    rad, hd, depth, normal, pos, motion = _gbuffer(rng, H, W)
    ref = jden.downsample_inputs(*(jnp.asarray(x) for x in
                                   (rad, hd, depth, normal, pos, motion)))
    got = tden.downsample_inputs(*(tensor(x) for x in
                                   (rad, hd, depth, normal, pos, motion)))
    for a, b in zip(got, ref):
        _close(a, b, rtol=1e-5, atol=1e-5)
    img_h = rng.gamma(2.0, 0.3, size=(H // 2, W // 2, 3)).astype(np.float32)
    hd_h = _np(got[1])
    jo = jden.upsample_bilateral(jnp.asarray(img_h), jnp.asarray(hd_h), ref[2],
                                 ref[3], jnp.asarray(depth), jnp.asarray(normal))
    to = tden.upsample_bilateral(tensor(img_h), tensor(hd_h), got[2], got[3],
                                 tensor(depth), tensor(normal))
    valid = np.isfinite(depth)
    for a, b in zip(to, jo):
        _close(_np(a)[valid], np.asarray(b)[valid], rtol=1e-5, atol=1e-5)


def test_denoise_three_steps():
    rng = np.random.default_rng(5)
    H, W = 32, 48
    settings = DenoiserSettings(atrous_iterations=3)
    vp = jcam.camera_settings(jcam.look_at((5, 40, 70), (0, 0, 0)), 1.0, 0.1,
                              1e4, W, H).view_proj
    js = jden.make_denoiser_state(H, W)
    ts = tden.make_denoiser_state(H, W, "cpu")
    np.testing.assert_array_equal(_np(ts.history),
                                  np.asarray(js.history).view(np.int32))
    for step in range(3):
        rad, hd, depth, normal, pos, motion = _gbuffer(rng, H, W)
        args = (rad, hd, depth, normal, pos, motion)
        jo, jhd, js = jden.denoise(js, *(jnp.asarray(x) for x in args),
                                   vp, settings)
        to, thd, ts = tden.denoise(ts, *(tensor(x) for x in args),
                                   tensor(np.asarray(vp)), settings)
        _close(to, jo, rtol=1e-5, atol=1e-5)
        _close(thd, jhd, rtol=1e-5, atol=1e-5)
        # The packed history: identical words except where a float32 ulp
        # moved a quantisation boundary.
        same = _np(ts.history) == np.asarray(js.history).view(np.int32)
        assert same.mean() > 0.999, (step, same.mean())


def test_exposure_and_tonemap():
    rng = np.random.default_rng(6)
    es = ExposureSettings()
    img = rng.gamma(1.5, 0.5, size=(72, 96, 3)).astype(np.float32)
    img[:10] = 0.001
    jw = jexp.mean_bin(jnp.asarray(img), es)
    tw = texp.mean_bin(tensor(img), es)
    _close(tw, jw, rtol=1e-6, atol=0)
    prev = jnp.asarray(0.7, jnp.float32)
    ja = jexp.adapt_average_luminance(None, prev, img.shape[0] * img.shape[1],
                                      es, weighted=jw)
    ta = texp.adapt_average_luminance(None, torch.tensor(0.7),
                                      img.shape[0] * img.shape[1], es,
                                      weighted=tw)
    _close(ta, ja, rtol=1e-5, atol=1e-5)
    _close(texp.exposure_value(ta), jexp.exposure_value(ja), rtol=1e-5, atol=1e-5)
    alb = rng.uniform(size=(72, 96, 3)).astype(np.float32)
    _close(ttone.tonemap(tensor(img), tensor(alb), ta, "srgb"),
           jtone.tonemap(jnp.asarray(img), jnp.asarray(alb), ja, "srgb"),
           rtol=1e-5, atol=1e-5)
    c = rng.uniform(-0.2, 3.0, size=(4096, 3)).astype(np.float32)
    for tf in ttone.TRANSFER_FUNCTIONS:
        _close(ttone.oetf(tensor(c), tf), jtone.oetf(jnp.asarray(c), tf),
               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [6, 7])
def test_adapt_average_luminance_histogram_path(seed):
    """The histogram path (``weighted`` None): the port's
    ``luminance_histogram`` of a seeded image equals the reference's, and
    the adapted luminance from it equals the reference's bit for bit."""
    rng = np.random.default_rng(seed)
    es = ExposureSettings()
    img = rng.gamma(1.5, 0.5, size=(72, 96, 3)).astype(np.float32)
    img[:10] = 0.001
    jh = jexp.luminance_histogram(jnp.asarray(img), es)
    th = texp.luminance_histogram(tensor(img), es)
    np.testing.assert_array_equal(_np(th), np.asarray(jh))
    n = img.shape[0] * img.shape[1]
    ja = jexp.adapt_average_luminance(jh, jnp.asarray(0.7, jnp.float32), n,
                                      es)
    ta = texp.adapt_average_luminance(th, torch.tensor(0.7), n, es)
    assert ta.dtype == torch.float32
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))


def test_tonemap_color_matrix():
    """A non-identity 3x3 colour matrix between exposure and the ACES
    fit, against the reference's float32 einsum (within the tonemap
    tolerance of this file: XLA's CPU dot contracts some of the three
    products into fused multiply-adds, the port rounds each, so the
    product differs by up to 2 ulps before the fit)."""
    rng = np.random.default_rng(9)
    img = rng.gamma(1.5, 0.5, size=(72, 96, 3)).astype(np.float32)
    alb = rng.uniform(size=(72, 96, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = (q * rng.uniform(0.8, 1.2, size=3)).astype(np.float32)
    exp = np.float32(1.7)
    for transfer in ("srgb", "linear"):
        ref = jtone.tonemap(jnp.asarray(img), jnp.asarray(alb), exp,
                            transfer, color_matrix=m)
        got = ttone.tonemap(tensor(img), tensor(alb), torch.tensor(exp),
                            transfer, color_matrix=m)
        _close(got, ref, rtol=1e-5, atol=1e-5)
        plain = ttone.tonemap(tensor(img), tensor(alb), torch.tensor(exp),
                              transfer)
        assert (got - plain).abs().max() > 0.05
