"""The port's tools (``dust_tpu_torch/tools/``) against the reference's
(``tools/``) on the CPU: ``rmse`` and its CLI, the ``quality_setup``
copy, the blue-noise generators at a small size, ``bench_trace``'s ray
sets, and ``profile_stages`` run small.

Tolerances: ``rmse``/``psnr``, the settings, the blue-noise ranks and the
primary hits (inst, row, bit) exactly; the camera and the ray directions
within 1e-5; the derived ray origins (the primary hit points) within
1e-5 of their distance from the camera (the port's camera directions
differ from the reference's by a few float32 ulps, up to 4.8e-7, and the
hit distance of up to some 450 units scales that: up to 0.0017 units);
``t_max`` equal where both primary traces hit.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dust_tpu_torch.tools import bench_trace, gen_bluenoise, profile_stages
from dust_tpu_torch.tools import quality_setup, rmse

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread here (as tests/test_torch_hash.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_tool(name):
    """The reference's ``tools/<name>.py`` as a module (not a package)."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- rmse

def test_rmse_and_psnr_equal_the_reference():
    ref = _reference_tool("rmse")
    rng = np.random.default_rng(0)
    a = rng.random((17, 23, 3)).astype(np.float32)
    b = a + rng.normal(0.0, 0.01, a.shape).astype(np.float32)
    assert rmse.rmse(a, b) == ref.rmse(a, b)
    assert rmse.psnr(a, b) == ref.psnr(a, b)
    assert rmse.psnr(a, a) == ref.psnr(a, a) == float("inf")
    with pytest.raises(ValueError):
        rmse.rmse(a, b[:, :5])


def test_rmse_cli_equals_the_reference(tmp_path, capsys, monkeypatch):
    from dust_tpu_torch.utils.image import write_png

    rng = np.random.default_rng(1)
    img = rng.random((16, 24, 3)).astype(np.float32)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png(pa, img)
    write_png(pb, np.clip(img + 0.05, 0.0, 1.0))
    assert rmse.main([pa, pb]) == 0
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["rmse.py", pa, pb])
    _reference_tool("rmse").main()
    assert got == capsys.readouterr().out
    assert got.startswith("rmse 0.0")
    assert rmse.main([pa]) == 2


# ---------------------------------------------------------------- quality setup

@pytest.mark.parametrize("kw", [dict(), dict(backend="pallas"),
                                dict(gi_cache="hash")])
def test_quality_setup_matches_the_reference(kw):
    from tests import quality_setup as ref

    got = quality_setup.gt_settings(256, 192, **kw)
    want = ref.gt_settings(256, 192, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cam = quality_setup.gt_camera(got, 256, 192, "cpu")
    rcam = ref.gt_camera(want, 256, 192)
    for name in rcam._fields:
        np.testing.assert_allclose(getattr(cam, name).numpy(),
                                   np.asarray(getattr(rcam, name)),
                                   rtol=1e-6, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------- blue noise

def test_gen_bluenoise_small_equals_the_reference(tmp_path):
    ref = _reference_tool("gen_bluenoise")
    ref.N = 16
    ref.RNG = np.random.default_rng(gen_bluenoise.SEED)
    ref.main(str(tmp_path / "r.npy"))
    want = np.load(tmp_path / "r.npy")
    got = gen_bluenoise.main(None, n=16)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert sorted(got.ravel()) == list(range(256))


def test_gen_stbn_small_equals_the_reference(tmp_path):
    ref = _reference_tool("gen_bluenoise")
    ref.gen_stbn(T=4, N=16, out_path=str(tmp_path / "s.npy"))
    want = np.load(tmp_path / "s.npy")
    got = gen_bluenoise.gen_stbn(T=4, N=16, out_path=tmp_path / "p.npy")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), want)
    for t in range(4):
        assert sorted(got[t].ravel()) == list(range(256))


# ---------------------------------------------------------------- bench_trace

W, H = 128, 64


def _reference_rays():
    """The ray sets of tools/bench_trace.py:50-92 at W x H, from the
    reference's ops; the primary trace in Pallas interpret mode."""
    from dust_tpu.config import RenderSettings
    from dust_tpu.ops import camera as cameralib
    from dust_tpu.ops import packing as pk
    from dust_tpu.ops import shade
    from dust_tpu.ops.noise import load_blue_noise
    from dust_tpu.ops.pallas_trace import trace_scene_pallas
    from dust_tpu.render.scene import build_device_scene
    from dust_tpu.vox import procgen
    from dust_tpu.vox.loader import load_vox_scene

    n = W * H
    vs = load_vox_scene(procgen.castle_scene_bytes())
    procgen.add_teapot(vs)
    scene = build_device_scene(vs)
    settings = RenderSettings(width=W, height=H)
    cs = cameralib.camera_settings(
        cameralib.look_at(bench_trace.EYE, bench_trace.TARGET),
        settings.camera.fov, 0.1, 1e5, W, H)
    x = cameralib.camera_ray_dirs(cs, W, H).reshape(H // 8, 8, W // 128, 128,
                                                    3)
    dirs = jnp.moveaxis(x, 2, 0).reshape(n, 3)
    origins = jnp.broadcast_to(cs.position, (n, 3))
    primary = trace_scene_pallas(scene, origins, dirs, 0.1, 1e5,
                                 interpret=True)
    g = shade.resolve_hits(scene, primary, origins, dirs)
    hit, normal = g["hit"], g["normal"]
    hit_loc = g["world_pos"] + normal * 0.01
    page = load_blue_noise().unitvec3_cosine[0]
    noise = jnp.tile(page, (-(-H // 128), -(-W // 128), 1))[:H, :W]
    x = noise.reshape(H // 8, 8, W // 128, 128, 3)
    cos = jnp.moveaxis(x, 2, 0).reshape(n, 3) * 2.0 - 1.0
    gi_dir = pk.rotate_vector_by_normal(normal, cos)
    gi_dir = jnp.where(hit[:, None], gi_dir, jnp.asarray([0.0, 1.0, 0.0]))
    sun = jnp.broadcast_to(jnp.asarray(settings.sunlight.direction), (n, 3))
    rays = {
        "primary": (origins, dirs, 0.1, jnp.full(n, 1e5), "precise"),
        "shadow": (hit_loc, sun, 0.1, jnp.where(hit, 1e4, -1.0), "precise"),
        "ao": (hit_loc, gi_dir, 0.1, jnp.where(hit, 8.0, -1.0),
               "ao_threshold"),
        "fg": (hit_loc, gi_dir, 8.0, jnp.where(hit, 1e5, -1.0), "rough"),
        "aofg": (hit_loc, sun, 0.1, jnp.where(hit, 1e4, -1.0), "ao_fg"),
    }
    return rays, primary


def test_bench_trace_rays_match_the_reference():
    ref_rays, ref_primary = _reference_rays()
    scene = bench_trace.build_scene("cpu")
    rays, primary = bench_trace.build_rays(scene, W, H, "cpu")
    for k in ("inst", "row", "bit"):
        np.testing.assert_array_equal(getattr(primary, k).numpy(),
                                      np.asarray(getattr(ref_primary, k)), k)
    hit = primary.hit.numpy()
    assert 200 < hit.sum() < hit.size
    assert set(rays) == set(bench_trace.PASSES) == set(ref_rays)
    for name, (o, d, t_min, t_max, mode) in rays.items():
        ro, rd, rt_min, rt_max, rmode = ref_rays[name]
        assert (mode, float(t_min)) == (rmode, float(rt_min)), name
        reach = np.maximum(np.where(hit, primary.t.numpy(), 0.0), 1.0)
        err = np.abs(o.numpy() - np.asarray(ro)).max(axis=-1)
        assert (err <= 1e-5 * reach).all(), (name, (err / reach).max())
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=0,
                                   atol=1e-5, err_msg=name)
        want = np.asarray(rt_max)
        live = hit if name != "primary" else np.ones_like(hit)
        np.testing.assert_array_equal(t_max.numpy()[live], want[live])
        np.testing.assert_array_equal(t_max.numpy() < 0, want < 0)


def test_bench_trace_cli_runs_small(capsys):
    assert bench_trace.main(["--device", "cpu", "--width", "128", "--height",
                             "8", "--reps", "1", "--passes", "ao,aofg"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# 128x8, 1 launches per timing, device cpu")
    assert [line.split(":")[0].strip() for line in out[1:]] == ["ao", "aofg"]
    for line in out[1:]:
        assert "Mrays/s" in line and "hit-rate" in line and "checksum" in line


# ---------------------------------------------------------------- profile_stages

# tools/profile_stages.py's stage names, in its order (the pool's three
# carry the pool size).
STAGE_NAMES = [
    "primary trace (precise)", "resolve_hits", "shadow trace (precise)",
    "AO trace (ao_threshold)", "FG trace (rough)", "leaf_attributes (2M)",
    "hash_get (2M)", "pool_enqueue_mod (2M->pool)",
    "surfel trace (rough, {p})", "hash_get ({p})", "hash_insert ({p})",
    "denoise", "exposure histogram", "tonemap", "FULL FRAME"]


def test_profile_stages_runs_small(capsys):
    pool = 512
    assert profile_stages.main(["--device", "cpu", "--width", "128",
                                "--height", "8", "--pool", str(pool),
                                "--cap", "4096", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# 128x8, pool 512, 4096 hash slots")
    names = [line[:34].strip() for line in lines[1:]]
    assert names == [s.format(p=pool) for s in STAGE_NAMES]
    for line in lines[1:]:
        assert line[34:].split()[1:4] == ["ms", "device", "-"], line


def test_profile_stages_groups(capsys):
    times = profile_stages.profile(128, 8, 256, 4096, 1, "cpu",
                                   stages=["post"], log=lambda s: None)
    assert list(times) == ["denoise", "exposure histogram", "tonemap"]
    assert all(ms > 0 and dev is None for ms, dev in times.values())
