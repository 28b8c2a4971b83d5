"""The PyTorch port as a package: imports without jax, triton or nvcc;
its entry points refuse to run without a CUDA device unless the CPU is
asked for; the kernel wrapper checks what it is given. The one test that
needs the card (kernel against plain version) is marked ``gpu``."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, timeout=600, **env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_imports_without_jax_triton_or_a_build():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dust_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "dust_tpu_torch.__path__, 'dust_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton'))\n"
        "from dust_tpu_torch.ops import hdda\n"
        "print(len(names), bad, hdda.LIBRARY.handle)\n"
        "assert not bad, bad\n"
        "assert hdda.LIBRARY.handle is None\n"
        "assert len(names) >= 20, names\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr


def _need_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_cli_fails_without_a_card_by_default(tmp_path):
    _need_no_card()
    r = _run(["-m", "dust_tpu_torch.app.castle", "--width", "128",
              "--height", "72", "--frames", "1", "--out",
              str(tmp_path / "c.png")])
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "c.png").exists()


def test_cli_renders_on_cpu_when_asked(tmp_path):
    out = tmp_path / "c.png"
    r = _run(["-m", "dust_tpu_torch.app.castle", "--width", "128",
              "--height", "72", "--frames", "2", "--teapot", "--device",
              "cpu", "--backend", "pallas", "--out", str(out)],
             OMP_NUM_THREADS="1")
    assert r.returncode == 0, r.stderr
    from dust_tpu_torch.utils.image import read_png
    img = read_png(str(out))
    assert img.shape[:2] == (72, 128)
    assert 0.02 < float(np.asarray(img, np.float64).mean()) < 0.98 * 255


def test_chip_smoke_fails_without_a_card():
    _need_no_card()
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _tiny_args(**over):
    n = 4
    args = dict(
        l1=torch.zeros((1, 512), dtype=torch.int32),
        l2=torch.zeros((1, 4096, 4), dtype=torch.int32),
        mask=torch.zeros((1, 1024, 2), dtype=torch.int32),
        inst_model=torch.zeros(1, dtype=torch.int32),
        inst_ids=torch.zeros(1, dtype=torch.int32),
        aff=torch.tensor([[1.0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]]),
        aabb=torch.tensor([[0.0, 0, 0, 256, 256, 256]]),
        origin=torch.zeros((n, 3)), direction=torch.ones((n, 3)),
        t_min=torch.zeros(n), t_max=torch.full((n,), 10.0))
    args.update(over)
    return args


@pytest.mark.parametrize("bad, error", [
    (dict(origin=torch.zeros((4, 3), dtype=torch.float64)), TypeError),
    (dict(t_max=torch.zeros(5)), ValueError),
    (dict(direction=torch.ones((3, 4)).t()), ValueError),
    (dict(l2=torch.zeros((1, 4096, 3), dtype=torch.int32)), ValueError),
])
def test_kernel_wrapper_checks_its_inputs(bad, error):
    from dust_tpu_torch.ops import hdda
    with pytest.raises(error):
        hdda.hdda(**_tiny_args(**bad), mode="precise")


def test_kernel_wrapper_modes():
    from dust_tpu_torch.ops import hdda
    with pytest.raises(ValueError):
        hdda.hdda(**_tiny_args(), mode="fast")
    with pytest.raises(ValueError):
        hdda.hdda(**_tiny_args(), mode="ao_fg")          # needs t_ao
    t, inst, row, bit = hdda.hdda(**_tiny_args(), mode="rough")
    assert bool(torch.isinf(t).all()) and bool((inst == -1).all())
    assert hdda.LAUNCHES == {m: 0 for m in hdda.MODES}  # CPU: plain version


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    """On a CUDA device: the CUDA kernel against its plain version on the
    teapot's camera and secondary rays, every mode, hit-exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # No import from the tests directory: on a machine where another
    # package installs a top-level ``tests``, that package shadows it.
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene
    from dust_tpu_torch.ops import camera as cam
    from dust_tpu_torch.ops import hdda
    from dust_tpu_torch.render.scene import build_device_scene

    dev = torch.device("cuda")
    scene = build_device_scene(
        load_vox_scene(procgen.teapot_scene_bytes()), dev)
    cs = cam.camera_settings(cam.look_at((26.0, 14.0, 32.0), (4.0, -4.0, 0.0)),
                             1.1, 0.1, 1e4, 256, 128, dev)
    d = cam.camera_ray_dirs(cs, 256, 128).reshape(-1, 3)
    o = cs.position.expand(d.shape[0], 3).contiguous()
    rng = np.random.default_rng(0)
    d2 = torch.as_tensor(rng.normal(size=tuple(d.shape)).astype(np.float32),
                         device=dev)
    rays = [(o, d), (o + d * 30.0, d2)]
    for mode in hdda.MODES:
        for ot, dt in rays:
            n = ot.shape[0]
            args = hdda._scene_args(scene)
            tab = (scene.hdda_l1, scene.hdda_l2, scene.hdda_mask) + args
            tn = torch.full((n,), 0.1, device=dev)
            tx = torch.full((n,), 1000.0, device=dev)
            ta = torch.full((n,), 8.0, device=dev) if mode == "ao_fg" else None
            k = hdda.hdda(*tab, ot, dt, tn, tx, t_ao=ta, mode=mode)
            p = hdda.hdda_plain(*tab, ot, dt, tn, tx, ta, mode)
            torch.cuda.synchronize()
            for a, b in zip(k, p):
                assert torch.equal(a, b), mode


@pytest.mark.gpu
def test_instance_kernel_matches_plain_on_the_card():
    """On a CUDA device: the single-instance kernel against its plain
    version on the teapot's camera and secondary rays in object space,
    every mode, hit-exact, and on the range test's edge launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene
    from dust_tpu_torch.ops import camera as cam
    from dust_tpu_torch.ops import hdda
    from dust_tpu_torch.ops.traverse import dir_length, xform_dir, xform_point
    from dust_tpu_torch.render.scene import build_device_scene

    dev = torch.device("cuda")
    scene = build_device_scene(
        load_vox_scene(procgen.teapot_scene_bytes()), dev)
    cs = cam.camera_settings(cam.look_at((26.0, 14.0, 32.0), (4.0, -4.0, 0.0)),
                             1.1, 0.1, 1e4, 256, 128, dev)
    d = cam.camera_ray_dirs(cs, 256, 128).reshape(-1, 3)
    o = cs.position.expand(d.shape[0], 3).contiguous()
    rng = np.random.default_rng(0)
    d2 = torch.as_tensor(rng.normal(size=tuple(d.shape)).astype(np.float32),
                         device=dev)
    w2o = scene.world_to_obj[0]
    tab = (scene.hdda_l1[0], scene.hdda_l2[0], scene.hdda_mask[0])
    for mode in hdda.MODES:
        for ot, dt in [(o, d), (o + d * 30.0, d2)]:
            n = ot.shape[0]
            do = xform_dir(w2o, dt)
            dn = (do / dir_length(do)[:, None]).contiguous()
            rays = (xform_point(w2o, ot).contiguous(), dn,
                    torch.full((n,), 0.1, device=dev),
                    torch.full((n,), 1000.0, device=dev),
                    torch.full((n,), 8.0, device=dev) if mode == "ao_fg"
                    else None)
            k = hdda.hdda_instance(*tab, *rays, mode=mode)
            p = hdda.hdda_instance_plain(*tab, *rays, mode)
            torch.cuda.synchronize()
            for a, b in zip(k, p):
                assert torch.equal(a, b), mode
        # Edge launches of the range test on the camera rays: no ray
        # active; every ray active; one active lane per warp; NaN origins
        # on the inactive lanes (which the kernel never reads); a count
        # that is a multiple of no block size.
        n = o.shape[0]
        do = xform_dir(w2o, d)
        o_obj = xform_point(w2o, o).contiguous()
        dn = (do / dir_length(do)[:, None]).contiguous()
        s_min = torch.full((n,), 0.1, device=dev)
        far = torch.full((n,), 1000.0, device=dev)
        lane = torch.arange(n, device=dev)
        nan_o = torch.full_like(o_obj, float("nan"))
        odd = lane % 2 == 1
        edges = {
            "none active": (nan_o, dn, s_min, s_min.clone()),
            "all active": (o_obj, dn, s_min, far),
            "one per warp": (o_obj, dn, s_min,
                             torch.where(lane % 32 == 5, far, s_min - 1.0)),
            "NaN inactive": (torch.where(odd[:, None], nan_o, o_obj), dn,
                             s_min, torch.where(odd, s_min, far)),
            "ragged": (o_obj[:10007].contiguous(), dn[:10007].contiguous(),
                       s_min[:10007].contiguous(), far[:10007].contiguous()),
        }
        for what, (eo, ed, lo, hi) in edges.items():
            s_ao = (torch.full_like(lo, 8.0) if mode == "ao_fg" else None)
            k = hdda.hdda_instance(*tab, eo, ed, lo, hi, s_ao, mode=mode)
            p = hdda.hdda_instance_plain(*tab, eo, ed, lo, hi, s_ao, mode)
            torch.cuda.synchronize()
            for a, b in zip(k, p):
                assert torch.equal(a, b), (mode, what)
            if what == "none active":
                assert bool(torch.isinf(k[0]).all()), mode


@pytest.mark.gpu
def test_scene_kernel_long_and_short_walks_on_the_card():
    """On a CUDA device: the scene kernel against its plain version, every
    mode, hit-exact, on rays where a few walks are long and most end at
    once, so that the lanes of a warp diverge as in the stress frame's
    sun-shadow launch: most rays are inactive or leave the scene at once;
    one in ten crosses the five-teapot scene at random; a few run parallel
    to an axis on a block boundary plane of the first teapot (the walks
    that creep by the step nudge until the iteration caps end them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dust_tpu_torch.ops import hdda
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import VoxInstance, load_vox_scene

    vox = load_vox_scene(procgen.teapot_scene_bytes())
    base = vox.instances[0]
    for k in range(1, 5):
        t = base.transform.copy()
        t[:3, 3] += np.asarray([120.0 * k, 10.0 * k, 15.0 * k], np.float32)
        vox.instances.append(VoxInstance(base.model_id, t, name=f"tp{k}"))
    dev = torch.device("cuda")
    scene = build_device_scene(vox, dev)

    n = 32768
    rng = np.random.default_rng(7)
    o = np.zeros((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    t_max = np.full(n, -1.0, np.float32)            # inactive
    away = np.arange(n) % 2 == 1                     # leave the scene upward
    o[away] = rng.uniform(-50, 600, (int(away.sum()), 3)) + [0, 500, 0]
    d[away] = [0.0, 1.0, 0.0]
    t_max[away] = 1000.0
    cross = rng.permutation(n)[: n // 10]            # random walks
    centers = np.stack([v.transform[:3, 3] for v in vox.instances]) + 32.0
    aim = centers[rng.integers(0, 5, len(cross))] + rng.normal(0, 20, (len(cross), 3))
    o[cross] = aim + rng.normal(0, 1, (len(cross), 3)) * 150.0
    d[cross] = aim - o[cross]
    t_max[cross] = 1000.0
    creep = rng.permutation(np.setdiff1d(np.arange(n), cross))[:6]
    x0 = np.float32(base.transform[0, 3]) + np.float32(16.0 + 4.0 * 2)
    o[creep] = np.stack([np.full(6, x0), base.transform[1, 3] + np.linspace(-5, 5, 6),
                         base.transform[2, 3] + 60.0 + np.linspace(0, 8, 6)], 1)
    d[creep] = [0.0, 0.8, -0.6]
    t_max[creep] = 1000.0
    tensor = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    ot, dt, tx = tensor(o), tensor(d), tensor(t_max)
    tn = torch.full((n,), 0.1, device=dev)
    ta = torch.full((n,), 8.0, device=dev)
    tab = (scene.hdda_l1, scene.hdda_l2, scene.hdda_mask) + hdda._scene_args(scene, ot)
    for mode in hdda.MODES:
        t_ao = ta if mode == "ao_fg" else None
        k = hdda.hdda(*tab, ot, dt, tn, tx, t_ao=t_ao, mode=mode)
        p = hdda.hdda_plain(*tab, ot, dt, tn, tx, t_ao, mode)
        torch.cuda.synchronize()
        assert int(torch.isfinite(k[0]).sum()) > 100, mode
        for a, b in zip(k, p):
            assert torch.equal(a, b), mode
