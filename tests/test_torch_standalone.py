"""The PyTorch port stands alone: no module of ``dust_tpu_torch`` and no
line of ``chip_smoke.py`` imports the JAX package ``dust_tpu``, and the
port's copies of its host code (config, ``.vox`` procgen and loader,
voxel tree, assets, PNG IO) give what the reference gives. The tests
import both packages; the port imports only itself."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dust_tpu_torch"
SOURCES = sorted(p.relative_to(REPO).as_posix()
                 for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


def _is_reference(name):
    return name == "dust_tpu" or name.startswith("dust_tpu.")


def test_importing_the_port_loads_nothing_of_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dust_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "dust_tpu_torch.__path__, 'dust_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'dust_tpu' or "
        "m.startswith('dust_tpu.') or m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton'))\n"
        "assert not bad, bad\n"
        "assert 'dust_tpu_torch.voxtree.tree' in sys.modules\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 30


def test_chip_smoke_setup_loads_nothing_of_the_reference():
    """chip_smoke's scene set-up, on the CPU, up to the first device call."""
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "ctx = chip_smoke._setup(torch.device('cpu'), 64, 32)\n"
        "assert ctx['scene'].num_instances == 2\n"
        "bad = sorted(m for m in sys.modules if m == 'dust_tpu' or "
        "m.startswith('dust_tpu.') or m.split('.')[0] in ('jax', 'jaxlib'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", SOURCES)
def test_no_source_imports_the_reference(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _is_reference(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _is_reference(node.module or ""):
                found.append(node.module)
    assert not found, f"{path} imports {found}"


def test_loader_has_one_build_path():
    """The port's loader builds leaves with numpy only: no try, no native
    module, no availability check."""
    tree = ast.parse((PORT / "vox" / "loader.py").read_text())
    names = set()
    for node in ast.walk(tree):
        assert not isinstance(node, ast.Try)
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.ImportFrom):
            names.update(a.name for a in node.names)
    assert not names & {"native", "available", "build_leaves"}
    assert {"from_voxels", "collect_material_indices"} <= names


@pytest.mark.parametrize("name", ["teapot_scene_bytes", "castle_scene_bytes"])
def test_procgen_bytes_equal(name):
    from dust_tpu.vox import procgen as ref
    from dust_tpu_torch.vox import procgen as port
    assert getattr(port, name)() == getattr(ref, name)()


_SCENES = {}


def _scenes(kind):
    """(reference VoxScene, port VoxScene) of the teapot or the castle."""
    if kind not in _SCENES:
        from dust_tpu.vox import procgen as ref_procgen
        from dust_tpu.vox.loader import load_vox_scene as ref_load
        from dust_tpu_torch.vox import procgen
        from dust_tpu_torch.vox.loader import load_vox_scene
        name = f"{kind}_scene_bytes"
        _SCENES[kind] = (ref_load(getattr(ref_procgen, name)()),
                         load_vox_scene(getattr(procgen, name)()))
    return _SCENES[kind]


_FLAT = ["leaf_origin", "mask_lo", "mask_hi", "active_lo", "active_hi",
         "material_ptr", "leaf_grid"]


@pytest.mark.parametrize("field", _FLAT + ["avg_albedo", "materials", "size",
                                           "unit_size"])
@pytest.mark.parametrize("kind", ["teapot", "castle"])
def test_loader_geometry_equal(kind, field):
    ref, port = _scenes(kind)
    assert sorted(port.geometries) == sorted(ref.geometries)
    for mid, g in ref.geometries.items():
        h = port.geometries[mid]
        a = getattr(g.flat, field) if field in _FLAT else getattr(g, field)
        b = getattr(h.flat, field) if field in _FLAT else getattr(h, field)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b), (kind, mid, field)
        else:
            assert a == b, (kind, mid, field)


@pytest.mark.parametrize("kind", ["teapot", "castle"])
def test_loader_instances_and_palette_equal(kind):
    ref, port = _scenes(kind)
    assert np.array_equal(port.palette, ref.palette)
    assert len(port.instances) == len(ref.instances)
    for a, b in zip(ref.instances, port.instances):
        assert (a.model_id, a.name) == (b.model_id, b.name)
        assert a.transform.dtype == b.transform.dtype
        assert np.array_equal(a.transform, b.transform)


def test_stress_scene_equal():
    from dust_tpu.vox import procgen as ref
    from dust_tpu_torch.vox import procgen as port
    (rv, ra), (pv, pa) = ref.stress_scene(), port.stress_scene()
    assert ra == pa
    assert [(i.model_id, i.name) for i in rv.instances] == [
        (i.model_id, i.name) for i in pv.instances]
    for a, b in zip(rv.instances, pv.instances):
        assert np.array_equal(a.transform, b.transform)
    for mid, g in rv.geometries.items():
        assert np.array_equal(g.avg_albedo, pv.geometries[mid].avg_albedo)
        assert np.array_equal(g.flat.leaf_origin,
                              pv.geometries[mid].flat.leaf_origin)


def test_render_settings_equal():
    from dust_tpu.config import RenderSettings as Ref
    from dust_tpu_torch.config import RenderSettings
    assert dataclasses.asdict(RenderSettings()) == dataclasses.asdict(Ref())
    kw = dict(width=96, height=54, gi_cache="dense",
              traversal_backend="pallas")
    assert dataclasses.asdict(RenderSettings(**kw)) == dataclasses.asdict(
        Ref(**kw))


@pytest.mark.parametrize("name", ["SRGB_TO_ACESCG", "ACESCG_TO_SRGB",
                                  "XYZ_TO_ACESCG", "ACESCG_TO_XYZ"])
def test_colour_constants_equal(name):
    from dust_tpu.utils import color as ref
    from dust_tpu_torch.utils import color as port
    a, b = getattr(port, name), getattr(ref, name)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["bluenoise128.npy", "hosek_sky.npz",
                                  "stbn128x64.npy"])
def test_assets_byte_equal(name):
    port = PORT / "assets" / name
    assert port.read_bytes() == (REPO / "dust_tpu" / "assets" / name).read_bytes()


def test_assets_are_package_data():
    text = (REPO / "pyproject.toml").read_text()
    assert '"dust_tpu_torch.assets" = ["*.npz", "*.npy"]' in text


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_png_round_trip(tmp_path, channels):
    from dust_tpu.utils.image import write_png as ref_write
    from dust_tpu_torch.utils.image import read_png, write_png
    rng = np.random.default_rng(3)
    shape = (17, 23) if channels is None else (17, 23, channels)
    img = rng.integers(0, 256, size=shape).astype(np.uint8)
    write_png(str(tmp_path / "p.png"), img)
    ref_write(str(tmp_path / "r.png"), img)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "r.png").read_bytes()
    back = read_png(str(tmp_path / "p.png"))
    want = img[:, :, None].repeat(3, axis=2) if channels is None else img
    assert np.array_equal(back, want)
    # Floats are quantised to 8 bits.
    f = rng.random((5, 7, 3)).astype(np.float32)
    write_png(str(tmp_path / "f.png"), f)
    assert np.array_equal(read_png(str(tmp_path / "f.png")),
                          (f * 255.0 + 0.5).astype(np.uint8))
