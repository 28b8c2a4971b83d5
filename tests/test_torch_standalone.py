"""The PyTorch port stands alone: no module of ``dust_tpu_torch`` and no
line of ``chip_smoke.py`` imports the JAX package ``dust_tpu``, JAX, or
the reference's ``tools/`` and ``tests/``, and the
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
    """The reference package, JAX, and the reference's tools and tests."""
    return name.split(".")[0] in ("dust_tpu", "jax", "jaxlib", "tools",
                                  "tests")


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
    """The port's loader builds every model with the native library: no
    try, no availability check, and ``load_vox_scene`` reaches no numpy
    build (the plain version stays beside it for the tests and for the
    editor's emptied models)."""
    tree = ast.parse((PORT / "vox" / "loader.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def names(node):
        out = set()
        for n in ast.walk(node):
            assert not isinstance(n, ast.Try)
            if isinstance(n, ast.Name):
                out.add(n.id)
            elif isinstance(n, ast.Attribute):
                out.add(n.attr)
        return out

    assert "available" not in names(tree)
    load = names(fns["load_vox_scene"])
    assert "build_model_geometry" in load
    assert not load & {"build_model_geometry_plain", "from_voxels",
                       "collect_material_indices", "build_geometry"}
    assert {"build_leaves", "from_dense_pools"} <= names(
        fns["build_model_geometry"])


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


# ---- the voxel-tree and colour-space copies --------------------------------

COPIES = ["voxtree/bitmask.py", "voxtree/accessor.py", "voxtree/generic.py",
          "utils/colorspace.py"]


@pytest.mark.parametrize("path", COPIES)
def test_copy_is_the_reference_source(path):
    """Byte for byte the reference's module, its imports pointed at the
    port's modules."""
    import re
    ref = (REPO / "dust_tpu" / path).read_text()
    assert (PORT / path).read_text() == re.sub(r"\bdust_tpu\.",
                                               "dust_tpu_torch.", ref)


def _port_globals():
    from dust_tpu_torch.voxtree import bitmask, generic, pool, tree
    from dust_tpu_torch.voxtree import accessor
    return dict(
        BitMask=bitmask.BitMask, Pool=pool.Pool, VoxTree=tree.VoxTree,
        Accessor=accessor.Accessor,
        lowest_common_ancestor_level=accessor.lowest_common_ancestor_level,
        LEAF_DTYPE=tree.LEAF_DTYPE, leaf_bit_index=tree.leaf_bit_index,
        GenericTree=generic.GenericTree, UnboundedRoot=generic.UnboundedRoot,
        TILE=generic.TILE, tile_of=generic.tile_of,
        local_of=generic.local_of)


def _reference_cases(file_name, skip=()):
    """(id, function, params) of every test of a reference test module
    (loaded from its file, so that no other installed ``tests`` package
    can shadow it); parametrized tests once per case."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"reference_{Path(file_name).stem}", REPO / "tests" / file_name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cases = []

    def add(name, fn, owner):
        marks = getattr(fn, "pytestmark", [])
        params = [m for m in marks if m.name == "parametrize"]
        if params:
            argname, values = params[0].args[:2]
            for v in values:
                cases.append((f"{name}[{v}]", fn, owner, {argname: v}))
        else:
            cases.append((name, fn, owner, {}))

    for name, obj in vars(mod).items():
        if name.startswith("Test") and isinstance(obj, type):
            for m, fn in vars(obj).items():
                if m.startswith("test_") and f"{name}.{m}" not in skip:
                    add(f"{name}.{m}", fn, obj)
        elif name.startswith("test_") and callable(obj):
            add(name, obj, None)
    return [pytest.param(mod, fn, owner, kw, id=i)
            for i, fn, owner, kw in cases]


# The one reference test that renders traces its scene with the JAX
# traversal; the port's copy of that scene is held below instead.
_TREE_CASES = (_reference_cases("test_voxtree.py")
               + _reference_cases("test_generic_tree.py", skip=(
                   "TestUnboundedRoot.test_unbounded_world_renders",)))


@pytest.mark.parametrize("mod,fn,owner,kw", _TREE_CASES)
def test_reference_tree_tests_on_the_port(mod, fn, owner, kw):
    """The reference's tests/test_voxtree.py and tests/test_generic_tree.py,
    their bodies run as they are, with every tree class they name taken
    from the port."""
    import types
    g = dict(vars(mod), **_port_globals())
    body = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)
    if owner is None:
        body(**kw)
    else:
        body(owner(), **kw)


def test_unbounded_root_scene_equal():
    """The reference's two-tile world: the port's to_scene gives the
    reference's models, instances and palette."""
    from dust_tpu.voxtree.generic import UnboundedRoot as Ref
    from dust_tpu_torch.voxtree.generic import UnboundedRoot
    palette = np.zeros((256, 4), np.uint8)
    palette[7] = (255, 40, 40, 255)
    palette[9] = (40, 255, 40, 255)
    scenes = []
    for cls in (Ref, UnboundedRoot):
        r = cls()
        r.set_box((4, 0, 4), (12, 2, 12), 7)
        r.set_box((-200, 0, 30), (-192, 2, 38), 9)
        scenes.append(r.to_scene(palette))
    ref, port = scenes
    assert sorted(ref.geometries) == sorted(port.geometries)
    for mid, g in ref.geometries.items():
        h = port.geometries[mid]
        for f in _FLAT:
            assert np.array_equal(getattr(g.flat, f), getattr(h.flat, f)), f
        assert np.array_equal(g.avg_albedo, h.avg_albedo)
        assert np.array_equal(g.materials, h.materials)
    assert [(i.model_id, i.name) for i in ref.instances] == [
        (i.model_id, i.name) for i in port.instances]
    for a, b in zip(ref.instances, port.instances):
        assert np.array_equal(a.transform, b.transform)
    assert np.array_equal(ref.palette, port.palette)


@pytest.mark.parametrize("name", ["SRGB", "DISPLAY_P3", "BT2020", "DCI_P3",
                                  "ACES_AP1"])
def test_colour_spaces_equal(name):
    from dust_tpu.utils import colorspace as ref
    from dust_tpu_torch.utils import colorspace as port
    a, b = getattr(port, name), getattr(ref, name)
    assert np.array_equal(a.primaries.to_xyz_matrix(),
                          b.primaries.to_xyz_matrix())
    for other in ("SRGB", "BT2020"):
        assert np.array_equal(
            port.conversion_matrix(a, getattr(port, other)),
            ref.conversion_matrix(b, getattr(ref, other)))


# ---- edits on the card ---------------------------------------------------


@pytest.mark.gpu
def test_splice_and_leaf_patch_on_the_card():
    """On a CUDA device: a splice that grows the teapot past its dense-GI
    cell cap, a leaf patch of its last leaf (which has no GI cell) and one
    of an existing voxel, on the card and on the CPU from the same edits:
    every scene tensor and the dense GI table equal."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dust_tpu_torch.config import RenderSettings
    from dust_tpu_torch.render.edits import SceneEditor
    from dust_tpu_torch.render.pipeline import make_frame_state
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    settings = RenderSettings(width=32, height=32, gi_cache="dense")
    runs = []
    for dev in ("cuda", "cpu"):
        vox = load_vox_scene(procgen.teapot_scene_bytes())
        scene = build_device_scene(vox, dev)
        ed = SceneEditor(vox, scene)
        state = make_frame_state(settings, scene, dev)
        have = {tuple(int(v) for v in o)
                for o in vox.geometries[0].flat.leaf_origin}
        grow = scene.gi_cell_cap[0] - vox.geometries[0].num_blocks + 8
        fresh = [(x, y, z) for x in range(0, 256, 4)
                 for y in range(0, 256, 4) for z in range(0, 256, 4)
                 if (x, y, z) not in have][:grow]
        tiers = []
        ed.set_voxels(0, np.array(fresh), 6)                 # new leaves
        scene, state = ed.refit(state)
        tiers.append(ed.last_refit_mode)
        last = vox.geometries[0].flat.leaf_origin[-1]
        occ = int(vox.geometries[0].flat.occupancy_u64()[-1])
        b = (occ & -occ).bit_length() - 1                   # a set bit
        ed.set_voxel(0, tuple(int(v) for v in last + np.array(
            [(b >> 4) & 3, (b >> 2) & 3, b & 3])), 11)
        scene, state = ed.refit(state)
        tiers.append(ed.last_refit_mode)
        ed.set_voxel(0, tuple(int(v) for v in ed.voxels(0)[0][7]), 9)
        scene, state = ed.refit(state)
        tiers.append(ed.last_refit_mode)
        runs.append((tiers, scene, state))
    (t_card, card, st_card), (t_cpu, cpu, st_cpu) = runs
    assert t_card == t_cpu == ["splice", "leaf", "leaf"]
    for f in dataclasses.fields(cpu):
        a, b = getattr(card, f.name), getattr(cpu, f.name)
        if isinstance(b, torch.Tensor):
            assert a.is_cuda and torch.equal(a.cpu(), b), f.name
        else:
            assert a == b, f.name
    assert torch.equal(st_card.gi.table.cpu(), st_cpu.gi.table)
