"""The port's native scene build (``dust_tpu_torch/native``: the per-block
leaf pass, the chebyshev skip field) and the paths that take it (the
``.vox`` loader, the editor's geometry rebuild, the skip field of every
model) against the reference's native library and against the port's
plain numpy versions, on the same inputs. Every result is held exactly:
the three builds do integer work in one defined order.

Also: a missing compiler raises and nothing falls back to numpy; two
processes that build at once on an empty build directory both succeed;
the port never loads the reference's ``libvoxcore.so``. The build itself
(flags, cache, a failed compile, nothing built at import) is
``tests/test_torch_csrc.py``'s.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dust_tpu import native as jnative
from dust_tpu.render import scene as jscene
from dust_tpu.render.edits import SceneEditor as JEditor
from dust_tpu.render.scene import build_device_scene as jbuild
from dust_tpu.vox import procgen as jprocgen
from dust_tpu.vox.geometry import build_geometry_from_flat as jfrom_flat
from dust_tpu.vox.loader import load_vox_scene as jload
from dust_tpu.voxtree.tree import FlatTree as JFlat
from dust_tpu_torch import csrc, native
from dust_tpu_torch.render import scene as tscene
from dust_tpu_torch.render.edits import SceneEditor, geometry_voxels
from dust_tpu_torch.render.scene import build_device_scene
from dust_tpu_torch.vox import loader
from dust_tpu_torch.vox import parser as vp
from dust_tpu_torch.vox import procgen
from dust_tpu_torch.vox.collector import collect_material_indices
from dust_tpu_torch.voxtree.tree import FlatTree, VoxTree

REPO = Path(__file__).resolve().parents[1]
FLAT = ("leaf_origin", "mask_lo", "mask_hi", "active_lo", "active_hi",
        "material_ptr", "leaf_grid")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread here: at these sizes threads buy
    little, and idle OpenMP workers would contend with other test
    processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (
        what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _flat_equal(a, b, what=""):
    for f in FLAT:
        _equal(getattr(a, f), getattr(b, f), f"{what} {f}")


def _geometry_equal(a, b, what=""):
    _flat_equal(a.flat, b.flat, what)
    for f in ("avg_albedo", "materials"):
        _equal(getattr(a, f), getattr(b, f), f"{what} {f}")
    assert (tuple(a.size), a.unit_size) == (tuple(b.size), b.unit_size)


def _voxels(seed, n, extent):
    """``n`` seeded voxels drawn with replacement from the ``extent``^3
    corner (duplicates among them, with their own palette indices), and
    a few repeated at the end with new indices (last write wins)."""
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, extent, size=(n, 3))
    idx = rng.integers(0, 256, size=n).astype(np.uint8)
    k = min(n, 16)
    coords = np.concatenate([coords, coords[:k]])
    again = (idx[:k].astype(np.int64) + 7).astype(np.uint8)
    idx = np.concatenate([idx, again])
    return coords, idx


def _occupancy_plain(coords):
    """Per-block u64 masks of a voxel list, in the collector's order."""
    c = np.asarray(coords, np.int64)
    lin = (c[:, 0] >> 2) + ((c[:, 1] >> 2) << 6) + ((c[:, 2] >> 2) << 12)
    bit = ((c[:, 0] & 3) << 4) | ((c[:, 1] & 3) << 2) | (c[:, 2] & 3)
    occ = np.zeros(64 ** 3, np.uint64)
    np.bitwise_or.at(occ, lin, np.uint64(1) << bit.astype(np.uint64))
    return occ


CASES = [(0, 1, 256), (1, 5000, 256), (2, 200000, 256), (3, 300000, 64),
         (4, 50000, 16), (5, 0, 256)]


@pytest.mark.parametrize("seed,n,extent", CASES)
def test_build_leaves_matches_reference_and_plain(seed, n, extent):
    coords, idx = _voxels(seed, n, extent)
    occ, bp, mats = native.build_leaves(coords, idx)
    assert occ.shape == bp.shape == (64 ** 3,)
    ref = jnative.build_leaves(coords, idx)
    for got, want, what in zip((occ, bp, mats), ref,
                               ("occupancy", "block_ptr", "materials")):
        _equal(got, want, what)
    mats_plain, bp_plain = collect_material_indices(coords, idx)
    _equal(bp, bp_plain, "block_ptr")
    _equal(mats, mats_plain, "materials")
    _equal(occ, _occupancy_plain(coords), "occupancy")
    assert len(mats) == len(np.unique(coords, axis=0))


def test_duplicates_last_write_wins():
    coords = np.array([[5, 5, 5], [9, 0, 3], [5, 5, 5], [5, 5, 5]])
    occ, bp, mats = native.build_leaves(coords, np.array([1, 2, 9, 4],
                                                         np.uint8))
    # Block (1, 1, 1) (linear 1 + 64 + 4096) comes after block (2, 0, 0).
    assert list(mats) == [2, 4]
    assert bp[2] == 0 and bp[1 + 64 + 4096] == 1
    assert occ[2] == 1 << 19 and occ[1 + 64 + 4096] == 1 << 21


@pytest.mark.parametrize("bad", [[256, 0, 0], [0, -1, 0],
                                 [0, 0, 2 ** 32 + 5]])
def test_out_of_range_raises(bad):
    coords = np.array([[1, 2, 3], bad], np.int64)
    idx = np.array([1, 2], np.uint8)
    with pytest.raises(ValueError, match="256\\^3"):
        native.build_leaves(coords, idx)
    if max(bad) < 2 ** 31:
        with pytest.raises(ValueError):
            jnative.build_leaves(coords, idx)


def test_bad_shapes_raise():
    with pytest.raises(ValueError):
        native.build_leaves(np.zeros((4, 2), np.int64),
                            np.zeros(4, np.uint8))
    with pytest.raises(ValueError):
        native.build_leaves(np.zeros((4, 3), np.int64),
                            np.zeros(3, np.uint8))
    with pytest.raises(ValueError):
        native.chebyshev(np.zeros((32, 32, 32), bool))


@pytest.mark.parametrize("seed,n,extent", CASES)
def test_from_dense_pools_matches_reference_and_flatten(seed, n, extent):
    coords, idx = _voxels(seed, n, extent)
    occ, bp, _ = native.build_leaves(coords, idx)
    got = FlatTree.from_dense_pools(occ, bp)
    _flat_equal(got, JFlat.from_dense_pools(*jnative.build_leaves(
        coords, idx)[:2]), "reference")
    tree = VoxTree.from_voxels(coords)
    tree.set_material_ptrs(collect_material_indices(coords, idx)[1])
    _flat_equal(got, tree.flatten(), "flatten")
    # An active mask apart from occupancy.
    rng = np.random.default_rng(seed)
    act = occ & rng.integers(0, 2 ** 63, size=occ.shape, dtype=np.uint64)
    _flat_equal(FlatTree.from_dense_pools(occ, bp, act),
                JFlat.from_dense_pools(occ, bp, act), "active")


@pytest.mark.parametrize("seed,n,extent", CASES[:4])
def test_model_geometry_matches_reference_and_plain(seed, n, extent):
    coords, idx = _voxels(seed, n, extent)
    palette = procgen._palette()
    size = (256, 256, 256)
    got = loader.build_model_geometry(coords, idx, palette, size)
    _geometry_equal(got, loader.build_model_geometry_plain(
        coords, idx, palette, size), "plain")
    occ, bp, mats = jnative.build_leaves(coords, idx)
    _geometry_equal(got, jfrom_flat(JFlat.from_dense_pools(occ, bp), mats,
                                    palette, size), "reference")


def _fields():
    rng = np.random.default_rng(3)
    sparse = np.zeros((64, 64, 64), bool)
    pts = rng.integers(0, 64, size=(40, 3))
    sparse[pts[:, 0], pts[:, 1], pts[:, 2]] = True
    corner = np.zeros((64, 64, 64), bool)
    corner[0, 0, 0] = True
    return {"empty": np.zeros((64, 64, 64), bool), "sparse": sparse,
            "corner": corner, "dense": rng.random((64, 64, 64)) < 0.5,
            "full": np.ones((64, 64, 64), bool)}


FIELDS = _fields()


@pytest.mark.parametrize("max_dist", [63, 15])
@pytest.mark.parametrize("kind", sorted(FIELDS))
def test_chebyshev_matches_reference_and_plain(kind, max_dist):
    occ = FIELDS[kind]
    got = native.chebyshev(occ, max_dist)
    _equal(got, jnative.chebyshev(occ, max_dist), "reference native")
    _equal(got, tscene._chebyshev_plain(occ, max_dist), "plain")
    _equal(tscene.chebyshev_distance_field(occ, max_dist), got, "field")
    _equal(jscene.chebyshev_distance_field(occ, max_dist), got, "ref field")
    want = {"empty": max_dist, "corner": max_dist, "full": 0}.get(kind)
    assert want is None or got.max() == want


def test_distance_field_of_another_shape_raises():
    """The reference's dilation loop serves 64³ only; the port says so."""
    occ = np.zeros((32, 32, 32), bool)
    with pytest.raises(ValueError):
        jscene.chebyshev_distance_field(occ)
    with pytest.raises(ValueError):
        tscene.chebyshev_distance_field(occ)


def _parsed_models(data):
    """(coords, palette indices, size) of each model of a ``.vox`` file,
    in engine orientation, as the loader takes them."""
    f = vp.parse_vox(data)
    out = {}
    for mid, model in enumerate(f.models):
        v = model.voxels.astype(np.int64)
        coords = np.stack([v[:, 0], v[:, 2], model.size[1] - 1 - v[:, 1]], 1)
        out[mid] = (coords, v[:, 3],
                    (model.size[0], model.size[2], model.size[1]))
    return out, f.palette


@pytest.mark.parametrize("kind", ["teapot", "castle"])
def test_load_vox_scene_matches_reference_and_plain(kind):
    data = getattr(procgen, f"{kind}_scene_bytes")()
    got = loader.load_vox_scene(data)
    ref = jload(getattr(jprocgen, f"{kind}_scene_bytes")())
    assert sorted(got.geometries) == sorted(ref.geometries)
    models, palette = _parsed_models(data)
    for mid, geo in got.geometries.items():
        _geometry_equal(geo, ref.geometries[mid], f"{kind} reference")
        coords, idx, size = models[mid]
        _geometry_equal(geo, loader.build_model_geometry_plain(
            coords, idx, palette, size), f"{kind} plain")


def _teapot_editors():
    vox = loader.load_vox_scene(procgen.teapot_scene_bytes())
    jvox = jload(jprocgen.teapot_scene_bytes())
    return (SceneEditor(vox, build_device_scene(vox, "cpu")),
            JEditor(jvox, jbuild(jvox)))


def _slab(y):
    return np.array([(x, y, z) for x in range(8, 40) for z in range(8, 40)])


EDITS = {
    "one voxel in a new leaf and one recoloured": [
        ("set", [(200, 200, 200)], 5), ("first", None, 9)],
    "a slab set, then part of it cleared": [
        ("set", _slab(3), 4), ("clear", _slab(3)[::3], None)],
    "the model emptied": [("clear_all", None, None)],
}


def _by_key(coords, idx):
    """A voxel list sorted by coordinate key (x, y, z): (coords, idx)."""
    coords = np.asarray(coords, np.int64)
    order = np.argsort((coords[:, 0] << 16) | (coords[:, 1] << 8)
                       | coords[:, 2])
    return coords[order], np.asarray(idx)[order]


@pytest.mark.parametrize("name", sorted(EDITS))
def test_rebuild_geometry_matches_reference(name):
    """The editor's splice and rebuild tiers' host build after each edit
    (refit by the port's editor, merged by the reference's), the port's
    against the reference editor's, and the port's against its plain
    build of the same voxels. The two editors hold their voxels in
    different orders: compared as sets, by key."""
    ed, jed = _teapot_editors()
    for op, coords, value in EDITS[name]:
        if op == "first":
            coords = ed.voxels(0)[0][:1]      # the port's first, on both
        elif op == "clear_all":
            coords = ed.voxels(0)[0]
        for e in (ed, jed):
            e.set_voxels(0, np.asarray(coords), value)
        ed.refit()
        jed._merge_pending(0)
        voxels = ed.voxels(0)
        for got, want, what in zip(_by_key(*voxels),
                                   _by_key(jed._coords[0], jed._idx[0]),
                                   ("coords", "palette indices")):
            _equal(got, want, what)
        got = ed._rebuild_geometry(0)
        _geometry_equal(got, jed._rebuild_geometry(0), name)
        geo = ed.vox_scene.geometries[0]
        _geometry_equal(got, loader.build_model_geometry_plain(
            *voxels, ed.vox_scene.palette, geo.size, geo.unit_size),
            f"{name} plain")
    if name == "the model emptied":
        assert got.num_blocks == 0


def test_geometry_voxels_round_trip():
    """The editor's decode of a model's pools rebuilds that model."""
    vox = loader.load_vox_scene(procgen.teapot_scene_bytes())
    geo = vox.geometries[0]
    coords, idx = geometry_voxels(geo)
    _geometry_equal(loader.build_model_geometry(
        coords, idx, vox.palette, geo.size, geo.unit_size), geo, "teapot")


def test_missing_compiler_raises_and_nothing_builds_with_numpy(
        tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(csrc, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)

    def numpy_build(*args, **kwargs):
        raise AssertionError("the loader built with numpy")

    monkeypatch.setattr(VoxTree, "from_voxels", numpy_build)
    monkeypatch.setattr(loader, "collect_material_indices", numpy_build)
    monkeypatch.setattr(loader, "build_model_geometry_plain", numpy_build)
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+ not found"):
        loader.load_vox_scene(procgen.teapot_scene_bytes())
    with pytest.raises(RuntimeError):
        tscene.chebyshev_distance_field(FIELDS["sparse"])
    assert not native.available()
    assert not (tmp_path / "build").exists()


def _python(code, *args, env=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env or {}))
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, out + err
    return out


def _maps_code(tail):
    return ("import importlib, pkgutil\n"
            "import dust_tpu_torch\n"
            "for m in pkgutil.walk_packages(dust_tpu_torch.__path__, "
            "'dust_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from dust_tpu_torch import native\n"
            + tail +
            "maps = open('/proc/self/maps').read()\n"
            "print(sorted({l.split()[-1] for l in maps.splitlines() "
            "if 'libvoxcore' in l}))\n")


def test_the_port_loads_its_own_library_only():
    """After a scene load, the one libvoxcore mapped is the port's build
    under build/dust_tpu_torch/, never dust_tpu/native/libvoxcore.so."""
    code = _maps_code("from dust_tpu_torch.vox import loader, procgen\n"
                      "loader.load_vox_scene(procgen.teapot_scene_bytes())\n")
    libs = eval(_wait(_python(code)).split("\n")[-2])
    assert len(libs) == 1, libs
    assert Path(libs[0]).parent == REPO / "build" / "dust_tpu_torch", libs
    assert Path(libs[0]).name.startswith("libvoxcore_")


def test_two_processes_build_at_once(tmp_path):
    """Two processes build into one empty directory at the same time: both
    load a whole library and agree; one library is left, no temporary."""
    code = ("import sys\nfrom pathlib import Path\nimport numpy as np\n"
            "from dust_tpu_torch import csrc, native\n"
            "csrc._BUILD_DIR = Path(sys.argv[1])\n"
            "c = np.random.default_rng(0).integers(0, 256, size=(1000, 3))\n"
            "occ, bp, mats = native.build_leaves(c, np.arange(1000) % 256)\n"
            "print(int(occ.sum() % 1000003), int(bp.sum()), int(mats.sum()))\n")
    build = tmp_path / "build"
    procs = [_python(code, str(build)) for _ in range(2)]
    outs = [_wait(p) for p in procs]
    assert outs[0] == outs[1]
    assert [p.name.startswith("libvoxcore_") and p.suffix == ".so"
            for p in build.iterdir()] == [True]
