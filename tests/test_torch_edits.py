"""The port's scene editor against the reference's, on the same edits.

Every edit sequence of tests/test_edits.py (and a few that reach the last
rows of the tables, and a seeded stream of sets, clears and duplicate
writes) goes through the reference's ``SceneEditor`` and the
port's, each built from its own package's load of the same ``.vox`` bytes:
the teapot, and five instances of it (the GI rows of one leaf shared by
five instances). After every refit:

* the same ``last_refit_mode``;
* every field of the port's ``DeviceScene`` equal to the reference's
  scene carried into the port (``port_scene``), bit for bit;
* the dense GI table, or the hash frame's working set, equal to the
  reference's, word for word;
* once per tier (leaf, splice, rebuild): the traced ``(inst, row, bit)``
  of the teapot's camera and secondary rays exact, the port's plain HDDA
  against the reference's Pallas kernel in interpret mode (t within
  1e-6 relative).

Then the staged refit (async equals sync, the worker builds the grid as
it stood at staging, edits made in flight stay pending, a failing
rebuild re-raises in ``poll_refit``) and three frames
rendered while edits land, held to the frame tests' tolerance (output
RMSE < 0.01).
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dust_tpu.config import RenderSettings as JSettings
from dust_tpu.config import SpatialHashSettings as JHash
from dust_tpu.ops import camera as jcam
from dust_tpu.ops import gi_cache as jgi
from dust_tpu.ops import pallas_trace as pt
from dust_tpu.ops.noise import load_blue_noise as jnoise
from dust_tpu.ops.sky import bake_sky as jsky
from dust_tpu.render import pipeline as jpipe
from dust_tpu.render.edits import SceneEditor as JEditor
from dust_tpu.render.scene import build_device_scene as jbuild
from dust_tpu.vox import procgen as jprocgen
from dust_tpu.vox.loader import VoxInstance as JInstance
from dust_tpu.vox.loader import load_vox_scene as jload
from dust_tpu_torch.config import RenderSettings, SpatialHashSettings
from dust_tpu_torch.ops import camera as tcam
from dust_tpu_torch.ops import gi_cache as tgi
from dust_tpu_torch.ops import hdda
from dust_tpu_torch.ops.noise import load_blue_noise as tnoise
from dust_tpu_torch.ops.sky import bake_sky as tsky
from dust_tpu_torch.render import pipeline as tpipe
from dust_tpu_torch.render.edits import SceneEditor
from dust_tpu_torch.render.scene import build_device_scene
from dust_tpu_torch.vox import procgen
from dust_tpu_torch.vox.loader import (VoxInstance, build_model_geometry,
                                       load_vox_scene)
from tests.torch_parity import (TEAPOT_EYE, TEAPOT_TARGET, port_scene,
                                teapot_ray_sets, tensor)
from tools.rmse import rmse


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread here: at these sizes threads buy
    little, and idle OpenMP workers would contend with other test
    processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _vox(kind, port):
    """The teapot, or five instances of it spread along x (the scene of
    tests/torch_parity.five_teapots_vox), loaded by the port or by the
    reference."""
    scene = (load_vox_scene(procgen.teapot_scene_bytes()) if port
             else jload(jprocgen.teapot_scene_bytes()))
    if kind == "five_teapots":
        inst = scene.instances[0]
        make = VoxInstance if port else JInstance
        for k in range(1, 5):
            t = inst.transform.copy()
            t[:3, 3] += np.asarray([120.0 * k, 10.0 * k, 15.0 * k], np.float32)
            scene.instances.append(make(inst.model_id, t, name=f"tp{k}"))
    return scene


def _settings(gi):
    kw = dict(width=32, height=32, gi_cache="dense" if gi == "dense"
              else "hash")
    if gi == "hash_ws":
        return (JSettings(spatial_hash=JHash(capacity=1 << 12,
                                             ws_refresh_slices=2), **kw),
                RenderSettings(spatial_hash=SpatialHashSettings(
                    capacity=1 << 12, ws_refresh_slices=2), **kw))
    return JSettings(**kw), RenderSettings(**kw)


def _assert_scene_equal(ts, js):
    want = port_scene(js)
    for f in dataclasses.fields(ts):
        a, b = getattr(ts, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a, b), f"field {f.name} differs"
        else:
            assert tuple(a) == tuple(b), f.name


def _table(cache):
    return np.asarray(cache.table).view(np.int32)


class Pair:
    """The reference's editor and the port's on the same scene, with a
    FrameState each when ``gi`` is "dense" or "hash_ws" (the port's GI
    tables start as the reference's, carried across)."""

    def __init__(self, kind="teapot", gi=None):
        self.jv, self.tv = _vox(kind, False), _vox(kind, True)
        self.je = JEditor(self.jv, jbuild(self.jv))
        self.te = SceneEditor(self.tv, build_device_scene(self.tv, "cpu"))
        _assert_scene_equal(self.te.device, self.je.device)
        self.jst = self.tst = None
        if gi is not None:
            js, ts = _settings(gi)
            self.jst = jpipe.make_frame_state(js, self.je.device)
            if gi == "dense":
                # One radiance sample in every row, so that refits show
                # whether they keep it.
                ones = jnp.ones((self.jst.gi.table.shape[0], 3))
                self.jst = self.jst._replace(gi=jgi.dense_update(
                    self.jst.gi, ones, jnp.ones(ones.shape[0], bool)))
            tst = tpipe.make_frame_state(ts, self.te.device, "cpu")
            if gi == "dense":
                tst = dataclasses.replace(tst, gi=tgi.DenseGICache(
                    table=tensor(_table(self.jst.gi), torch.int32)))
            self.tst = tst
            self._check_state()

    def edit(self, coords, palette_idx, model=0):
        coords = np.asarray(coords, np.int64).reshape(-1, 3)
        self.je.set_voxels(model, coords, palette_idx)
        self.te.set_voxels(model, coords, palette_idx)

    def refit(self):
        if self.jst is None:
            self.je.refit()
            self.te.refit()
        else:
            _, self.jst = self.je.refit(self.jst)
            _, self.tst = self.te.refit(self.tst)
        assert self.te.last_refit_mode == self.je.last_refit_mode
        _assert_scene_equal(self.te.device, self.je.device)
        if self.jst is not None:
            self._check_state()
        return self.te.last_refit_mode

    def _check_state(self):
        if isinstance(self.jst.gi, jgi.DenseGICache):
            np.testing.assert_array_equal(self.tst.gi.table.numpy(),
                                          _table(self.jst.gi))
        if self.jst.gi_ws is not None:
            np.testing.assert_array_equal(self.tst.gi_ws.table.numpy(),
                                          _table(self.jst.gi_ws))


# ---- edit sequences: (pair) -> the tiers the refits took -----------------

def _pillar(vox):
    size = vox.geometries[0].size
    cx, cz = size[0] // 2, size[2] // 2
    return np.array([[cx, y, cz] for y in range(size[1])])


def _slab(vox):
    """tests/test_edits.py's slab: far more leaves than the padding."""
    size = vox.geometries[0].size
    xs, ys, zs = np.meshgrid(np.arange(0, size[0], 2), np.arange(4),
                             np.arange(0, size[2], 2), indexing="ij")
    return np.stack([xs.ravel(), ys.ravel(), zs.ravel()], 1)


def _occupied_leaf(vox, row=None):
    """(origin, occupied voxels) of a leaf with >= 2 voxels (the first
    one, or leaf ``row``)."""
    flat = vox.geometries[0].flat
    occ = flat.occupancy_u64()
    if row is None:
        counts = np.unpackbits(occ.view(np.uint8).reshape(-1, 8),
                               axis=1).sum(axis=1)
        row = int(np.argmax(counts >= 2))
    origin = flat.leaf_origin[row]
    bits = [b for b in range(64) if (int(occ[row]) >> b) & 1]
    vx = [tuple(int(v) for v in origin + np.array(
        [(b >> 4) & 3, (b >> 2) & 3, b & 3])) for b in bits]
    return tuple(int(v) for v in origin), vx


def _new_leaf_origins(vox, n):
    have = {tuple(int(v) for v in o) for o in vox.geometries[0].flat.leaf_origin}
    return [(x, y, z) for x in range(0, 256, 4) for y in range(0, 256, 4)
            for z in range(0, 256, 4) if (x, y, z) not in have][:n]


def seq_pillar_carve(p):
    p.edit(_pillar(p.jv), 3)
    a = p.refit()
    p.edit(_pillar(p.jv), None)
    size = p.jv.geometries[0].size
    p.edit(np.array([[size[0] // 2, y, size[2] // 2]
                     for y in range(size[1])]), None)
    return [a, p.refit()]


def seq_materials(p):
    n_before = len(p.jv.geometries[0].materials)
    p.edit((0, 0, 0), 7)
    tiers = [p.refit()]
    assert len(p.tv.geometries[0].materials) == n_before + 1
    np.testing.assert_array_equal(p.tv.geometries[0].materials,
                                  p.jv.geometries[0].materials)
    return tiers


def seq_one_voxel(p):
    p.edit((1, 1, 1), 5)
    return [p.refit()]


def seq_slab(p):
    p.edit(_slab(p.jv), 4)
    return [p.refit()]


def seq_water_pillar(p):
    p.edit(_pillar(p.jv), 8)
    return [p.refit()]


def seq_palette_change(p):
    _, vx = _occupied_leaf(p.jv)
    p.edit(vx[0], 9)
    return [p.refit()]


def seq_add_clear_in_leaf(p):
    origin, vx = _occupied_leaf(p.jv)
    free = next(c for c in ((origin[0] + ((b >> 4) & 3),
                             origin[1] + ((b >> 2) & 3), origin[2] + (b & 3))
                            for b in range(64)) if c not in set(vx))
    p.edit(free, 4)
    p.edit(vx[0], None)
    tiers = [p.refit()]
    p.edit((0, 0, 0) if (0, 0, 0) != free else (4, 0, 0), 5)
    return tiers + [p.refit()]


def seq_new_leaf(p):
    p.edit(_new_leaf_origins(p.jv, 1)[0], 3)
    return [p.refit()]


def seq_first_and_last_leaf(p):
    """A leaf patch of the model's first and last leaf rows."""
    last = p.jv.geometries[0].num_blocks - 1
    p.edit(_occupied_leaf(p.jv, 0)[1][0], 9)
    p.edit(_occupied_leaf(p.jv, last)[1][0], 10)
    return [p.refit()]


def seq_past_gi_cap(p):
    """A splice that grows the model past its pinned dense-GI cell cap,
    then a leaf patch of its last leaf row, which has no GI cell: the
    patch's GI rows are all padding and must write nothing."""
    cap = p.je.device.gi_cell_cap[0]
    grow = cap - p.jv.geometries[0].num_blocks + 8
    p.edit(np.array(_new_leaf_origins(p.jv, grow)), 6)
    tiers = [p.refit()]
    last = p.jv.geometries[0].num_blocks - 1
    assert last >= p.je.device.gi_cell_cap[0]
    p.edit(_occupied_leaf(p.jv, last)[1][0], 11)
    return tiers + [p.refit()]


def seq_seeded_stream(p):
    """A seeded stream: repaints, clears and sets in occupied leaves with
    duplicate writes to one voxel (leaf tier); a leaf emptied; voxels in
    new leaves; then repaints in a leaf the splice added (leaf tier)."""
    rng = np.random.default_rng(2323)

    def pal():
        return int(rng.integers(0, 256))

    occ = p.jv.geometries[0].flat.occupancy_u64()
    counts = np.unpackbits(occ.view(np.uint8).reshape(-1, 8), axis=1).sum(1)
    rows = rng.choice(np.flatnonzero(counts >= 3), 6, replace=False)
    leaves = [_occupied_leaf(p.jv, int(r)) for r in rows]
    for origin, vx in leaves[:4]:
        free = [c for c in ((origin[0] + ((b >> 4) & 3),
                             origin[1] + ((b >> 2) & 3), origin[2] + (b & 3))
                            for b in range(64)) if c not in set(vx)]
        p.edit(vx[0], pal())
        p.edit(vx[1], None)
        if free:
            p.edit(free[int(rng.integers(len(free)))], pal())
    dup = leaves[4][1]
    p.edit([dup[0]] * 3, [pal(), pal(), pal()])  # last write wins
    p.edit(dup[1], pal())
    p.edit(dup[1], None)                         # set, then cleared
    p.edit(dup[2], None)
    p.edit(dup[2], pal())                        # cleared, then set
    tiers = [p.refit()]
    p.edit(leaves[5][1], None)                   # a leaf emptied
    tiers.append(p.refit())
    new = _new_leaf_origins(p.jv, 3)
    p.edit(new, [pal() for _ in new])            # voxels in new leaves
    p.edit(new[0], pal())
    tiers.append(p.refit())
    p.edit(new[1], pal())                        # a leaf the splice added
    p.edit((new[2][0] + 1, new[2][1], new[2][2]), pal())
    p.edit(dup[0], None)
    return tiers + [p.refit()]


SEQUENCES = {
    "pillar_carve": (seq_pillar_carve, ["splice", "splice"]),
    "materials": (seq_materials, ["splice"]),
    "one_voxel": (seq_one_voxel, ["splice"]),
    "slab": (seq_slab, ["rebuild"]),
    "water_pillar": (seq_water_pillar, ["splice"]),
    "palette_change": (seq_palette_change, ["leaf"]),
    "add_clear_in_leaf": (seq_add_clear_in_leaf, ["leaf", None]),
    "new_leaf": (seq_new_leaf, [None]),
    "first_and_last_leaf": (seq_first_and_last_leaf, ["leaf"]),
    "past_gi_cap": (seq_past_gi_cap, ["splice", "leaf"]),
    "seeded_stream": (seq_seeded_stream, ["leaf", None, None, "leaf"]),
}


@pytest.mark.parametrize("kind", ["teapot", "five_teapots"])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_edit_sequence_matches_reference(name, kind):
    """With a dense GI state: tiers, scenes and GI tables as the
    reference's after every refit."""
    seq, want = SEQUENCES[name]
    tiers = seq(Pair(kind, gi="dense"))
    for got, w in zip(tiers, want):
        if w is None:
            assert got in ("splice", "rebuild")
        else:
            assert got == w
    assert len(tiers) == len(want)


@pytest.mark.parametrize("name", ["one_voxel", "palette_change", "slab"])
def test_edit_without_state_matches_reference(name):
    seq, want = SEQUENCES[name]
    assert seq(Pair()) == want


@pytest.mark.parametrize("kind", ["teapot", "five_teapots"])
def test_hash_working_set_follows_refits(kind):
    """Hash mode with a persistent working set: the leaf tier patches its
    albedo words and the splice refreshes them, as the reference does."""
    p = Pair(kind, gi="hash_ws")
    assert p.tst.gi_ws is not None
    assert seq_palette_change(p) == ["leaf"]
    assert seq_materials(p) == ["splice"]


def test_noop_refit_is_identity():
    p = Pair()
    assert p.te.refit() is p.te.device
    state = p.te.refit_async()
    assert state is p.te.device and not p.te.refit_in_flight


@pytest.fixture(scope="module")
def rays():
    """The teapot's camera rays and 2048 secondary rays, as one set."""
    sets = teapot_ray_sets(jbuild(_vox("teapot", False)))
    return tuple(np.concatenate([a, b]) for a, b in
                 zip(sets["camera"], sets["secondary"]))


@pytest.mark.parametrize("name,tier", [("palette_change", "leaf"),
                                       ("one_voxel", "splice"),
                                       ("slab", "rebuild")])
def test_traced_hits_after_tier(rays, name, tier):
    p = Pair()
    assert SEQUENCES[name][0](p) == [tier]
    o, d, tn, _, tx = rays
    ref = pt.trace_scene_pallas(p.je.device, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tn, jnp.float32),
                                jnp.asarray(tx, jnp.float32), mode="precise",
                                interpret=True)
    got = hdda.trace_scene(p.te.device, tensor(o), tensor(d), tensor(tn),
                           tensor(tx), "precise")
    for field in ("inst", "row", "bit"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert int((got.inst >= 0).sum()) > 1500
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-6)


# ---- the staged refit -------------------------------------------------


def _poll(ed, state=None):
    deadline = time.time() + 60.0
    out = None
    while out is None and time.time() < deadline:
        out = ed.poll_refit(state)
        time.sleep(0.005)
    return out


def test_async_splice_matches_sync():
    p = Pair(gi="dense")
    p.edit((1, 1, 1), 5)
    assert p.te.refit_async(p.tst) is None        # staged: a new leaf
    assert p.te.refit_in_flight
    device, state = _poll(p.te, p.tst)
    assert not p.te.refit_in_flight
    _, p.jst = p.je.refit(p.jst)                   # the reference, sync
    assert p.te.last_refit_mode == p.je.last_refit_mode == "splice"
    assert device is p.te.device
    _assert_scene_equal(device, p.je.device)
    p.tst = state
    p._check_state()


def test_async_leaf_patch_applies_inline():
    p = Pair()
    c = p.te.voxels(0)[0][0]
    p.edit(c, 9)
    out = p.te.refit_async()
    assert out is p.te.device and not p.te.refit_in_flight
    p.je.refit()
    assert p.te.last_refit_mode == p.je.last_refit_mode == "leaf"
    _assert_scene_equal(p.te.device, p.je.device)


def test_staged_rebuild_is_the_grid_at_staging(monkeypatch):
    """The worker, held until released, builds from the grid as it stood
    when ``refit_async`` staged it: the edits made in flight (the staged
    voxel repainted, a clear, a voxel in another new leaf) leave the grid
    as it was and stay pending, none lost, and the next refit lands them
    as the reference lands them, refit after each batch."""
    p = Pair()
    release = threading.Event()
    build = p.te._rebuild_geometry

    def held(mid):
        release.wait(60.0)
        return build(mid)

    monkeypatch.setattr(p.te, "_rebuild_geometry", held)
    new = _new_leaf_origins(p.jv, 2)
    _, vx = _occupied_leaf(p.jv)
    staged = {new[0]: 5, vx[0]: 9}
    flight = {new[0]: 6, vx[1]: None, new[1]: 7}
    for c, v in staged.items():
        p.te.set_voxel(0, c, v)
    assert p.te.refit_async() is None
    at_staging = p.te.voxels(0)
    for c, v in flight.items():
        p.te.set_voxel(0, c, v)
    assert p.te.poll_refit() is None and p.te.refit_in_flight
    release.set()
    assert p.te.poll_refit(block=True) is not None
    assert p.te._pending[0] == flight
    for got, want in zip(p.te.voxels(0), at_staging):
        np.testing.assert_array_equal(got, want)
    geo = p.tv.geometries[0]
    want = build_model_geometry(*at_staging, p.tv.palette, geo.size,
                                geo.unit_size)
    for f in dataclasses.fields(want.flat):
        np.testing.assert_array_equal(getattr(geo.flat, f.name),
                                      getattr(want.flat, f.name), f.name)
    for f in ("materials", "avg_albedo"):
        np.testing.assert_array_equal(getattr(geo, f), getattr(want, f), f)
    p.te.refit()
    for batch in (staged, flight):
        for c, v in batch.items():
            p.je.set_voxel(0, c, v)
        p.je.refit()
    assert p.te.last_refit_mode == p.je.last_refit_mode == "splice"
    assert not p.te._pending[0]
    _assert_scene_equal(p.te.device, p.je.device)


def test_edits_during_flight_stay_pending():
    p = Pair()
    p.te.set_voxel(0, (1, 1, 1), 5)
    assert p.te.refit_async() is None
    p.te.set_voxel(0, (3, 1, 1), 6)                # lands mid-flight
    assert p.te.poll_refit(block=True) is not None
    assert p.te._pending[0]                        # still pending
    p.te.refit()                                   # the next refit takes it
    # The reference, refit after each edit: a splice (a new leaf), then a
    # leaf patch (the second voxel is in the new leaf).
    p.je.set_voxel(0, (1, 1, 1), 5)
    p.je.refit()
    p.je.set_voxel(0, (3, 1, 1), 6)
    p.je.refit()
    assert p.te.last_refit_mode == p.je.last_refit_mode == "leaf"
    _assert_scene_equal(p.te.device, p.je.device)


def test_edits_in_flight_with_frequent_thread_switches():
    """Many edits set while the rebuild runs, the interpreter switching
    threads every microsecond: none is lost or folded into the staged
    rebuild, and the next refit gives the reference's scene."""
    p = Pair()
    origins = _new_leaf_origins(p.jv, 41)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        p.te.set_voxel(0, origins[0], 5)
        assert p.te.refit_async() is None
        for k, o in enumerate(origins[1:]):
            p.te.set_voxel(0, o, 6 + k % 3)
        assert _poll(p.te) is not None
    finally:
        sys.setswitchinterval(old)
    assert not p.te.refit_in_flight
    assert len(p.te._pending[0]) == 40
    p.te.refit()
    p.je.set_voxel(0, origins[0], 5)
    p.je.refit()
    for k, o in enumerate(origins[1:]):
        p.je.set_voxel(0, o, 6 + k % 3)
    p.je.refit()
    assert p.te.last_refit_mode == p.je.last_refit_mode == "splice"
    _assert_scene_equal(p.te.device, p.je.device)


def test_poll_refit_reraises_the_workers_exception(monkeypatch):
    """The reference swallows the worker's exception and then fails with
    a bare KeyError; the port raises the worker's own exception, and the
    edit is not lost: a later edit that alone would take the leaf tier
    takes a splice that carries both."""
    p = Pair()
    before = p.te.device

    def broken(mid):
        raise RuntimeError("planted geometry failure")

    monkeypatch.setattr(p.te, "_rebuild_geometry", broken)
    p.te.set_voxel(0, (1, 1, 1), 5)
    assert p.te.refit_async() is None
    with pytest.raises(RuntimeError, match="planted geometry failure"):
        p.te.poll_refit(block=True)
    assert not p.te.refit_in_flight
    assert p.te.device is before
    monkeypatch.undo()
    _, vx = _occupied_leaf(p.jv)
    p.te.set_voxel(0, vx[0], 9)
    p.te.refit()
    assert p.te.last_refit_mode == "splice"
    p.je.set_voxel(0, (1, 1, 1), 5)
    p.je.refit()
    p.je.set_voxel(0, vx[0], 9)
    p.je.refit()
    assert p.je.last_refit_mode == "leaf"
    _assert_scene_equal(p.te.device, p.je.device)


# ---- frames rendered while edits land ----------------------------------


def test_frames_with_edits_match_reference():
    """Three 96x54 dense frames of the teapot on the eager traversal of
    both packages, each renderer carrying its own state: a leaf edit
    before frame 0, a new-leaf edit (splice) before frame 1, a leaf edit
    before frame 2. Output RMSE < 0.01, as tests/test_torch_frame.py."""
    w, h, fov = 96, 54, 0.9
    js_s = JSettings(width=w, height=h, gi_cache="dense")
    ts_s = RenderSettings(width=w, height=h, gi_cache="dense")
    p = Pair()
    jst = jpipe.make_frame_state(js_s, p.je.device)
    tst = tpipe.make_frame_state(ts_s, p.te.device, "cpu")
    c2w = jcam.look_at(TEAPOT_EYE, TEAPOT_TARGET)
    jc = jcam.camera_settings(c2w, fov, js_s.camera.near, js_s.camera.far,
                              w, h)
    tc = tcam.camera_settings(c2w, fov, ts_s.camera.near, ts_s.camera.far,
                              w, h, "cpu")
    jsk, tsk = jsky(js_s.sunlight), tsky(ts_s.sunlight, "cpu")
    jbn, tbn = jnoise(), tnoise("cpu")
    _, vx = _occupied_leaf(p.jv)
    edits = [(vx[0], 12), (_new_leaf_origins(p.jv, 1)[0], 3), (vx[1], 13)]
    tiers = []
    for f, (coords, idx) in enumerate(edits):
        p.edit(coords, idx)
        _, jst = p.je.refit(jst)
        _, tst = p.te.refit(tst)
        tiers.append(p.te.last_refit_mode)
        assert p.je.last_refit_mode == tiers[-1]
        jout, _, jst = jpipe.render_frame(p.je.device, jst, jc, jsk,
                                          jbn.unitvec3_cosine, jbn.scalar,
                                          js_s, tile=2048)
        tout, _, tst = tpipe.render_frame(p.te.device, tst, tc, tsk,
                                          tbn.unitvec3_cosine, tbn.scalar,
                                          ts_s, tile=2048)
        err = rmse(np.asarray(jout), tout.numpy())
        assert err < 0.01, (f, err)
    assert tiers == ["leaf", "splice", "leaf"]


# ---- the edit bench ------------------------------------------------------


def test_bench_edits_fails_without_a_card():
    import os
    import subprocess
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "dust_tpu_torch.bench_edits",
                        "--interleave"], cwd=repo, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_bench_edits_interleave_on_cpu(monkeypatch):
    """The interleaved bench's bookkeeping, its frames stubbed out (a
    castle frame on the CPU takes seconds): every edit takes its tier,
    the last staged splice is landed, and the log holds every edit made
    (4 leaf edits, then one splice staged each time none is in flight;
    with frames this short a splice may land only at the end)."""
    from dust_tpu_torch import bench_edits as be

    ctx = be.setup("cpu", 32, 18, backend="jnp")
    frames = []
    monkeypatch.setattr(be, "render", lambda c, return_aux=False: (
        frames.append(c["scene"]), torch.zeros(18, 32, 3))[1])
    r = be.interleave(ctx, 2)
    assert set(r) == {"base_ms", "leaf_ms", "splice_ms", "swap_frames"}
    assert len(frames) == 1 + 6 * 2
    assert all(f >= 1 for f in r["swap_frames"])
    assert not ctx["editor"].refit_in_flight
    assert ctx["editor"].last_refit_mode == "splice"
    assert len(ctx["edits"]) == 4 + len(r["swap_frames"]) + 1
    assert ctx["scene"] is ctx["editor"].device
