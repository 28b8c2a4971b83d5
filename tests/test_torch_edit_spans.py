"""The scene editor's spans and refit counter (``render/edits.py``).

Under a profiler a refit opens ``dust.edit.refit`` on the caller's
thread and, inside it, the steps of its tier: ``dust.edit.merge`` and
``dust.edit.patch`` for the leaf tier, ``dust.edit.merge``,
``dust.edit.rebuild`` and ``dust.edit.splice`` for a synchronous splice
or rebuild; a staged refit opens ``dust.edit.rebuild`` on its worker
thread (seen by a profiler that follows every thread) and ``poll_refit``
the splice. ``edits.REFITS`` counts one a landed refit under its tier;
``edits.CELLS`` the editor's grid cells that a leaf refit touches on the
caller's thread (the castle's one-voxel refit: one written, 64 read).
Untraced, the editor's scene and GI tables are the reference editor's
(``dust_tpu.render.edits``) bit for bit, and the same traced. The
teapot, torch on one thread. The test marked ``gpu`` runs the tiers on
the card against a CPU editor; run it there with ``--noconftest``."""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile
from torch_card import card, chip_smoke  # noqa: F401

from dust_tpu_torch import config
from dust_tpu_torch.render import edits
from dust_tpu_torch.render.edits import SceneEditor
from dust_tpu_torch.render.pipeline import make_frame_state
from dust_tpu_torch.render.scene import build_device_scene
from dust_tpu_torch.vox import procgen
from dust_tpu_torch.vox.loader import load_vox_scene

SPANS = ("dust.edit.set", "dust.edit.refit", "dust.edit.merge",
         "dust.edit.patch", "dust.edit.rebuild", "dust.edit.splice")
# tier -> the spans a synchronous refit of it opens inside dust.edit.refit
TIERS = {"leaf": {"dust.edit.merge", "dust.edit.patch"},
         "splice": {"dust.edit.merge", "dust.edit.rebuild",
                    "dust.edit.splice"},
         "rebuild": {"dust.edit.merge", "dust.edit.rebuild",
                     "dust.edit.splice"}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _editor(device="cpu"):
    """The teapot's editor and a dense GI frame state on ``device``."""
    vox = load_vox_scene(procgen.teapot_scene_bytes())
    ed = SceneEditor(vox, build_device_scene(vox, device))
    settings = config.RenderSettings(width=32, height=32, gi_cache="dense")
    return ed, make_frame_state(settings, ed.device, device)


def _tier_edit(vox, tier):
    """(coords, palette index) of an edit that takes ``tier``: a palette
    change in an occupied leaf, a voxel in a new leaf, or a slab of more
    new leaves than the scene's padding."""
    flat = vox.geometries[0].flat
    if tier == "leaf":
        origin = flat.leaf_origin[0].astype(np.int64)
        bit = next(b for b in range(64)
                   if (int(flat.occupancy_u64()[0]) >> b) & 1)
        return (origin + [(bit >> 4) & 3, (bit >> 2) & 3, bit & 3])[None], 9
    if tier == "splice":
        have = {tuple(int(v) for v in o) for o in flat.leaf_origin}
        origin = next((x, y, z) for x in range(0, 256, 4)
                      for y in range(0, 256, 4) for z in range(0, 256, 4)
                      if (x, y, z) not in have)
        return np.array([origin]), 5
    size = vox.geometries[0].size
    xs, ys, zs = np.meshgrid(np.arange(0, size[0], 2), np.arange(4),
                             np.arange(0, size[2], 2), indexing="ij")
    return np.stack([xs.ravel(), ys.ravel(), zs.ravel()], 1), 4


def _profile(device="cpu"):
    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))


def _spans(prof):
    """(start, end, name, thread) of every ``dust.edit.*`` range."""
    return sorted((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("dust.edit.")
                  and e.is_user_annotation())


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _delta(before):
    return {k: edits.REFITS[k] - before[k] for k in edits.REFITS}


def _count(tier):
    return {k: int(k == tier) for k in edits.REFITS}


def _tensors(x):
    """Every tensor of a scene or frame state, in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif not isinstance(x, tuple):
        return []
    return [t for v in x for t in _tensors(v)]


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) > 4
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


# ---- spans ---------------------------------------------------------------

@pytest.mark.parametrize("tier", sorted(TIERS))
def test_refit_spans_by_tier(tier):
    """A synchronous refit: ``dust.edit.set`` for the edit, one
    ``dust.edit.refit``, and its tier's steps inside it, all on the
    caller's thread."""
    ed, state = _editor()
    coords, idx = _tier_edit(ed.vox_scene, tier)
    with _profile() as prof:
        ed.set_voxels(0, coords, idx)
        _, state = ed.refit(state)
    assert ed.last_refit_mode == tier
    spans = _spans(prof)
    assert {sp[3] for sp in spans} == {spans[0][3]}
    names = [sp[2] for sp in spans]
    assert names.count("dust.edit.set") == 1
    assert names.count("dust.edit.refit") == 1
    assert set(names) == TIERS[tier] | {"dust.edit.set", "dust.edit.refit"}
    refit = next(sp for sp in spans if sp[2] == "dust.edit.refit")
    for sp in spans:
        if sp[2] in TIERS[tier]:
            assert _inside(sp, refit), sp[2]
    set_span = next(sp for sp in spans if sp[2] == "dust.edit.set")
    assert set_span[1] <= refit[0]
    # A splice or rebuild opens one splice span for the scene and one for
    # the GI tables' re-keying.
    assert names.count("dust.edit.splice") == (0 if tier == "leaf" else 2)


def test_staged_refit_spans():
    """``refit_async`` merges on the caller's thread and rebuilds on its
    worker; ``poll_refit`` splices on the caller's thread."""
    ed, state = _editor()
    coords, idx = _tier_edit(ed.vox_scene, "splice")
    with _profile() as prof:
        ed.set_voxels(0, coords, idx)
        assert ed.refit_async(state) is None
        _, state = ed.poll_refit(state, block=True)
    assert ed.last_refit_mode == "splice"
    spans = _spans(prof)
    caller = next(sp[3] for sp in spans if sp[2] == "dust.edit.set")
    refits = [sp for sp in spans if sp[2] == "dust.edit.refit"]
    assert len(refits) == 2 and all(sp[3] == caller for sp in refits)
    staged, polled = refits
    rebuild = [sp for sp in spans if sp[2] == "dust.edit.rebuild"]
    assert len(rebuild) == 1 and rebuild[0][3] != caller
    merge = [sp for sp in spans if sp[2] == "dust.edit.merge"]
    assert len(merge) == 1 and merge[0][3] == caller
    assert _inside(merge[0], staged)
    splices = [sp for sp in spans if sp[2] == "dust.edit.splice"]
    assert len(splices) == 2
    assert all(sp[3] == caller and _inside(sp, polled) for sp in splices)
    assert not any(sp[2] == "dust.edit.patch" for sp in spans)


# ---- the counter ---------------------------------------------------------

@pytest.mark.parametrize("tier", sorted(TIERS))
def test_refits_count_a_landed_refit(tier):
    """One under the tier the refit took, and a refit with nothing
    pending (sync or staged) counts nothing."""
    ed, state = _editor()
    before = dict(edits.REFITS)
    assert ed.refit(state)[0] is ed.device
    scene, same = ed.refit_async(state)
    assert scene is ed.device and same is state
    assert _delta(before) == _count(None)
    coords, idx = _tier_edit(ed.vox_scene, tier)
    ed.set_voxels(0, coords, idx)
    ed.refit(state)
    assert ed.last_refit_mode == tier
    assert _delta(before) == _count(tier)


def test_refits_count_a_staged_refit_when_it_lands(monkeypatch):
    """Nothing while the worker's rebuild is in flight; one splice when
    ``poll_refit`` lands it."""
    ed, state = _editor()
    release = threading.Event()
    build = ed._rebuild_geometry

    def held(mid):
        release.wait(60.0)
        return build(mid)

    monkeypatch.setattr(ed, "_rebuild_geometry", held)
    coords, idx = _tier_edit(ed.vox_scene, "splice")
    before = dict(edits.REFITS)
    ed.set_voxels(0, coords, idx)
    assert ed.refit_async(state) is None
    assert ed.poll_refit(state) is None and ed.refit_in_flight
    assert _delta(before) == _count(None)
    release.set()
    assert ed.poll_refit(state, block=True) is not None
    assert ed.last_refit_mode == "splice"
    assert _delta(before) == _count("splice")


def test_cells_of_a_one_voxel_leaf_refit_on_the_castle():
    """A one-voxel leaf refit on the castle (1,362,970 voxels) writes one
    grid cell in its merge and reads the 64 cells of its leaf: no step
    on the caller's thread walks the model's voxels."""
    vox = load_vox_scene(procgen.castle_scene_bytes())
    ed = SceneEditor(vox, build_device_scene(vox, "cpu"))
    before = dict(edits.CELLS)
    ed.set_voxels(0, *_tier_edit(vox, "leaf"))
    ed.refit()
    assert ed.last_refit_mode == "leaf"
    assert {k: edits.CELLS[k] - before[k] for k in edits.CELLS} == {
        "merge": 1, "leaf": 64}


# ---- outputs -------------------------------------------------------------

def _run_tiers(ed, state):
    """A leaf patch, a staged splice and a rebuild, in turn: (edit, scene,
    frame state) after each."""
    out = []
    for tier in ("leaf", "splice", "rebuild"):
        edit = _tier_edit(ed.vox_scene, tier)
        ed.set_voxels(0, *edit)
        if tier == "splice":
            assert ed.refit_async(state) is None
            _, state = ed.poll_refit(state, block=True)
        else:
            _, state = ed.refit(state)
        assert ed.last_refit_mode == tier
        out.append((edit, ed.device, state))
    return out


def test_untraced_outputs_are_the_references():
    """Untraced, every scene field and the dense GI table after each tier
    equal the reference editor's; traced, the same again."""
    from dust_tpu.config import RenderSettings as JSettings
    from dust_tpu.render import pipeline as jpipe
    from dust_tpu.render.edits import SceneEditor as JEditor
    from dust_tpu.render.scene import build_device_scene as jbuild
    from dust_tpu.vox import procgen as jprocgen
    from dust_tpu.vox.loader import load_vox_scene as jload
    from tests.torch_parity import port_scene

    plain = _run_tiers(*_editor())
    with _profile():
        traced = _run_tiers(*_editor())
    jv = jload(jprocgen.teapot_scene_bytes())
    je = JEditor(jv, jbuild(jv))
    jst = jpipe.make_frame_state(
        JSettings(width=32, height=32, gi_cache="dense"), je.device)
    for (edit, scene, state), (_, tscene, tstate) in zip(plain, traced):
        je.set_voxels(0, *edit)
        _, jst = je.refit(jst)
        _assert_same(scene, port_scene(je.device))
        np.testing.assert_array_equal(
            state.gi.table.numpy(), np.asarray(jst.gi.table).view(np.int32))
        _assert_same(scene, tscene)
        _assert_same(state, tstate)
    assert je.last_refit_mode == "rebuild"


# ---- on the card ---------------------------------------------------------

@pytest.mark.gpu
def test_tiers_on_the_card(card):
    """A leaf patch, a staged splice and a rebuild on the card under a
    profiler: each tier's spans, one count a tier, and the card's scene
    equal to a CPU editor's given the same edits."""
    smoke = chip_smoke()
    ed, state = _editor(card)
    cpu_ed, cpu_state = _editor()
    before = dict(edits.REFITS)
    with _profile(card) as prof:
        out = _run_tiers(ed, state)
    torch.cuda.synchronize()
    assert _delta(before) == {"leaf": 1, "splice": 1, "rebuild": 1}
    names = {sp[2] for sp in _spans(prof)}
    assert names == set(SPANS)
    for (_, scene, _), (_, cpu_scene, _) in zip(out, _run_tiers(cpu_ed,
                                                                cpu_state)):
        smoke._scenes_equal("edit spans", scene, cpu_scene)
