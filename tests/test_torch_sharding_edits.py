"""Edits under the mesh: tests/test_sharding_edits.py's sequence (frame,
an in-leaf edit taking the leaf tier, frame, an out-of-leaf edit taking
the splice tier, frame) through the port's ray-sharded frame on 2 and 4
gloo ranks, against the port's sequence without a mesh and the
reference's sharded sequence on as many virtual CPU devices.

Under the mesh the dense GI table is row-sharded: the leaf tier scatters
albedo words into the rows each rank holds, the splice refreshes them,
and the scene is broadcast again after the splice. The teapot at 64×32,
dense GI. Bounds as in tests/test_torch_sharding.py: against the port's
unsharded sequence the reference's gate (isclose 1e-3 on more than
99.9% of the values) and equal tables; against the reference the
port's frame bounds (RMSE < 0.01) and, for the table, equal counts and
albedo words with radiance close on 99% of the live rows.
"""

import numpy as np
import pytest
import torch

from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.parallel import dryrun

from tests import torch_sharding_ranks as ranks

GATE = 0.999
FOV = 0.9
TIMEOUT_S = 300.0
# name -> RenderSettings fields of the sequence.
JOBS = {
    "jnp": dict(width=64, height=32, gi_cache="dense",
                traversal_backend="jnp",
                spatial_hash=dict(capacity=1 << 12),
                surfels=dict(pool_size=2048)),
    "pallas": dict(width=128, height=16, gi_cache="dense",
                   traversal_backend="pallas",
                   spatial_hash=dict(capacity=1 << 12),
                   surfels=dict(pool_size=2048)),
}


def _jobs():
    from dust_tpu_torch.ops.camera import look_at
    from tests.torch_parity import TEAPOT_EYE, TEAPOT_TARGET

    c2w = look_at(TEAPOT_EYE, TEAPOT_TARGET)
    return [dict(name=name, settings=s, c2w=c2w, fov=FOV)
            for name, s in JOBS.items()]


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """{None: the port's sequences without a mesh, N: rank 0's on N
    ranks, ("ref", N): the reference's sharded "jnp" sequence}."""
    jobs = _jobs()
    out = {None: ranks.edit_jobs(None, jobs)}
    for n in (2, 4):
        per_rank = dryrun.spawn(ranks.edit_jobs, n, "cpu", jobs,
                                timeout_s=TIMEOUT_S,
                                store_dir=tmp_path_factory.mktemp(f"s{n}"))
        out[n] = per_rank[0]
        for res in per_rank[1:]:
            for name in JOBS:
                np.testing.assert_array_equal(res[name]["gi"],
                                              per_rank[0][name]["gi"])
        out[("ref", n)] = _reference_sequence(n, out[None]["jnp"]["voxel"])
    return out


def _reference_sequence(n_devices, voxel):
    """tests/test_sharding_edits.py's ``_run_sequence`` at this size, on
    ``n_devices`` virtual CPU devices, its in-leaf edit at ``voxel`` (the
    port's): (frames, tiers, final table)."""
    from dust_tpu import config as jconfig
    from dust_tpu.ops import camera as jcam
    from dust_tpu.ops.noise import load_blue_noise
    from dust_tpu.ops.sky import bake_sky
    from dust_tpu.parallel.mesh import (make_mesh, ray_sharding,
                                        replicate_scene, shard_frame_state)
    from dust_tpu.render.edits import SceneEditor
    from dust_tpu.render.pipeline import make_frame_state, render_frame
    from dust_tpu.render.scene import build_device_scene
    from tests.torch_parity import TEAPOT_EYE, TEAPOT_TARGET, teapot_vox

    f = dict(JOBS["jnp"])
    settings = jconfig.RenderSettings(**dict(
        f, spatial_hash=jconfig.SpatialHashSettings(**f["spatial_hash"]),
        surfels=jconfig.SurfelSettings(**f["surfels"])))
    mesh = make_mesh(n_devices)
    rs = ray_sharding(mesh)
    vs = teapot_vox()
    scene = replicate_scene(build_device_scene(vs), mesh)
    editor = SceneEditor(vs, scene)
    mid = sorted(vs.geometries)[0]
    state = shard_frame_state(make_frame_state(settings, scene), mesh)
    cs = jcam.camera_settings(jcam.look_at(TEAPOT_EYE, TEAPOT_TARGET), FOV,
                              0.1, 10000.0, settings.width, settings.height)
    sky, bn = bake_sky(settings.sunlight), load_blue_noise()

    def frame(scene, state):
        out, _aux, state = render_frame(
            scene, state, cs, sky, bn.unitvec3_cosine, bn.scalar, settings,
            ray_sharding=rs)
        return np.asarray(out), state

    frames, modes = [], []
    img, state = frame(scene, state)
    frames.append(img)
    editor.set_voxel(mid, voxel, 7)
    scene, state = editor.refit(state)
    modes.append(editor.last_refit_mode)
    img, state = frame(scene, state)
    frames.append(img)
    editor.set_voxel(mid, (2, 2, 2), 11)
    scene, state = editor.refit(state)
    modes.append(editor.last_refit_mode)
    scene = replicate_scene(scene, mesh)
    editor.device = scene
    img, state = frame(scene, state)
    frames.append(img)
    return frames, modes, np.asarray(state.gi.table)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(JOBS))
def test_sharded_sequence_matches_unsharded(sequences, name, n):
    ref, got = sequences[None][name], sequences[n][name]
    assert ref["modes"] == ["leaf", "splice"], ref["modes"]
    assert got["modes"] == ref["modes"]
    for f, (a, b) in enumerate(zip(ref["images"], got["images"])):
        assert np.isfinite(b).all()
        assert np.isclose(a, b, rtol=1e-3, atol=1e-3).mean() > GATE, f
    # The whole table, the leaf tier's albedo words included.
    np.testing.assert_array_equal(got["gi"], ref["gi"])
    np.testing.assert_array_equal(got["history"], ref["history"])


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_sequence_matches_reference_sharded(sequences, n):
    from tools.rmse import rmse

    frames, modes, table = sequences[("ref", n)]
    got = sequences[n]["jnp"]
    assert got["modes"] == modes == ["leaf", "splice"]
    for f, img in enumerate(frames):
        assert rmse(img, got["images"][f]) < 0.01, f
    a, b = table.view(np.uint32), got["gi"].view(np.uint32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(b[:, 1] >> 16, a[:, 1] >> 16)   # counts
    np.testing.assert_array_equal(b[:, 2], a[:, 2])               # albedo
    live = (a[:, 1] >> 16) > 0
    assert live.sum() > 200
    ra = gilib.DenseGICache(
        table=torch.from_numpy(table.copy())).radiance.numpy()
    rb = gilib.DenseGICache(
        table=torch.from_numpy(got["gi"])).radiance.numpy()
    assert np.isclose(rb, ra, rtol=1e-2, atol=1e-3)[live].mean() >= 0.99


@pytest.mark.parametrize("n", [2, 4])
def test_leaf_tier_patches_the_rows_each_rank_holds(n):
    """Each rank's editor (a mesh of rank r of n; the leaf tier needs no
    collective) patches the albedo words of its chunk of the dense
    table: together the chunks are the unsharded editor's table."""
    import dataclasses

    from dust_tpu_torch import parallel
    from dust_tpu_torch.render.edits import SceneEditor
    from dust_tpu_torch.render.pipeline import make_frame_state
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    settings = ranks.settings_of(JOBS["jnp"])

    def edited(mesh):
        vox = load_vox_scene(procgen.teapot_scene_bytes())
        scene = build_device_scene(vox, "cpu")
        state = make_frame_state(settings, scene, "cpu")
        table = state.gi.table
        if mesh is not None:
            lo, hi = parallel.ray_sharding(mesh, table.shape[0])
            state = dataclasses.replace(
                state, gi=gilib.DenseGICache(table=table[lo:hi].clone()))
        editor = SceneEditor(vox, scene, mesh=mesh)
        mid = sorted(vox.geometries)[0]
        for c in editor.voxels(mid)[0][:40:8]:
            editor.set_voxel(mid, tuple(int(v) for v in c), 7)
        _scene, state = editor.refit(state)
        assert editor.last_refit_mode == "leaf"
        return table, state.gi.table

    before, whole = edited(None)
    changed = (whole[:, 2] != before[:, 2]).nonzero().flatten()
    chunk = -(-whole.shape[0] // n)
    assert len(set((changed // chunk).tolist())) == n, \
        "the edit must patch rows of every rank"
    parts = [edited(parallel.Mesh(group=None, rank=r, size=n,
                                  device=torch.device("cpu")))[1]
             for r in range(n)]
    assert torch.equal(torch.cat(parts), whole)
