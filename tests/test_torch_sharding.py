"""The ray-sharded frame (:mod:`dust_tpu_torch.parallel`) on 2 and 4 gloo
ranks, against the port's frame without a mesh and the reference's
sharded frame (``dust_tpu.parallel.mesh`` on the virtual CPU devices of
tests/conftest.py).

The ranks are spawned processes (one torch thread each) joined through
a ``FileStore`` in ``tmp_path``; the parent kills them if they are not
done in time. The teapot, 64×32 to 128×16, 2 frames.

Tolerances. Sharded against unsharded, the port: the reference's own
gate, isclose(rtol=1e-3, atol=1e-3) on more than 99.9% of the values:
only two reductions can round otherwise, the exposure's float sum over
the ranks and, at more than 2 instances, the sweep order's mean ray
origin per rank; the tables must be equal. Port against reference: the
bounds of tests/test_torch_frame.py (RMSE < 0.01, hit masks >= 99.5%,
equal on the eager backend) and of the other frame tests for the tables,
since the two unsharded frames agree on only 99.6-99.8% of the values
at isclose 1e-3 (XLA and torch round a few ops apart). The per-rank
trace inputs and the per-rank chunked traces must equal what
``jax.shard_map`` hands each device and computes there, exactly.

JAX, the reference and the tests' helper modules are imported inside
the fixtures and tests, so that the ``gpu`` test runs on a machine
without JAX (where another installed package may own the name
``tests``).
"""

import types

import numpy as np
import pytest
import torch

from dust_tpu_torch import parallel
from dust_tpu_torch.ops import hdda
from dust_tpu_torch.parallel import dryrun

GATE = 0.999
FOV = 0.9
TIMEOUT_S = 300.0


def _ranks():
    """What each spawned rank runs (tests/torch_sharding_ranks.py)."""
    from tests import torch_sharding_ranks

    return torch_sharding_ranks


def _c2w():
    from tests.torch_parity import TEAPOT_EYE, TEAPOT_TARGET
    from dust_tpu_torch.ops.camera import look_at

    return look_at(TEAPOT_EYE, TEAPOT_TARGET)


def _settings(width, height, **changes):
    return dict(dict(width=width, height=height,
                     spatial_hash=dict(capacity=1 << 12),
                     surfels=dict(pool_size=1002)), **changes)


# name -> (scene, settings dict); every job renders 2 frames.
JOBS = {
    "jnp": ("teapot", _settings(64, 32, gi_cache="dense",
                                traversal_backend="jnp")),
    "pallas": ("teapot", _settings(128, 16, gi_cache="dense",
                                   traversal_backend="pallas")),
    "hash": ("teapot", _settings(64, 32, gi_cache="hash",
                                 traversal_backend="jnp")),
    # A budget window of 1001 rows crossing the table's chunks.
    "budget": ("teapot", _settings(
        64, 32, gi_cache="dense", traversal_backend="jnp",
        surfels=dict(pool_size=1002, dense_refresh_budget=1001))),
    # 18 half-res rows: chunks of 5, 5, 5, 3 over 4 ranks, against full-
    # res chunks of 9 (the reference's mesh cannot split 18 rows over 4
    # devices, so the port alone).
    "rows": ("teapot", _settings(64, 36, gi_cache="dense",
                                 traversal_backend="jnp")),
    "five": ("five", _settings(128, 16, gi_cache="dense",
                               traversal_backend="pallas")),
}


def _ref_settings(fields):
    from dust_tpu import config as jconfig

    f = dict(fields)
    for key, cls in (("spatial_hash", jconfig.SpatialHashSettings),
                     ("surfels", jconfig.SurfelSettings),
                     ("denoiser", jconfig.DenoiserSettings)):
        if key in f:
            f[key] = cls(**f[key])
    return jconfig.RenderSettings(**f)


@pytest.fixture(scope="module")
def scenes():
    from dust_tpu.render.scene import build_device_scene
    from tests.torch_parity import five_teapots_vox, scene_numpy, teapot_vox

    out = {}
    for name, vox in (("teapot", teapot_vox()), ("five", five_teapots_vox())):
        js = build_device_scene(vox)
        out[name] = (js, scene_numpy(js))
    return out


def _jobs(scenes, names=JOBS):
    return [dict(name=name, scene=scenes[JOBS[name][0]][1],
                 settings=JOBS[name][1], c2w=_c2w(), fov=FOV, frames=2)
            for name in names]


@pytest.fixture(scope="module")
def sharded(scenes, tmp_path_factory):
    """{N: {job: the ranks' results}} on 2 and 4 gloo ranks."""
    jobs = _jobs(scenes)
    return {n: dryrun.spawn(_ranks().render_jobs, n, "cpu", jobs,
                            timeout_s=TIMEOUT_S,
                            store_dir=tmp_path_factory.mktemp(f"store{n}"))
            for n in (2, 4)}


@pytest.fixture(scope="module")
def unsharded(scenes):
    """{job: the port's frames without a mesh}."""
    return {job["name"]: _ranks().render(None, job)
            for job in _jobs(scenes)}


def _reference(scenes, name, n_devices):
    """The reference's sharded frames of a job on ``n_devices`` virtual
    CPU devices: (images, depths, final state)."""
    from dust_tpu.ops import camera as jcam
    from dust_tpu.ops.noise import load_blue_noise
    from dust_tpu.ops.sky import bake_sky
    from dust_tpu.parallel.mesh import (make_mesh, ray_sharding,
                                        replicate_scene, shard_frame_state)
    from dust_tpu.render import pipeline as jpipe

    s = _ref_settings(JOBS[name][1])
    js = scenes[JOBS[name][0]][0]
    mesh = make_mesh(n_devices)
    rs = ray_sharding(mesh)
    js = replicate_scene(js, mesh)
    state = shard_frame_state(jpipe.make_frame_state(s, js), mesh)
    cam = jcam.camera_settings(_c2w(), FOV, 0.1, 10000.0, s.width, s.height)
    sky, bn = bake_sky(s.sunlight), load_blue_noise()
    images, depths = [], []
    for _ in range(2):
        out, aux, state = jpipe.render_frame(
            js, state, cam, sky, bn.unitvec3_cosine, bn.scalar, s,
            ray_sharding=rs)
        images.append(np.asarray(out))
        depths.append(np.asarray(aux["depth"]))
    return images, depths, state


def _close(a, b):
    return np.isclose(a, b, rtol=1e-3, atol=1e-3).mean()


# ---------------------------------------------------------------------------
# The split: each rank's padded trace inputs are the blocks shard_map hands
# each device.
# ---------------------------------------------------------------------------

def _reference_blocks(o, d, tn, tx, n_devices):
    """The reference's padding (dust_tpu/render/pipeline.py:229-237) and an
    identity shard_map over make_mesh(n_devices): each device's block."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dust_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices)
    n_ = o.shape[0]
    pad = (-n_) % n_devices
    o, d = jnp.asarray(o), jnp.asarray(d)
    tn_ = jnp.broadcast_to(jnp.asarray(tn, jnp.float32), (n_,))
    tx_ = jnp.broadcast_to(jnp.asarray(tx, jnp.float32), (n_,))
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
        tn_ = jnp.concatenate([tn_, jnp.zeros((pad,), jnp.float32)])
        tx_ = jnp.concatenate([tx_, jnp.full((pad,), -1.0, jnp.float32)])
    spec = P("rays")
    blocks = jax.shard_map(lambda *a: tuple(x[None] for x in a), mesh=mesh,
                           in_specs=(spec,) * 4, out_specs=(spec,) * 4,
                           check_vma=False)(o, d, tn_, tx_)
    return [np.asarray(b) for b in blocks]


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d, rng.uniform(0, 1, n).astype(np.float32), \
        rng.uniform(1, 9, n).astype(np.float32)


@pytest.mark.parametrize("length, n_devices", [
    (16, 4), (18, 4), (1001, 4), (3, 4), (16, 2), (1001, 2)])
def test_trace_inputs_are_the_shard_map_blocks(length, n_devices):
    o, d, tn, tx = _rays(length, seed=length)
    blocks = _reference_blocks(o, d, tn, tx, n_devices)
    for r in range(n_devices):
        mesh = parallel.Mesh(group=None, rank=r, size=n_devices,
                             device=torch.device("cpu"))
        lo, hi = parallel.ray_sharding(mesh, length)
        assert lo == min(length, r * mesh.chunk(length))
        got = parallel.pad_rays(mesh, length, *(torch.from_numpy(x[lo:hi])
                                                for x in (o, d, tn, tx)))
        for g, b in zip(got, blocks):
            np.testing.assert_array_equal(g.numpy(), b[r])


def test_scalar_bounds_pad_as_the_reference():
    o, d, _, _ = _rays(18, seed=1)
    blocks = _reference_blocks(o, d, 0.1, 8.0, 4)
    mesh = parallel.Mesh(group=None, rank=3, size=4,
                         device=torch.device("cpu"))
    lo, hi = parallel.ray_sharding(mesh, 18)
    assert (lo, hi) == (15, 18)
    got = parallel.pad_rays(mesh, 18, torch.from_numpy(o[lo:hi]),
                            torch.from_numpy(d[lo:hi]), 0.1, 8.0)
    for g, b in zip(got, blocks):
        np.testing.assert_array_equal(g.numpy(), b[3])


def test_chunked_trace_matches_shard_map_on_five_teapots(scenes):
    """Each rank's chunk of 1001 rays aimed at the five teapots (more
    than 2 instances: the sweep order comes from the rank's padded
    chunk; the view from above overlaps them), traced by the port's
    scene-trace route, against shard_map of trace_scene_pallas in
    interpret mode on 4 virtual devices, precise mode (the primary rays,
    where the sweep order decides an exact tie): t, inst, row and bit
    equal."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dust_tpu.ops.pallas_trace import trace_scene_pallas
    from dust_tpu.parallel.mesh import make_mesh
    from tests.test_torch_multi import _aimed_rays
    from tests.torch_parity import port_scene

    js = scenes["five"][0]
    ts = port_scene(js)
    o, d = _aimed_rays(js, (240.0, 300.0, 100.0), 1001, 0)
    n, tmax = o.shape[0], 10000.0
    blocks = _reference_blocks(o, d, 0.1, tmax, 4)
    scene_specs = jax.tree.map(lambda _: P(), js)
    ref = jax.shard_map(
        lambda s_, *r: trace_scene_pallas(s_, *r, mode="precise",
                                          interpret=True),
        mesh=make_mesh(4), in_specs=(scene_specs,) + (P("rays"),) * 4,
        out_specs=P("rays"), check_vma=False)(
            js, *(jnp.asarray(b.reshape((-1,) + b.shape[2:]))
                  for b in blocks))
    parts = []
    for r in range(4):
        mesh = parallel.Mesh(group=None, rank=r, size=4,
                             device=torch.device("cpu"))
        lo, hi = parallel.ray_sharding(mesh, n)
        res = hdda.trace_scene(ts, *parallel.pad_rays(
            mesh, n, torch.from_numpy(o[lo:hi]), torch.from_numpy(d[lo:hi]),
            0.1, tmax), "precise")
        parts.append([x[:hi - lo].numpy() for x in res])
    got = [np.concatenate(c) for c in zip(*parts)]
    assert (got[1] >= 0).sum() > 500, "the rays must hit the teapots"
    assert set(got[1][got[1] >= 0].tolist()) == set(range(5))
    for g, name in zip(got, ("t", "inst", "row", "bit")):
        np.testing.assert_array_equal(g, np.asarray(getattr(ref, name))[:n],
                                      err_msg=name)


# ---------------------------------------------------------------------------
# The sharded frame
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(JOBS))
def test_sharded_matches_unsharded(sharded, unsharded, name, n):
    ref = unsharded[name]
    per_rank = [r[name] for r in sharded[n]]
    s = JOBS[name][1]
    chunk = -(-s["height"] // n)
    for r, res in enumerate(per_rank):
        # Each rank returns its rows of the image, not the whole image.
        assert res["rows"] == [max(0, min(s["height"] - r * chunk, chunk))] * 2
    got = per_rank[0]
    for f in range(2):
        assert np.isfinite(got["images"][f]).all()
        assert _close(ref["images"][f], got["images"][f]) > GATE, f
        np.testing.assert_array_equal(got["depths"][f], ref["depths"][f])
    np.testing.assert_array_equal(got["gi"], ref["gi"])
    np.testing.assert_array_equal(got["surfels"], ref["surfels"])
    np.testing.assert_array_equal(got["history"], ref["history"])
    # Every rank holds the same replicated state.
    for res in per_rank[1:]:
        np.testing.assert_array_equal(res["gi"], got["gi"])
        np.testing.assert_array_equal(res["images"][1], got["images"][1])


@pytest.fixture(scope="module")
def reference(scenes):
    """The reference's sharded frames: {(job, N): (images, depths,
    state)}."""
    return {(name, n): _reference(scenes, name, n)
            for name in ("jnp", "hash") for n in (2, 4)} | {
        ("budget", 4): _reference(scenes, "budget", 4)}


@pytest.mark.parametrize("name, n", [("jnp", 2), ("jnp", 4), ("hash", 2),
                                     ("hash", 4), ("budget", 4)])
def test_sharded_matches_reference_sharded(sharded, reference, name, n):
    from tools.rmse import rmse

    images, depths, state = reference[(name, n)]
    got = sharded[n][0][name]
    for f in range(2):
        # The eager backend: hit masks equal everywhere.
        np.testing.assert_array_equal(np.isfinite(got["depths"][f]),
                                      np.isfinite(depths[f]))
        assert rmse(images[f], got["images"][f]) < 0.01
    if name == "hash":
        from tests.test_torch_hash_frame import _assert_table

        fields = dict(gi=np.asarray(state.gi.table),
                      surfels=np.asarray(state.surfels),
                      frame_index=int(state.frame_index))
        port = types.SimpleNamespace(
            gi=types.SimpleNamespace(table=torch.from_numpy(got["gi"])),
            surfels=torch.from_numpy(got["surfels"]), frame_index=2)
        _assert_table(fields, port, min_occupied=10)
    else:
        a = np.asarray(state.gi.table).view(np.uint32)
        b = got["gi"].view(np.uint32)
        np.testing.assert_array_equal(b[:, 1] >> 16, a[:, 1] >> 16)  # counts
        np.testing.assert_array_equal(b[:, 2], a[:, 2])             # albedo
        live = (a[:, 1] >> 16) > 0
        assert live.sum() > 200
        ra = np.asarray(state.gi.radiance)
        rb = _ranks().gilib.DenseGICache(
            table=torch.from_numpy(got["gi"])).radiance.numpy()
        assert np.isclose(rb, ra, rtol=1e-2, atol=1e-3)[live].mean() >= 0.99


@pytest.mark.slow
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_pallas_matches_reference_sharded_pallas(sharded, scenes, n):
    """Against the reference's sharded frame on its Pallas backend
    (interpret mode on the CPU: slow, as tests/test_sharding.py's)."""
    from tools.rmse import rmse

    images, depths, _ = _reference(scenes, "pallas", n)
    got = sharded[n][0]["pallas"]
    for f in range(2):
        agree = (np.isfinite(got["depths"][f]) == np.isfinite(depths[f]))
        assert agree.mean() >= 0.995
        assert rmse(images[f], got["images"][f]) < 0.01


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_one_rank_nccl_frame_on_the_card():
    """The dry run's four gates on a one-rank NCCL group on the card:
    each ray-sharded frame against the unsharded frame from the same
    state, isclose on more than 99.9% of the values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (res,) = dryrun.spawn(dryrun.gates, 1, "cuda", timeout_s=TIMEOUT_S)
    assert set(res) == {"jnp", "pallas", "wide-orbit", "edit"}
    for gate, share in res.items():
        assert share > GATE, (gate, share)


def test_cuda_ranks_beyond_the_cards_raise():
    with pytest.raises(RuntimeError, match="cards"):
        dryrun.spawn(dryrun.gates, torch.cuda.device_count() + 1, "cuda")


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def test_spawn_returns_each_rank_in_order(tmp_path):
    got = dryrun.spawn(_ranks().rank_and_size, 3, "cpu", timeout_s=TIMEOUT_S,
                       store_dir=tmp_path)
    assert got == [(r, 3, "cpu") for r in range(3)]


@pytest.mark.parametrize("fn, error", [("fails", "planted failure"),
                                       ("dies", "exited with code 3")])
def test_spawn_raises_a_rank_failure_at_once(tmp_path, fn, error):
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=error):
        dryrun.spawn(getattr(_ranks(), fn), 2, "cpu", timeout_s=TIMEOUT_S,
                     store_dir=tmp_path)
    assert time.monotonic() - t0 < TIMEOUT_S / 2
