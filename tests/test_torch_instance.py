"""The port's single-instance traversal against the reference's.

``trace_instance`` / ``trace_instance_ao_fg`` (plain PyTorch version,
CPU) against ``trace_instance_pallas`` / ``trace_instance_pallas_ao_fg``
with the Pallas kernel in interpret mode, on the teapot's camera and
secondary rays taken into object space, in all four modes; then with each
iteration cap lowered until it binds (the reference's ``_make_kernel``
rebuilt with the same caps); then the per-instance ray set-up of the
scene trace's loop route (affine applies and the model-AABB clip), bit
for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dust_tpu.ops import pallas_trace as pt
from dust_tpu.ops import traverse as jtraverse
from dust_tpu.render.scene import build_device_scene
from dust_tpu_torch.ops import hdda
from dust_tpu_torch.ops import traverse as ttraverse
from tests.torch_parity import (five_teapots_vox, port_scene, teapot_ray_sets,
                                teapot_vox, tensor)

MODES = ("precise", "ao_threshold", "rough", "ao_fg")


@pytest.fixture(scope="module")
def scenes():
    js = build_device_scene(teapot_vox())
    return js, port_scene(js)


@pytest.fixture(scope="module")
def rays(scenes):
    """The teapot's ray sets in the instance's object space."""
    js, _ = scenes
    w2o = np.asarray(js.world_to_obj)[0]
    out = {}
    for name, (o, d, tn, ta, tx) in teapot_ray_sets(js).items():
        oo = (o @ w2o[:, :3].T + w2o[:, 3]).astype(np.float32)
        do = (d @ w2o[:, :3].T).astype(np.float32)
        out[name] = (oo, do, tn, ta, tx)
    return out


def _ref_tables(js, m=0):
    return pt.PallasTables(
        l1=js.pl_l1[m], l2_w0=js.pl_l2w0[m], l2_w1=js.pl_l2w1[m],
        l2_r0=js.pl_l2r0[m], l2_r1=js.pl_l2r1[m], mask_lo=js.pl_mlo[m],
        mask_hi=js.pl_mhi[m])


def _t_max(mode, rs):
    """ao_threshold rays end at the AO threshold, as in the frame."""
    return rs[3] if mode == "ao_threshold" else rs[4]


def _reference(js, mode, rs, rounds=64):
    o, d, tn, ta, _ = rs
    tab = _ref_tables(js)
    if mode == "ao_fg":
        out = pt.trace_instance_pallas_ao_fg(
            tab, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tn, jnp.float32),
            jnp.asarray(ta, jnp.float32), jnp.asarray(rs[4], jnp.float32),
            rounds=rounds, interpret=True)
    else:
        out = pt.trace_instance_pallas(
            tab, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tn, jnp.float32),
            jnp.asarray(_t_max(mode, rs), jnp.float32), mode=mode,
            rounds=rounds, interpret=True)
    return [np.asarray(x) for x in out]


def _port(ts, mode, rs, rounds=64, tables=None):
    o, d, tn, ta, _ = rs
    tab = tables or hdda._instance_tables(ts, 0)
    if mode == "ao_fg":
        out = hdda.trace_instance_ao_fg(tab, tensor(o), tensor(d), tensor(tn),
                                        tensor(ta), tensor(rs[4]),
                                        rounds=rounds)
    else:
        out = hdda.trace_instance(tab, tensor(o), tensor(d), tensor(tn),
                                  tensor(_t_max(mode, rs)), mode=mode,
                                  rounds=rounds)
    return [x.numpy() for x in out]


def _assert_exact(ref, got):
    """Ids equal; t equal where finite (rtol 1e-5), inf in the same lanes."""
    for a, b in zip(ref, got):
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-5)
        else:
            np.testing.assert_array_equal(b, a)


def _hits(mode, out):
    """Finite hit distances (both accumulators in ao_fg)."""
    return int(sum(np.isfinite(t).sum()
                   for t in (out[:2] if mode == "ao_fg" else out[:1])))


@pytest.mark.parametrize("ray_set", ["camera", "secondary"])
@pytest.mark.parametrize("mode", MODES)
def test_matches_reference_kernel(scenes, rays, mode, ray_set):
    js, ts = scenes
    rs = rays[ray_set]
    ref = _reference(js, mode, rs)
    assert _hits(mode, ref) > 100, "the ray set must hit"
    _assert_exact(ref, _port(ts, mode, rs))


def _reference_caps(js, mode, rs, rounds, march_cap, micro_cap):
    """``_trace_pallas`` / ``_trace_pallas_ao_fg`` with every cap an
    argument: the reference's single-instance kernel rebuilt."""
    o, d, tn, ta, _ = rs
    n = o.shape[0]
    dlen = np.asarray(jnp.maximum(jnp.linalg.norm(jnp.asarray(d), axis=-1),
                                  1e-20))
    dn = np.asarray(jnp.asarray(d) / jnp.asarray(dlen)[:, None])
    pad = (-n) % (pt.ROWS * pt.LANES)

    def prep(x, fill=0.0):
        x = np.concatenate([np.asarray(x, np.float32),
                            np.full((pad,), fill, np.float32)])
        return jnp.asarray(x.reshape(-1, pt.LANES))

    def s(t):
        return np.asarray(jnp.asarray(t, jnp.float32) * jnp.asarray(dlen))

    fused = mode == "ao_fg"
    tab = _ref_tables(js)
    rays_in = [prep(o[:, 0]), prep(o[:, 1]), prep(o[:, 2]),
               prep(dn[:, 0], 1.0), prep(dn[:, 1], 1.0), prep(dn[:, 2], 1.0),
               prep(s(tn))]
    if fused:
        rays_in.append(prep(s(ta), -1.0))
    rays_in.append(prep(s(_t_max(mode, rs)), -1.0))
    kernel = pt._make_kernel(tab.mask_chunks, mode, rounds, march_cap,
                             micro_cap)
    rows = (n + pad) // pt.LANES
    tspec = pl.BlockSpec(memory_space=pltpu.VMEM)
    rspec = pl.BlockSpec((pt.ROWS, pt.LANES), lambda g: (g, 0),
                         memory_space=pltpu.VMEM)
    kinds = ([jnp.float32, jnp.float32, jnp.int32] if fused
             else [jnp.float32, jnp.int32, jnp.int32])
    out = pl.pallas_call(
        kernel, grid=(rows // pt.ROWS,),
        in_specs=[tspec] * 7 + [rspec] * len(rays_in),
        out_specs=[rspec] * 3,
        out_shape=[jax.ShapeDtypeStruct((rows, pt.LANES), k) for k in kinds],
        interpret=True)(tab.l1, tab.l2_w0, tab.l2_w1, tab.l2_r0, tab.l2_r1,
                        tab.mask_lo, tab.mask_hi, *rays_in)
    out = [np.asarray(x).reshape(-1)[:n] for x in out]
    for k in ((0, 1) if fused else (0,)):
        out[k] = np.asarray(jnp.asarray(out[k]) / jnp.asarray(dlen))
    return out


# (caps of the reference kernel, the port's rounds and patched caps)
_CAPS = {
    "rounds": dict(rounds=2, march_cap=160, micro_cap=12),
    "march": dict(rounds=4, march_cap=2, micro_cap=12),
    "micro": dict(rounds=64, march_cap=160, micro_cap=4),
}


@pytest.mark.parametrize("mode", ["precise", "ao_fg"])
@pytest.mark.parametrize("cap", sorted(_CAPS))
def test_iteration_caps_bind_like_reference(scenes, rays, monkeypatch, cap,
                                            mode):
    js, ts = scenes
    caps = _CAPS[cap]
    rs = tuple(np.concatenate([a, b]) for a, b in
               zip(rays["camera"], rays["secondary"]))
    ref = _reference_caps(js, mode, rs, **caps)
    free = _port(ts, mode, rs)
    monkeypatch.setattr(hdda, "MARCH_CAP", caps["march_cap"])
    monkeypatch.setattr(hdda, "MICRO_CAP", caps["micro_cap"])
    got = _port(ts, mode, rs, rounds=caps["rounds"])
    _assert_exact(ref, got)
    changed = np.zeros(len(rs[0]), bool)
    for a, b in zip(free, got):
        changed |= a != b
    assert changed.sum() >= 5, f"the {cap} cap did not bind"


def test_rounds_argument_matches_reference(scenes, rays):
    """``rounds`` reaches the walk through the public entry points."""
    js, ts = scenes
    rs = rays["secondary"]
    for mode in ("rough", "ao_threshold"):
        _assert_exact(_reference(js, mode, rs, rounds=1),
                      _port(ts, mode, rs, rounds=1))


def test_mask_padding_changes_nothing(scenes, rays):
    """Leaf rows past the model's own (the scene's padded mask chunks)
    are never read: garbage there gives the same results."""
    _, ts = scenes
    tab = hdda._instance_tables(ts, 0)
    rng = np.random.default_rng(1)
    junk = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, size=(3 * 1024, 2),
                                        dtype=np.int64).astype(np.int32))
    padded = hdda.HDDATables(l1=tab.l1, l2=tab.l2,
                             mask=torch.cat([tab.mask, junk]).contiguous())
    rs = rays["secondary"]
    for mode in MODES:
        a = _port(ts, mode, rs)
        b = _port(ts, mode, rs, tables=padded)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def five():
    js = build_device_scene(five_teapots_vox())
    return js, port_scene(js)


def _world_rays(n, seed, target=(0.0, 0.0, 0.0)):
    """Seeded world rays aimed near ``target``, unnormalised, an eighth
    of them with one zero direction component."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-300.0, 700.0, size=(n, 3)).astype(np.float32)
    aim = np.asarray(target) + rng.uniform(-40.0, 40.0, size=(n, 3))
    d = (aim - o) * rng.uniform(0.001, 3.0, size=(n, 1))
    d[: n // 8, rng.integers(0, 3)] = 0.0
    return o, d.astype(np.float32)


@pytest.mark.parametrize("inst", range(5))
def test_instance_ray_setup_bit_for_bit(five, inst):
    """The loop route's affine applies and model-AABB clip against the
    reference's (``pallas_trace._xform_point``/``_xform_dir``,
    ``traverse.clip_to_model_aabb``), on every instance of the
    five-teapot scene."""
    js, ts = five
    o, d = _world_rays(4096, inst, np.asarray(js.obj_to_world)[inst, :, 3])
    tn = np.full(len(o), 0.1, np.float32)
    tx = np.random.default_rng(inst).uniform(1.0, 2000.0, len(o)).astype(
        np.float32)
    w2o = js.world_to_obj[inst]
    jo = pt._xform_point(w2o, jnp.asarray(o))
    jd = pt._xform_dir(w2o, jnp.asarray(d))
    m = js.inst_model[inst]
    jtn, jtx = jtraverse.clip_to_model_aabb(js, m, jo, jd, jnp.asarray(tn),
                                            jnp.asarray(tx))
    tw2o = ts.world_to_obj[inst]
    to = ttraverse.xform_point(tw2o, tensor(o))
    td = ttraverse.xform_dir(tw2o, tensor(d))
    ttn, ttx = ttraverse.clip_to_model_aabb(ts, m, to, td, tensor(tn),
                                            tensor(tx))
    for a, b in ((jo, to), (jd, td), (jtn, ttn), (jtx, ttx)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (np.asarray(jtn) < np.asarray(jtx)).sum() > 50, "rays must hit the box"


def test_direction_length_bit_for_bit():
    """|d| as the reference's ``jnp.linalg.norm`` rounds it."""
    _, d = _world_rays(65536, 9)
    ref = np.asarray(jnp.maximum(jnp.linalg.norm(jnp.asarray(d), axis=-1),
                                 1e-20))
    np.testing.assert_array_equal(ttraverse.dir_length(tensor(d)).numpy(), ref)


def _tiny(n=4, **over):
    args = dict(l1=torch.zeros(512, dtype=torch.int32),
                l2=torch.zeros((4096, 4), dtype=torch.int32),
                mask=torch.zeros((1024, 2), dtype=torch.int32),
                origin=torch.zeros((n, 3)),
                direction=torch.tensor([[1.0, 0.0, 0.0]]).expand(n, 3)
                .contiguous(),
                s_min=torch.zeros(n), s_stop=torch.full((n,), 10.0))
    args.update(over)
    return args


@pytest.mark.parametrize("bad, error", [
    (dict(origin=torch.zeros((4, 3), dtype=torch.float64)), TypeError),
    (dict(s_stop=torch.zeros(5)), ValueError),
    (dict(direction=torch.ones((3, 4)).t()), ValueError),
    (dict(l1=torch.zeros((1, 512), dtype=torch.int32)), ValueError),
    (dict(mask=torch.zeros((1024, 3), dtype=torch.int32)), ValueError),
])
def test_instance_wrapper_checks_its_inputs(bad, error):
    with pytest.raises(error):
        hdda.hdda_instance(**_tiny(**bad), mode="precise")


def test_instance_wrapper_modes():
    with pytest.raises(ValueError):
        hdda.hdda_instance(**_tiny(), mode="fast")
    with pytest.raises(ValueError):
        hdda.hdda_instance(**_tiny(), mode="ao_fg")        # needs s_ao
    with pytest.raises(ValueError):
        hdda.hdda_instance(**_tiny(), rounds=-1)
    before = dict(hdda.INSTANCE_LAUNCHES)
    s, row, bit = hdda.hdda_instance(**_tiny(), mode="rough")
    assert bool(torch.isinf(s).all()) and bool((row == -1).all())
    assert bool((bit == -1).all())
    assert hdda.INSTANCE_LAUNCHES == before          # CPU: plain version
