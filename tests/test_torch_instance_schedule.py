"""The single-instance kernel's range test, on the CPU.

The kernel (``csrc/hdda.cu``) reads a ray's ``s_min`` and ``s_stop``
first and gives a ray with ``s_min >= s_stop`` the miss outputs without
reading anything else of it. These tests hold the plain version, which the
kernel is held to on the card, to that contract: such a lane misses
whatever its origin, direction and ``s_ao`` hold, as in the reference's
``trace_instance_pallas`` / ``trace_instance_pallas_ao_fg`` (Pallas in
interpret mode). They also check ``chip_smoke.py``'s byte count of an
instance launch, which counts what each ray needs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dust_tpu.ops import pallas_trace as pt
from dust_tpu.render.scene import build_device_scene
from dust_tpu_torch.ops import hdda
from tests.torch_parity import camera_rays, port_scene, teapot_vox, tensor
from torch_card import chip_smoke

MODES = ("precise", "ao_threshold", "rough", "ao_fg")
ODD = (float("nan"), float("inf"), -float("inf"), 1e30, -1e30, 0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small shapes: torch on one thread, so that idle OpenMP workers do
    not contend with other test processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    js = build_device_scene(teapot_vox())
    return js, port_scene(js)


def _object_rays(js, n):
    """``n`` of the teapot's camera rays in the instance's object space."""
    o, d = camera_rays(32, 16)
    w2o = np.asarray(js.world_to_obj)[0]
    pick = np.random.default_rng(3).permutation(len(o))[:n]
    oo = (o[pick] @ w2o[:, :3].T + w2o[:, 3]).astype(np.float32)
    do = (d[pick] @ w2o[:, :3].T).astype(np.float32)
    return oo, do


def _empty_lanes(n, rng):
    """``n`` lanes with s_stop <= s_min (equal on every fourth), the bounds
    themselves finite, infinite or 1e30, and origins, directions and s_ao
    drawn from NaN, +-inf, +-1e30 and 0."""
    odd = np.asarray(ODD, np.float32)
    o = rng.choice(odd, (n, 3)).astype(np.float32)
    d = rng.choice(odd, (n, 3)).astype(np.float32)
    s_min = rng.choice(np.asarray([0.0, 5.0, 1e30, np.inf], np.float32), n)
    step = rng.choice(np.asarray([1.0, 1e30, np.inf], np.float32), n)
    inf_min = np.isinf(s_min)
    below = np.where(inf_min, -np.inf, s_min - np.where(inf_min, 0, step))
    s_stop = np.where(np.arange(n) % 4 == 0, s_min, below)
    s_ao = rng.choice(odd, n).astype(np.float32)
    return o, d, s_min.astype(np.float32), s_stop.astype(np.float32), s_ao


@pytest.mark.parametrize("mode", MODES)
def test_plain_misses_on_empty_ranges(scenes, mode):
    """Empty-range lanes give (inf, -1, -1), or (inf, inf, -1) in ao_fg,
    whatever else they hold; the active lanes beside them walk as they
    do alone."""
    js, ts = scenes
    rng = np.random.default_rng(11)
    o, d, s_min, s_stop, s_ao = _empty_lanes(48, rng)
    ao, ad = _object_rays(js, 16)
    ad = ad / np.linalg.norm(ad, axis=1, keepdims=True)
    o, d = np.concatenate([o, ao]), np.concatenate([d, ad]).astype(np.float32)
    s_min = np.concatenate([s_min, np.full(16, 0.1, np.float32)])
    s_stop = np.concatenate([s_stop, np.full(16, 1e4, np.float32)])
    s_ao = np.concatenate([s_ao, np.full(16, 8.0, np.float32)])
    tab = hdda._instance_tables(ts, 0)
    args = [tensor(x) for x in (o, d, s_min, s_stop)]
    fused = mode == "ao_fg"
    out = hdda.hdda_instance_plain(*tab, *args, tensor(s_ao) if fused
                                   else None, mode)
    alone = hdda.hdda_instance_plain(*tab, *(a[48:] for a in args),
                                     tensor(s_ao[48:]) if fused else None,
                                     mode)
    floats = out[:2] if fused else out[:1]
    for t in floats:
        assert bool(torch.isinf(t[:48]).all()) and bool((t[:48] > 0).all())
    for ids in out[len(floats):]:
        assert bool((ids[:48] == -1).all())
    for a, b in zip(out, alone):
        assert torch.equal(a[48:], b)
    assert int(torch.isfinite(out[0][48:]).sum()
               + (torch.isfinite(out[1][48:]).sum() if fused else 0)) > 0


@pytest.mark.parametrize("mode", MODES)
def test_empty_ranges_match_reference(scenes, mode):
    """A few dozen lanes with t_max <= t_min and odd origins and t_ao,
    beside a few that walk: the port's single-instance trace equals the
    reference's Pallas kernel (interpret mode) on every lane."""
    js, ts = scenes
    rng = np.random.default_rng(5)
    n_empty = 40
    odd = np.asarray(ODD, np.float32)
    o_e = rng.choice(odd, (n_empty, 3)).astype(np.float32)
    _, d_e = _object_rays(js, n_empty)
    t_min_e = rng.choice(np.asarray([0.1, 7.0, 1e30], np.float32), n_empty)
    t_max_e = np.where(np.arange(n_empty) % 4 == 0, t_min_e,
                       t_min_e - rng.choice(np.asarray([0.05, 1e30],
                                                       np.float32), n_empty))
    t_ao_e = rng.choice(odd, n_empty)
    o_a, d_a = _object_rays(js, 8)
    o = np.concatenate([o_e, o_a])
    d = np.concatenate([d_e, d_a])
    t_min = np.concatenate([t_min_e, np.full(8, 0.1)]).astype(np.float32)
    t_max = np.concatenate([t_max_e, np.full(8, 1e4)]).astype(np.float32)
    t_ao = np.concatenate([t_ao_e, np.full(8, 8.0)]).astype(np.float32)
    ref_tab = pt.PallasTables(
        l1=js.pl_l1[0], l2_w0=js.pl_l2w0[0], l2_w1=js.pl_l2w1[0],
        l2_r0=js.pl_l2r0[0], l2_r1=js.pl_l2r1[0], mask_lo=js.pl_mlo[0],
        mask_hi=js.pl_mhi[0])
    tab = hdda._instance_tables(ts, 0)
    if mode == "ao_fg":
        ref = pt.trace_instance_pallas_ao_fg(
            ref_tab, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
            jnp.asarray(t_ao), jnp.asarray(t_max), interpret=True)
        got = hdda.trace_instance_ao_fg(tab, tensor(o), tensor(d),
                                        tensor(t_min), tensor(t_ao),
                                        tensor(t_max))
    else:
        ref = pt.trace_instance_pallas(
            ref_tab, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
            jnp.asarray(t_max), mode=mode, interpret=True)
        got = hdda.trace_instance(tab, tensor(o), tensor(d), tensor(t_min),
                                  tensor(t_max), mode=mode)
    for a, b in zip(ref, got):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            assert np.isinf(b[:n_empty]).all() and (b[:n_empty] > 0).all()
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-5)
        else:
            np.testing.assert_array_equal(b, a)
            assert (b[:n_empty] == -1).all()


@pytest.mark.parametrize("mode", MODES)
def test_chip_smoke_instance_bytes(mode):
    """A hand-made launch of 1000 rays, 137 of them active (NaN bounds
    among them): 20 B a ray, plus 24 B an active ray (28 in ao_fg)."""
    smoke = chip_smoke()
    n, active = 1000, 137
    s_min = torch.full((n,), 5.0)
    s_stop = torch.full((n,), 1.0)
    s_stop[::3] = 5.0                       # equal bounds: inactive
    live = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    live = live[:active]
    s_stop[live] = 9.0
    s_min[live[:5]] = float("nan")           # NaN walks: active
    nan_dir = torch.full((n, 3), float("nan"))
    args = (torch.zeros(512, dtype=torch.int32),
            torch.zeros((4096, 4), dtype=torch.int32),
            torch.zeros((1024, 2), dtype=torch.int32), nan_dir, nan_dir,
            s_min, s_stop, torch.zeros(n) if mode == "ao_fg" else None)
    nbytes, got_active = smoke._instance_bytes(args, mode)
    per_active = 28 if mode == "ao_fg" else 24
    assert got_active == active
    assert nbytes == n * 20 + active * per_active
    ms, by = smoke._instance_bound(args, mode)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12, rel=1e-12)
