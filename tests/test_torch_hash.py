"""The spatial-hash GI cache of the port against the reference's, on the
same numpy inputs: the key hashes, the LogLuv radiance word, hash_get and
hash_insert, the working-set packing, the surfel-pool enqueue and the
leaf attributes of rough and precise hits.

The reference runs under ``jax.jit``, as it does inside its frame (XLA
then contracts some products into fused multiply-adds, which the port
writes out). Tolerances:

* key hashes, fingerprints, locations, pool enqueue and working-set rows:
  bit for bit;
* ``encode_logluv``: u and v codes exact; the 14-bit log-luminance code
  within one step, on at most 1e-4 of the words (the reference's float32
  ``log`` is XLA's own and rounds some arguments one ulp away from
  PyTorch's, which moves a code that sits at a truncation boundary);
* ``decode_logluv``: within 1e-6 of each colour's largest component
  (XLA's ``exp`` against PyTorch's, a few ulps);
* tables after ``hash_insert``: every word of every slot equal, fields
  and LogLuv codes alike (the segmented sums add in the reference's
  order, and on these cases the running mean and the decode of the old
  radiance round as the reference's); ``hash_get`` radiance within 1e-6
  of the largest, as the decode;
* leaf centres, keys, faces, leaf-box normals and average albedos:
  bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dust_tpu.ops import gi_cache as jgi
from dust_tpu.ops import packing as jpk
from dust_tpu.ops import shade as jshade
from dust_tpu.ops import spatial_hash as jsh
from dust_tpu.ops.traverse import TraceResult as JTrace
from dust_tpu.render import pipeline as jpipe
from dust_tpu.render.scene import build_device_scene
from dust_tpu_torch.ops import gi_cache as tgi
from dust_tpu_torch.ops import packing as tpk
from dust_tpu_torch.ops import shade as tshade
from dust_tpu_torch.ops import spatial_hash as tsh
from dust_tpu_torch.ops.hdda import trace_scene
from dust_tpu_torch.render import pipeline as tpipe
from tests.torch_parity import (camera_rays, port_scene, secondary_rays,
                                teapot_vox, tensor)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread here: at these sizes threads buy
    little, and idle OpenMP workers would contend with other test
    processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u32(a):
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def _keys(n, seed, lo=-40, hi=40):
    rng = np.random.default_rng(seed)
    qpos = rng.integers(lo, hi, size=(n, 3)).astype(np.int32)
    face = rng.integers(0, 6, size=n).astype(np.int32)
    return qpos, face


# ---------------------------------------------------------------- hashes

def _wide_keys():
    """Small keys, negative ones included, and keys over all of int32."""
    q1, f1 = _keys(4096, 0)
    q2, f2 = _keys(4096, 1, -2**31, 2**31 - 1)
    return np.concatenate([q1, q2]), np.concatenate([f1, f2])


@pytest.mark.parametrize("name", ["_pcg", "_xxhash32"])
def test_word_hashes_bit_exact(name):
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, size=8192, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 1, 2**31, 2**32 - 1]
    ref = jax.jit(getattr(jsh, name))(jnp.asarray(w))
    got = getattr(tsh, name)(torch.as_tensor(w.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _u32(ref))


@pytest.mark.parametrize("capacity", [None, 1 << 12, 1 << 25])
def test_key_hashes_bit_exact(capacity):
    q, f = _wide_keys()
    if capacity is None:
        ref = jax.jit(jsh.key_fingerprint)(q, f)
        got = tsh.key_fingerprint(torch.as_tensor(q), torch.as_tensor(f))
        assert (got.numpy() >= 1).all()
    else:
        ref = jax.jit(functools.partial(jsh.key_location,
                                        capacity=capacity))(q, f)
        got = tsh.key_location(torch.as_tensor(q), torch.as_tensor(f),
                               capacity)
        assert (got.numpy() % 4 == 0).all()
    np.testing.assert_array_equal(got.numpy(), _u32(ref))


def test_spatial_hash_key():
    rng = np.random.default_rng(4)
    pos = rng.uniform(-300, 300, size=(4096, 3)).astype(np.float32)
    face = rng.integers(0, 6, size=4096).astype(np.int32)
    jq, jf = jsh.spatial_hash_key(jnp.asarray(pos), jnp.asarray(face))
    tq, tf = tsh.spatial_hash_key(tensor(pos), torch.as_tensor(face))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


# ---------------------------------------------------------------- LogLuv

def _radiance(n, seed):
    rng = np.random.default_rng(seed)
    c = (np.abs(rng.normal(size=(n, 3)))
         * np.exp(rng.normal(size=(n, 1)) * 3)).astype(np.float32)
    c[:64] = 0.0
    c[64:128, 1] = -1.0
    return c


def test_encode_logluv():
    c = _radiance(65536, 5)
    ref = _u32(jax.jit(jpk.encode_logluv)(c))
    got = tpk.encode_logluv(tensor(c)).numpy()
    assert (((got >> 9) & 511) == ((ref >> 9) & 511)).all()
    assert ((got & 511) == (ref & 511)).all()
    dl = (got >> 18) - (ref >> 18)
    assert np.abs(dl).max() <= 1
    assert (dl != 0).mean() <= 1e-4, (dl != 0).mean()


def test_decode_logluv():
    rng = np.random.default_rng(6)
    w = np.concatenate([
        rng.integers(0, 2**32, size=32768, dtype=np.uint64).astype(np.uint32),
        np.asarray(jax.jit(jpk.encode_logluv)(_radiance(32768, 7)))])
    ref = np.asarray(jax.jit(jpk.decode_logluv)(w))
    got = tpk.decode_logluv(torch.as_tensor(w.view(np.int32))).numpy()
    assert np.isfinite(got).all()
    scale = np.maximum(np.abs(ref).max(axis=-1, keepdims=True), 1e-30)
    assert (np.abs(got - ref) / scale).max() <= 1e-6
    np.testing.assert_array_equal(got == 0.0, ref == 0.0)


# ---------------------------------------------------------------- get/insert

_insert_ref = jax.jit(jsh.hash_insert, static_argnames=("max_updates",))
_get_ref = jax.jit(jsh.hash_get)


def _group_keys(capacity, count, seed=0):
    """``count`` distinct keys whose probe walks share one group."""
    rng = np.random.default_rng(seed)
    q, f = _keys(20000, seed, -1000, 1000)
    loc = np.asarray(tsh.key_location(torch.as_tensor(q), torch.as_tensor(f),
                                      capacity))
    fp = np.asarray(tsh.key_fingerprint(torch.as_tensor(q),
                                        torch.as_tensor(f)))
    for g in rng.permutation(np.unique(loc)):
        idx = np.flatnonzero(loc == g)
        idx = idx[np.unique(fp[idx], return_index=True)[1]]
        if len(idx) >= count:
            return q[idx[:count]], f[idx[:count]]
    raise AssertionError("no group holds enough keys")


def _case(name):
    """(capacity, [(qpos, face, value, frame, valid, max_updates), ...])
    of one case; the inserts apply in order."""
    rng = np.random.default_rng(11)
    one = np.zeros((1, 3), np.int32), np.zeros(1, np.int32)
    if name == "insert_then_get":
        q, f = _keys(64, 0)
        v = np.abs(rng.normal(size=(64, 3))).astype(np.float32) + 0.1
        return 4096, [(q, f, v, 1, None, None)]
    if name == "running_mean":
        return 1024, [(*one, np.full((1, 3), 1.0, np.float32), 1, None, None),
                      (*one, np.full((1, 3), 3.0, np.float32), 2, None, None)]
    if name == "batch_duplicates":
        q, f = np.zeros((8, 3), np.int32), np.zeros(8, np.int32)
        v = np.abs(rng.normal(size=(8, 3))).astype(np.float32)
        return 1024, [(q, f, v, 1, None, None), (q, f, v[::-1], 2, None, None)]
    if name == "valid_mask":
        q, f = _keys(4, 2)
        return 512, [(q, f, np.ones((4, 3), np.float32), 1,
                      np.array([True, False, True, False]), None)]
    if name == "sample_count_cap":
        q, f = np.zeros((600, 3), np.int32), np.zeros(600, np.int32)
        v = np.abs(rng.normal(size=(600, 3))).astype(np.float32)
        return 128, [(q, f, v, 1, None, None), (q[:5], f[:5], v[:5], 2, None,
                                                None)]
    if name == "max_updates_binds":
        q, f = _keys(2000, 3, -20, 20)
        v = np.abs(rng.normal(size=(2000, 3))).astype(np.float32)
        ok = rng.random(2000) < 0.8
        return 4096, [(q, f, v, 1, ok, 100), (q, f, v * 2, 2, ok, 100)]
    if name == "three_keys_share_a_group":
        # Four keys of one group: inserted together only the first
        # fingerprint applies; one by one they fill the three probes,
        # and the fourth evicts the least recently inserted.
        q, f = _group_keys(256, 4)
        v = np.abs(rng.normal(size=(4, 3))).astype(np.float32) + 0.1
        steps = [(q, f, v, 1, None, None)]
        steps += [(q[i:i + 1], f[i:i + 1], v[i:i + 1], 2 + i, None, None)
                  for i in range(4)]
        steps += [(q[1:2], f[1:2], v[1:2], 7, None, None)]
        return 256, steps
    raise ValueError(name)


CASES = ["insert_then_get", "running_mean", "batch_duplicates", "valid_mask",
         "sample_count_cap", "max_updates_binds", "three_keys_share_a_group"]


@pytest.mark.parametrize("name", CASES)
def test_insert_and_get_match_reference(name):
    """The whole table after each insert, and hash_get of every inserted
    key, against the reference."""
    capacity, steps = _case(name)
    jh = jsh.make_spatial_hash(capacity)
    th = tsh.make_spatial_hash(capacity, "cpu")
    for q, f, v, frame, ok, mu in steps:
        jok = None if ok is None else jnp.asarray(ok)
        tok = None if ok is None else torch.as_tensor(ok)
        jh = _insert_ref(jh, q, f, v, frame, valid=jok, max_updates=mu)
        th = tsh.hash_insert(th, torch.as_tensor(q), torch.as_tensor(f),
                             tensor(v), frame, valid=tok, max_updates=mu)
        np.testing.assert_array_equal(th.table.numpy(), np.asarray(jh.table))
        jfound, jrad, jcnt = _get_ref(jh, q, f)
        tfound, trad, tcnt = tsh.hash_get(th, torch.as_tensor(q),
                                          torch.as_tensor(f))
        np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
        scale = np.maximum(np.abs(np.asarray(jrad)).max(), 1e-30)
        assert np.abs(trad.numpy() - np.asarray(jrad)).max() <= 1e-6 * scale
    occupied = (th.table.numpy().reshape(-1, 4)[:, 0] != 0).sum()
    assert occupied >= 1
    if name == "sample_count_cap":
        assert int(th.table[:, 3::4].max()) == tsh.MAX_SAMPLE_COUNT
    if name == "max_updates_binds":
        # The same 100 groups, first in group order, apply both times.
        assert occupied == 100
    if name == "three_keys_share_a_group":
        assert occupied == 3


def test_get_missing():
    q, f = _keys(16, 9)
    found, rad, cnt = tsh.hash_get(tsh.make_spatial_hash(256, "cpu"),
                                   torch.as_tensor(q), torch.as_tensor(f))
    assert not found.any() and (rad == 0).all() and (cnt == 0).all()


# ---------------------------------------------------------------- frame parts

@pytest.fixture(scope="module")
def teapot():
    js = build_device_scene(teapot_vox())
    return js, port_scene(js)


def test_pack_working_set_bit_exact(teapot):
    js, ts = teapot
    rows = jgi.dense_rows(js)
    rng = np.random.default_rng(12)
    rad = (np.abs(rng.normal(size=(rows, 3))) * 4).astype(np.float32)
    rad[:10] = 70000.0        # past float16's range
    cnt = rng.integers(-3, 500, size=rows).astype(np.int32)
    ref = jax.jit(lambda r, c: jgi.pack_working_set(r, c, js).table)(rad, cnt)
    got = tgi.pack_working_set(tensor(rad), torch.as_tensor(cnt), ts).table
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    alb = rng.integers(-2**31, 2**31 - 1, size=(100, 1)).astype(np.int32)
    ref = jgi.pack_working_set_rows(jnp.asarray(rad[:100]),
                                    jnp.asarray(cnt[:100]), jnp.asarray(alb))
    got = tgi.pack_working_set_rows(tensor(rad[:100]),
                                    torch.as_tensor(cnt[:100]),
                                    torch.as_tensor(alb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n, size", [(4096, 1024), (5000, 1024), (700, 1024)])
def test_pool_enqueue_exact(n, size):
    rng = np.random.default_rng(n)
    dest = rng.normal(size=(size, 4)).astype(np.float32)
    mask = rng.random(n) < 0.3
    vals = rng.normal(size=(n, 4)).astype(np.float32)
    ref = jpipe._pool_enqueue_mod(jnp.asarray(dest), jnp.asarray(mask),
                                  jnp.asarray(vals))
    got = tpipe._pool_enqueue_mod(tensor(dest), torch.as_tensor(mask),
                                  tensor(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _hits(ts, mode, n=4096):
    """Camera hits (precise) or seeded secondary rays from them (rough),
    traced by the port's plain HDDA: (origin, direction, port result,
    reference result)."""
    o, d = camera_rays(96, 64)
    prim = trace_scene(ts, tensor(o), tensor(d), 0.1, 10000.0, "precise")
    if mode == "rough":
        o, d = secondary_rays(o, d, prim.t.numpy(), prim.hit.numpy(), n, 13)
        prim = trace_scene(ts, tensor(o), tensor(d), 0.1, 10000.0, "rough")
    assert int(prim.hit.sum()) > 500
    ref = JTrace(*(jnp.asarray(x.numpy()) for x in prim))
    return o, d, prim, ref


def test_entry_leaf_center_rough_hits(teapot):
    js, ts = teapot
    o, d, tr, jr = _hits(ts, "rough")
    ref = jax.jit(lambda r, a, b: jshade.entry_leaf_center(js, r, a, b))(
        jr, o, d)
    got = tshade.entry_leaf_center(ts, tr, tensor(o), tensor(d))
    hit = tr.hit.numpy()
    np.testing.assert_array_equal(got.numpy()[hit], np.asarray(ref)[hit])


@pytest.mark.parametrize("mode", ["precise", "rough"])
def test_leaf_attributes(teapot, mode):
    js, ts = teapot
    o, d, tr, jr = _hits(ts, mode)
    ref = jax.jit(lambda r, a, b: jshade.leaf_attributes(js, r, a, b))(
        jr, o, d)
    got = tshade.leaf_attributes(ts, tr, tensor(o), tensor(d))
    hit = tr.hit.numpy()
    assert sorted(got) == sorted(ref)
    for k in ("hit", "qpos", "face", "center_world", "aabb_normal",
              "avg_albedo"):
        np.testing.assert_array_equal(got[k].numpy()[hit],
                                      np.asarray(ref[k])[hit], err_msg=k)
