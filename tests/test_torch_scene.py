"""The port's device scene against the reference's: every field the frame
reads, element for element; the flat HDDA tables against the (8, 128)-tiled
Pallas tables with the tiling undone; the carried-across scene."""

import dataclasses

import numpy as np
import pytest

from dust_tpu.ops.pallas_trace import build_pallas_tables
from dust_tpu.render import scene as jscene
from dust_tpu.vox import procgen
from dust_tpu.vox.loader import load_vox_scene
from dust_tpu_torch.ops import hdda
from dust_tpu_torch.render import scene as tscene
from tests.torch_parity import five_teapots_vox, scene_numpy, teapot_vox

SCENES = {"teapot": teapot_vox, "five_teapots": five_teapots_vox}
# Port field -> reference field, compared bit for bit.
SAME = {"cell_info": "cell_info", "mask_lo": "mask_lo", "mask_hi": "mask_hi",
        "leaf_origin": "leaf_origin", "avg_albedo": "avg_albedo",
        "model_aabb_min": "model_aabb_min",
        "model_aabb_max": "model_aabb_max", "voxel_attr": "voxel_attr",
        "obj_to_world": "obj_to_world", "world_to_obj": "world_to_obj",
        "prev_obj_to_world": "prev_obj_to_world"}
STATIC = {"inst_model": "inst_model", "hdda_chunks": "pl_chunks",
          "leaf_base": "leaf_base", "leaf_cap": "leaf_cap",
          "gi_cell_cap": "gi_cell_cap"}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _untile(js):
    """The reference's Pallas tables in the port's flat layout."""
    M = js.pl_l1.shape[0]
    l1 = np.asarray(js.pl_l1).reshape(M, 1024)[:, :512]
    l2 = np.stack([np.asarray(getattr(js, f)).reshape(M, 4096)
                   for f in ("pl_l2w0", "pl_l2w1", "pl_l2r0", "pl_l2r1")],
                  axis=-1)
    mask = np.stack([np.asarray(js.pl_mlo).reshape(M, -1),
                     np.asarray(js.pl_mhi).reshape(M, -1)], axis=-1)
    return l1, l2, mask


def _assert_scene_equal(ts, js):
    for port_name, ref_name in SAME.items():
        np.testing.assert_array_equal(
            getattr(ts, port_name).numpy(), _bits(getattr(js, ref_name)),
            err_msg=port_name)
    for port_name, ref_name in STATIC.items():
        assert tuple(getattr(ts, port_name)) == tuple(getattr(js, ref_name))
    l1, l2, mask = _untile(js)
    np.testing.assert_array_equal(ts.hdda_l1.numpy(), l1)
    np.testing.assert_array_equal(ts.hdda_l2.numpy(), l2)
    np.testing.assert_array_equal(ts.hdda_mask.numpy(), mask)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_matches_reference(name):
    vox = SCENES[name]()
    js = jscene.build_device_scene(vox)
    ts = tscene.build_device_scene(vox, "cpu")
    _assert_scene_equal(ts, js)
    assert ts.inst_leaf_base == js.inst_leaf_base
    assert ts.num_instances == js.num_instances
    assert ts.num_models == js.num_models


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_numpy_matches_build(name):
    vox = SCENES[name]()
    js = jscene.build_device_scene(vox)
    fields, meta = scene_numpy(js)
    carried = tscene.scene_from_numpy(fields, meta, "cpu")
    built = tscene.build_device_scene(vox, "cpu")
    for f in dataclasses.fields(built):
        a, b = getattr(carried, f.name), getattr(built, f.name)
        if isinstance(a, tuple):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f.name)


def test_hdda_tables_match_pallas_tables_on_the_castle():
    vox = load_vox_scene(procgen.castle_scene_bytes())
    flat = next(iter(vox.geometries.values())).flat
    ref = build_pallas_tables(flat)
    got = hdda.build_hdda_tables(flat)
    assert got.mask_chunks == ref.mask_chunks > 1
    np.testing.assert_array_equal(got.l1, ref.l1.reshape(-1)[:512])
    for k, name in enumerate(("l2_w0", "l2_w1", "l2_r0", "l2_r1")):
        np.testing.assert_array_equal(got.l2[:, k],
                                      getattr(ref, name).reshape(-1))
    np.testing.assert_array_equal(got.mask[:, 0], ref.mask_lo.reshape(-1))
    np.testing.assert_array_equal(got.mask[:, 1], ref.mask_hi.reshape(-1))


def test_hdda_tables_need_hierarchy_order():
    flat = teapot_vox().geometries[0].flat
    rows = np.arange(flat.num_leaves)[::-1]
    shuffled = dataclasses.replace(
        flat, leaf_origin=flat.leaf_origin[rows], mask_lo=flat.mask_lo[rows],
        mask_hi=flat.mask_hi[rows])
    with pytest.raises(ValueError):
        hdda.build_hdda_tables(shuffled)


def test_layouts_match_reference():
    vox = load_vox_scene(procgen.castle_scene_bytes())
    procgen.add_teapot(vox)
    geos = [vox.geometries[m] for m in sorted(vox.geometries)]
    assert tscene.leaf_layout(geos) == jscene.leaf_layout(geos)
    assert tscene.material_layout(geos) == jscene.material_layout(geos)
    for rows in (1000, 220_001, 300_000, 524_288, 600_000):
        assert (tscene.pad_rows_past_dead_zone(rows)
                == jscene.pad_rows_past_dead_zone(rows))


def test_with_transforms_matches_reference():
    import jax.numpy as jnp

    vox = teapot_vox()
    js = jscene.build_device_scene(vox)
    ts = tscene.build_device_scene(vox, "cpu")
    o2w = procgen.teapot_motion(np.asarray(js.obj_to_world), 0, 7)
    js2 = js.with_transforms(jnp.asarray(o2w))
    ts2 = ts.with_transforms(o2w)
    np.testing.assert_array_equal(ts2.obj_to_world.numpy(), o2w)
    np.testing.assert_array_equal(ts2.prev_obj_to_world.numpy(),
                                  np.asarray(js.obj_to_world))
    np.testing.assert_allclose(ts2.world_to_obj.numpy(),
                               np.asarray(js2.world_to_obj), rtol=1e-6,
                               atol=1e-5)
