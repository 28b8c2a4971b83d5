"""The inputs the benchmark makes: the scene bytes give the port the
castle and the teapot of its bench, the blue noise is the port's own,
and the edit stream is a function of the seed."""

import numpy as np
import pytest
import torch

from benchmark import inputs, spec
from conftest import load_cell


@pytest.fixture(scope="module")
def config():
    return load_cell("dense-edits-1080p").config


def test_scene_bytes_are_the_bench_scene(config):
    from dust_tpu_torch.vox import procgen
    from dust_tpu_torch.vox.loader import load_vox_scene

    got = load_vox_scene(inputs.scene_bytes(config))
    want = load_vox_scene(procgen.castle_scene_bytes())
    procgen.add_teapot(want)
    assert sorted(got.geometries) == sorted(want.geometries) == [0, 1]
    for m in want.geometries:
        a, b = got.geometries[m].flat, want.geometries[m].flat
        assert np.array_equal(a.leaf_origin, b.leaf_origin)
        assert np.array_equal(a.mask_lo, b.mask_lo)
        assert np.array_equal(got.geometries[m].materials,
                              want.geometries[m].materials)
    assert [i.model_id for i in got.instances] == [0, 1]
    for a, b in zip(got.instances, want.instances):
        assert np.array_equal(a.transform, b.transform)
    assert np.array_equal(got.palette, want.palette)


def test_blue_noise_is_the_ports():
    from dust_tpu_torch.ops.noise import load_blue_noise

    bn = load_blue_noise(torch.device("cpu"))
    cos, scalar = inputs.blue_noise_tables()
    assert torch.equal(torch.as_tensor(cos), bn.unitvec3_cosine)
    assert torch.equal(torch.as_tensor(scalar), bn.scalar)


def _stream(config, traffic, seed, frames=40, blocks=6):
    s = inputs.EditStream(config, traffic, seed)
    return ([s.brush_edit(f) for f in range(frames)],
            [s.block_edit() for _ in range(blocks)])


def test_edit_stream_follows_the_seed(config):
    traffic = load_cell("dense-edits-1080p").traffic
    a = _stream(config, traffic, 2**31 + 77)
    assert a == _stream(config, traffic, 2**31 + 77)
    names = [m["name"] for m in config["scene"]["models"]]
    assert {e.model for e in a[0] + a[1]} == {
        names.index(traffic["edits"]["model_name"])}
    assert a != _stream(config, traffic, 2**31 + 78)
    coords, _ = inputs.model_voxels(config, "castle")
    have = {tuple(c) for c in coords.tolist()}
    leaves = {tuple(c >> 2) for c in coords}
    for e in a[0]:
        assert e.coord in have and 1 <= e.palette <= 255 and not e.splice
    for e in a[1]:
        assert tuple(np.asarray(e.coord) >> 2) not in leaves and e.splice
        assert e.coord[1] == traffic["edits"]["splice_y"]


def test_path_follows_the_seed():
    traffic = spec.load_cell("dense-orbit-1080p").traffic
    a, b = inputs.Motion(traffic, 5), inputs.Motion(traffic, 6)
    assert a.eye(3) == inputs.Motion(traffic, 5).eye(3) != b.eye(3)
    # The orbit keeps the bench camera's radius and height.
    r = np.hypot(inputs.EYE[0], inputs.EYE[2])
    x, y, z = a.eye(17)
    assert np.hypot(x, z) == pytest.approx(r) and y == inputs.EYE[1]
