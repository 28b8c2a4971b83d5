"""The reference's plain walk, which stops stepping lanes that are done,
gives every output of the port's plain walk bit for bit, in every
mode."""

import pytest
import torch

from benchmark import inputs, spec


@pytest.fixture(scope="module")
def scene():
    from dust_tpu_torch.render.scene import build_device_scene
    from dust_tpu_torch.vox.loader import load_vox_scene

    config = spec.load_cell("dense-orbit-1080p").config
    return build_device_scene(load_vox_scene(inputs.scene_bytes(config)),
                              torch.device("cpu"))


@pytest.mark.parametrize("mode", ["precise", "ao_threshold", "rough", "ao_fg"])
def test_walk_equals_the_ports(scene, mode):
    from dust_tpu_torch.ops import hdda as port
    from benchmark.reference.ops import hdda as ref

    g = torch.Generator().manual_seed(1234)
    n = 6000
    origin = torch.rand(n, 3, generator=g) * 400.0 - 200.0
    origin[:, 1] = origin[:, 1].abs() + 20.0
    target = torch.rand(n, 3, generator=g) * 200.0 - 100.0
    target[:, 1] = torch.rand(n, generator=g) * 60.0
    direction = target - origin
    # Some grazing rays, nearly parallel to an axis, walk far.
    direction[::7, 1] = 1e-4
    t_min = torch.full((n,), 0.1)
    t_max = torch.where(torch.rand(n, generator=g) < 0.9, 3.0, -1.0)
    t_ao = torch.full((n,), 0.6)
    args = port._scene_args(scene, origin)
    want = port.hdda_plain(scene.hdda_l1, scene.hdda_l2, scene.hdda_mask,
                           *args, origin, direction, t_min, t_max,
                           t_ao if mode == "ao_fg" else None, mode)
    got = ref.hdda_plain(scene.hdda_l1, scene.hdda_l2, scene.hdda_mask,
                         *ref._scene_args(scene), origin, direction, t_min,
                         t_max, t_ao if mode == "ao_fg" else None, mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
