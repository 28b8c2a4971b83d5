"""The frozen byte and operation count of the HDDA launches, against a
hand count."""

import types

import pytest

from benchmark import work


def test_two_passes_by_hand():
    # One model of 1,000 leaves, one instance. A precise pass of 100 rays
    # and a fused ao_fg pass of 50.
    tables = 512 * 4 + 4096 * 16 + 1000 * 8           # 75,584
    precise = 100 * (12 + 12 + 4 + 4) + 100 * 16 + tables
    ao_fg = 50 * (12 + 12 + 4 + 4 + 4) + 50 * (4 + 4 + 4 + 4 + 4) + tables
    assert work.launch_bytes("precise", 100, tables) == precise
    assert work.launch_bytes("ao_fg", 50, tables) == ao_fg
    least, by = work.least_time_s([("precise", 100), ("ao_fg", 50)], [1000], 1)
    # At these sizes the bytes bind: 61 operations a ray is far less.
    assert least == pytest.approx((precise + ao_fg) / 3.35e12)
    assert by == "bytes"


def test_operations_bind_with_many_instances():
    least, by = work.least_time_s([("rough", 1000)], [0], 10_000)
    assert least == pytest.approx(61 * 1000 * 10_000 / 67e12)
    assert by == "operations"


def test_frame_passes_follow_the_ray_accounting():
    from benchmark.reference.config import RenderSettings

    settings = RenderSettings(width=64, height=32, gi_cache="hash")
    scene = types.SimpleNamespace()
    passes = work.hdda_passes(scene, settings)
    n, pool = 64 * 32, settings.surfels.pool_size
    assert passes == [("precise", n), ("ao_fg", n), ("ao_threshold", n),
                      ("rough", n), ("rough", pool), ("rough", pool)]


# Each cell's frame on one card, as priced before meshes: (rays a
# full-resolution pass, rays a surfel pass). castle-dense's and
# castle-edits' scene refreshes its 179,334 valid cache rows; castle-hash
# its 720x480 pool.
ONE_CARD = {"dense-orbit-1080p": (2_073_600, 179_334),
            "dense-orbit-4k": (8_294_400, 179_334),
            "hash-orbit-1080p": (2_073_600, 345_600),
            "dense-edits-1080p": (2_073_600, 179_334)}


@pytest.fixture(scope="module")
def scenes():
    """The reference's scene of each configuration, by file (built once)."""
    import torch

    from benchmark import inputs
    from benchmark.reference.render import scene as ref_scene
    from benchmark.reference.vox import loader

    built = {}

    def scene(config):
        if config["name"] not in built:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                built[config["name"]] = ref_scene.build_device_scene(
                    loader.load_vox_scene(inputs.scene_bytes(config)),
                    torch.device("cpu"))
            finally:
                torch.set_num_threads(threads)
        return built[config["name"]]
    return scene


def _cell(workload):
    from benchmark import spec
    from benchmark.reference.config import RenderSettings

    cell = spec.load_cell(workload)
    return cell, spec.render_settings(RenderSettings, cell.config,
                                      cell.traffic)


@pytest.mark.parametrize("workload", sorted(ONE_CARD))
def test_one_card_passes_are_as_before(scenes, workload):
    """A cell on one card is priced as before meshes: six launches, the
    sun's one fused ao_fg."""
    cell, settings = _cell(workload)
    n, surfel = ONE_CARD[workload]
    assert work.hdda_passes(scenes(cell.config), settings) == [
        ("precise", n), ("ao_fg", n), ("ao_threshold", n), ("rough", n),
        ("rough", surfel), ("rough", surfel)]


@pytest.mark.parametrize("ranks", [1, 2, 3, 4])
def test_passes_under_a_mesh_are_rank_zeros(scenes, ranks):
    """Under a mesh of N ranks: seven launches, the sun's ao_threshold
    and rough in place of ao_fg, each at rank 0's padded chunk of the
    pass's rays, ceil(rays / N)."""
    cell, settings = _cell("dense-orbit-4k")
    n, surfel = ONE_CARD["dense-orbit-4k"]
    c, s = -(-n // ranks), -(-surfel // ranks)
    assert work.hdda_passes(scenes(cell.config), settings, ranks) == [
        ("precise", c), ("ao_threshold", c), ("rough", c),
        ("ao_threshold", c), ("rough", c), ("rough", s), ("rough", s)]


@pytest.mark.parametrize("fused_sun", [True, False])
def test_reference_traces_the_priced_passes(monkeypatch, fused_sun):
    """The reference's frame makes the launches the count prices, in
    order: on one card the fused sun walk; on the sharded frame's route
    (``fused_sun=False``, what the check selects for a sharded cell) the
    sun's two plain launches, as the port's sharded frame makes them."""
    import torch

    from benchmark import check, inputs
    from benchmark.reference.ops import hdda
    from conftest import tiny

    cell = tiny(_cell("dense-orbit-1080p")[0])
    modes = []
    trace, fused = hdda.trace_scene, hdda.trace_scene_ao_fg

    def spy(scene, origin, direction, t_min, t_max, mode="precise"):
        modes.append(mode)
        return trace(scene, origin, direction, t_min, t_max, mode)

    def spy_fused(*a, **k):
        modes.append("ao_fg")
        return fused(*a, **k)
    monkeypatch.setattr(hdda, "trace_scene", spy)
    monkeypatch.setattr(hdda, "trace_scene_ao_fg", spy_fused)
    path = inputs.Motion(cell.traffic, 2**31 + 53)
    ref = check.Reference(cell.config, cell.traffic, path,
                          inputs.scene_bytes(cell.config),
                          torch.device("cpu"), fused_sun=fused_sun)
    ref.render(dict(frame=0, eye=path.eye(0), o2w=None, prev_o2w=None,
                    edits=[], state_in=None))
    priced = work.hdda_passes(ref.scene, ref.settings,
                              None if fused_sun else 4)
    assert modes == [mode for mode, _rays in priced]
