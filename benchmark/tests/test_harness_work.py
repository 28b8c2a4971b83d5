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
