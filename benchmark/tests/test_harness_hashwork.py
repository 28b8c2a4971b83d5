"""The spatial hash's per-layer metrics: the frozen working-set count of
``benchmark.hashwork`` against the reference's scene, the floor against a
hand count, the two readers on slices with and without the hash's
kernels, and the metrics carried by the hash cell alone."""

import types

import pytest
import torch

from benchmark import devtrace, hashwork, inputs, spec

SHARED = {"device_idle_pct", "cuda_kernels_per_frame", "torch_ops_device_ms",
          "host_syncs_per_frame", "hdda_device_ms", "hdda_roofline",
          "hdda_launches_per_frame", "scene_build_ms", "denoise_device_ms"}
HASH = {"hash_device_ms", "hash_roofline"}


def test_frozen_working_set_is_the_reference_scenes():
    """CASTLE_HASH_CELLS is what ``benchmark/reference`` lays out for the
    castle-hash scene; the cell probes six keys a cell."""
    from benchmark.reference.ops import gi_cache
    from benchmark.reference.render import scene as ref_scene
    from benchmark.reference.vox import loader

    config = spec.load_cell("hash-orbit-1080p").config
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene = ref_scene.build_device_scene(
            loader.load_vox_scene(inputs.scene_bytes(config)),
            torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    assert gi_cache.dense_cells(scene) == hashwork.CASTLE_HASH_CELLS
    assert gi_cache.dense_rows(scene) == hashwork.CASTLE_HASH_KEYS


def test_floor_by_hand():
    config = spec.load_cell("hash-orbit-1080p").config
    keys, cells, pool = 181_248, 30_208, 345_600
    probe = keys * (64 + 4 + 12) + cells * (12 + 1)
    insert = pool * (12 + 4 + 12 + 1)
    assert hashwork.least_time_s(config) == pytest.approx(
        (probe + insert) / 3.35e12)
    with pytest.raises(ValueError):
        hashwork.least_time_s(spec.load_cell("dense-orbit-1080p").config)


def _slice(ops: dict, frames: int = 6) -> devtrace.Slice:
    return devtrace.Slice(
        frames=frames, wall_s=1.0, busy_s=0.5, kernels=len(ops),
        kernel_s=sum(ops.values()), device_ops=ops, hdda_s=0.0,
        hdda_kernels=0, host_syncs=0, idle_gaps={})


def _run(ops):
    cell = spec.load_cell("hash-orbit-1080p")
    return types.SimpleNamespace(cell=cell, trace=_slice(ops))


def test_readers_on_a_slice_without_the_hash_kernels():
    """The parent's slice, and an untraced run: both readers say None."""
    ops = {"elementwise_kernel[MulFunctor]": 0.01, "hdda_kernel": 0.002,
           "DeviceRadixSortOnesweepKernel": 0.001}
    for name in HASH:
        read = spec.metric_reader(name)
        assert read(_run(ops)) is None
        assert read(types.SimpleNamespace(cell=None, trace=None)) is None


def test_readers_on_a_synthetic_slice():
    ops = {"spatial_hash_probe_kernel": 0.0006, "spatial_hash_apply_kernel":
           0.0003, "spatial_hash_scan_kernel": 0.0003,
           "elementwise_kernel[MulFunctor]": 0.05}
    run = _run(ops)
    ms = spec.metric_reader("hash_device_ms")(run)
    assert ms == pytest.approx(1e3 * 0.0012 / 6)
    pct = spec.metric_reader("hash_roofline")(run)
    least = hashwork.least_time_s(run.cell.config)
    assert pct == pytest.approx(100.0 * least / (0.0012 / 6))
    assert 0.0 < pct < 100.0


def _bases(cell) -> set:
    """A cell's per-layer metrics by base name (``<base>.tail`` is
    ``<base>``), less the mean frame time the tail cells carry."""
    return {m["name"].split(".")[0] for m in cell.per_layer} - {"frame_ms"}


def test_only_the_hash_cell_carries_the_hash_metrics():
    cell = spec.load_cell("hash-orbit-1080p")
    assert _bases(cell) == SHARED | HASH
    assert cell.config["name"] == "castle-hash" and cell.chips == 1
    for workload in ("dense-orbit-1080p", "dense-orbit-4k"):
        assert _bases(spec.load_cell(workload)) == SHARED
