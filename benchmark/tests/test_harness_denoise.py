"""The denoiser's per-layer metric ``denoise_device_ms``: the device ms a
frame of the kernels named ``denoise_`` in a synthetic slice, None where
none ran (the parent's slice, an untraced run), no HDDA or hash kernel
counted, and the metric carried by every cell."""

import types

import pytest

from benchmark import devtrace, spec

CELLS = ("dense-orbit-1080p", "dense-orbit-4k", "hash-orbit-1080p")


def _slice(ops: dict, frames: int = 6) -> devtrace.Slice:
    return devtrace.Slice(
        frames=frames, wall_s=1.0, busy_s=0.5, kernels=len(ops),
        kernel_s=sum(ops.values()), device_ops=ops, hdda_s=0.0,
        hdda_kernels=0, host_syncs=0, idle_gaps={})


def _run(ops, frames=6):
    return types.SimpleNamespace(cell=spec.load_cell("dense-orbit-4k"),
                                 trace=_slice(ops, frames))


def _read(run):
    return spec.metric_reader("denoise_device_ms")(run)


def test_reads_the_denoise_kernels_a_frame():
    ops = {"denoise_temporal_kernel": 0.0012,
           "denoise_atrous_kernel": 0.0009,
           "elementwise_kernel[MulFunctor]": 0.05,
           "CatArrayBatchedCopy_alignedK_contig": 0.02}
    assert _read(_run(ops)) == pytest.approx(1e3 * 0.0021 / 6)
    assert _read(_run(ops, frames=3)) == pytest.approx(1e3 * 0.0021 / 3)


def test_none_when_no_denoise_kernel_ran():
    """The parent's slice, whose denoiser is PyTorch ops, and an untraced
    run: None, so that the line leaves the metric out."""
    ops = {"elementwise_kernel[MulFunctor]": 0.01, "hdda_kernel": 0.002,
           "gbuffer_resolve_kernel": 0.0005}
    assert _read(_run(ops)) is None
    assert _read(types.SimpleNamespace(cell=None, trace=None)) is None


def test_counts_no_hdda_or_hash_kernel():
    ops = {"denoise_atrous_kernel": 0.0006, "hdda_kernel": 0.004,
           "hdda_instance_kernel": 0.001, "spatial_hash_probe_kernel": 0.0002,
           "spatial_hash_apply_kernel": 0.0001}
    assert _read(_run(ops)) == pytest.approx(1e3 * 0.0006 / 6)


def test_every_cell_carries_it():
    entry = next(m for m in spec.load_json(spec.ROOT / "BENCHMARK.json")
                 ["per_layer"] if m["name"] == "denoise_device_ms")
    assert entry["moves"] == "frame_ms" and entry["unit"] == "ms"
    assert entry["layer"] == "frame stage 5, denoise"
    assert "workloads" not in entry
    for cell in CELLS:
        names = [m["name"] for m in spec.load_cell(cell).per_layer]
        assert "denoise_device_ms" in names
