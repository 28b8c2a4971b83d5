"""The denoiser's per-layer metric ``denoise_device_ms``: the device ms a
frame of the kernels named ``denoise_`` in a synthetic slice, None where
none ran (the parent's slice, an untraced run), no HDDA or hash kernel
counted, and the metric carried by every cell."""

import types

import pytest

from benchmark import devtrace, spec


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
    """Every cell carries the metric once: as ``denoise_device_ms`` where
    it reports ``frame_ms``, as ``denoise_device_ms.tail``, moving
    ``frame_ms_p95``, where that is its frame time."""
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for cell in [w["name"] for w in bench["workloads"]]:
        c = spec.load_cell(cell)
        found = [m for m in c.per_layer
                 if m["name"].split(".")[0] == "denoise_device_ms"]
        assert len(found) == 1, cell
        entry = found[0]
        assert entry["unit"] == "ms"
        assert entry["layer"] == "frame stage 5, denoise"
        e2e = {m["name"] for m in c.end_to_end}
        assert entry["moves"] == ("frame_ms" if "frame_ms" in e2e
                                  else "frame_ms_p95")
        assert spec.metric_reader(entry["name"]) is not None
