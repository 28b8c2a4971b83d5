"""Small whole runs on the CPU, the look for a card skipped: the port's
frames, at a tiny size, equal the plain reference's in every cell, and
the end-to-end metrics are reported."""

import pytest

from benchmark import spec
from conftest import run_tiny


@pytest.mark.parametrize("workload", ["dense-orbit-1080p", "hash-orbit-1080p",
                                      "dense-edits-1080p"])
def test_tiny_run_is_correct(workload):
    out, run = run_tiny(workload, seed=2**31 + 11)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    assert run.frames >= 1 and out["failed"] == 0
    names = set(out["metrics"])
    assert names == {m["name"] for m in spec.load_cell(workload).end_to_end}
    assert {"frame_ms_p95", "setup_s"} <= names
    if workload == "dense-edits-1080p":
        assert run.edit_latencies_s and min(run.edit_latencies_s) > 0.0
        for name in ("edit_latency_ms_p95", "edit_call_ms"):
            assert spec.metric_reader(name)(run) is not None, name
