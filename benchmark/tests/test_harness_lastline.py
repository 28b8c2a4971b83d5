"""The last line's schema, and a run that finds no card prints nothing
and fails."""

import json
import subprocess
import sys

from benchmark import spec
from conftest import run_tiny


def test_last_line_schema():
    out, run = run_tiny("dense-orbit-1080p", seed=2**31 + 3, trace=True)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert out["attempted"] == run.frames and out["failed"] == 0
    units = {m["name"]: m["unit"] for m in
             spec.load_cell("dense-orbit-1080p").per_layer}
    for name, m in out["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)


def test_run_without_a_card_fails_quietly():
    import torch

    if torch.cuda.is_available():
        return
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dense-orbit-1080p", "--seed", str(2**33), "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr
