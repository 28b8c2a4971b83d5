"""The control, the reference computed in bfloat16 and put in the
program's place, comes out as not correct: at a tiny size on the CPU,
on the cell's own scene, passes and check."""

import time

import pytest
import torch

from benchmark import check, harness
from conftest import load_cell, run_sharded_tiny, sharded_cell, tiny


@pytest.mark.parametrize("workload", ["dense-orbit-1080p", "hash-orbit-1080p",
                                      "dense-edits-1080p"])
def test_control_fails(workload):
    cell = tiny(load_cell(workload))
    device = torch.device("cpu")
    run, records, loop = harness.run_cell(cell, 2**31 + 5, 0.5, False, device,
                                          time.perf_counter())
    recs = harness.host_records(loop, records)
    ref = check.Reference(cell.config, cell.traffic, loop.path,
                          loop.scene_bytes, device)
    assert all(v == 0.0 for v in check.check(ref, recs).values())
    nums = check.control(ref, recs)
    limits = cell.check["limits"]
    over = {k: v for k, v in nums.items() if v > limits[k]}
    assert over, (nums, limits)


@pytest.mark.parametrize("ranks", [2, 4])
def test_control_fails_under_the_mesh(tmp_path, ranks):
    """The control on a ray-sharded run's frames (made whole on rank 0,
    the reference on the sharded frame's sun route): the program reads
    0.0 on every number, the control over a limit."""
    cell = sharded_cell(tmp_path, ranks)
    report = run_sharded_tiny(cell, seed=2**31 + 5, seconds=0.5,
                              control=True)
    checks = report["out"]["checks"]
    assert all(c["value"] == 0.0 for c in checks.values()), checks
    limits = cell.check["limits"]
    over = {k: v for k, v in report["control"].items() if v > limits[k]}
    assert over, (report["control"], limits)
