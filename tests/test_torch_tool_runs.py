"""The port's whole-frame tools run small on the CPU: ``profile_frame``
(the frame under ``torch.profiler``: the Chrome trace written and not
empty, the table of operators printed) and ``bench_matrix`` (one
config through ``python -m dust_tpu_torch.bench`` in a subprocess: one
JSON line with the bench's own line, and the log beside it). Both
render the castle, whose frame costs some seconds on the CPU at any
size; so one frame each, at 128x8."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dust_tpu_torch.tools import bench_matrix, profile_frame

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread here (as tests/test_torch_hash.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_profile_frame_writes_a_trace_and_the_table(tmp_path, capsys):
    out_dir = tmp_path / "prof"
    assert profile_frame.main(["--device", "cpu", "--width", "128",
                               "--height", "8", "--frames", "1", "--out",
                               str(out_dir)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# 128x8, gi cache dense, device cpu"
    traces = list(out_dir.iterdir())
    assert len(traces) == 1 and traces[0].stat().st_size > 1000
    with open(traces[0]) as f:
        assert f.read(4096).lstrip().startswith("{")
    head = [i for i, line in enumerate(lines)
            if line.startswith("operators by host (inclusive) time")]
    assert len(head) == 1
    table = lines[head[0] + 1:]
    assert len(table) == profile_frame.TOP_KERNELS
    assert all(" ms " in row and " calls " in row for row in table)
    assert any("ms/frame over 1 frames" in line for line in lines)


def test_bench_matrix_writes_one_line_per_config(tmp_path):
    out = tmp_path / "m.jsonl"
    env = dict(os.environ, PYTHONPATH=str(REPO), OUT=str(out),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "dust_tpu_torch.tools.bench_matrix",
         "--configs", "gi", "--device", "cpu", "--small", "--width", "128",
         "--height", "8", "--frames", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [row["config"] for row in rows] == ["gi"]
    assert rows[0]["elapsed_s"] > 0
    assert rows[0]["result"]["unit"] == "Mrays/s"
    assert "castle+teapot 128x8" in rows[0]["result"]["metric"]
    log = (tmp_path / "m.log").read_text()
    assert log.startswith("=== gi ===") and "device cpu" in log
    assert "gi done in" in r.stdout


def test_bench_matrix_records_a_failed_config(tmp_path):
    """A bench that fails leaves a null result and a non-zero exit; the
    matrix has the reference's six configs and frame counts."""
    rows = bench_matrix.run_matrix([("gi", ["--config", "no-such"])], [],
                                   str(tmp_path / "f.jsonl"),
                                   log=lambda s: None)
    assert rows[0]["result"] is None
    assert "invalid choice" in (tmp_path / "f.log").read_text()
    assert [c[0] for c in bench_matrix.CONFIGS] == [
        "gi", "primary-shadow", "hash-reference", "gi-4k", "flythrough",
        "stress"]
    assert [c[1][-1] for c in bench_matrix.CONFIGS] == ["16", "16", "8", "8",
                                                        "8", "8"]
