"""A short run of a cell on the card prints a correct result line."""

import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dense-orbit-1080p", "--seed", str(2**31 + 1), "--seconds", "3",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
