"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository. Tests that need the card are marked ``gpu`` and
skip without one; the decision is made in the ``card`` fixture."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# Cells whose files are kept under ``benchmark/`` but that are not in
# ``BENCHMARK.json`` yet: name -> (chips, configuration file, mix).
HELD = {"hash-orbit-1080p": (1, "benchmark/configs/castle-hash.json",
                             "orbit-1080p")}


def load_cell(workload: str):
    """The cell ``workload``: from ``BENCHMARK.json``, or a held one."""
    from benchmark import spec

    if workload in HELD:
        return spec.make_cell(workload, *HELD[workload])
    return spec.load_cell(workload)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny(cell):
    """``cell`` cut to a size the CPU renders in seconds: 128x72 and 4,096
    surfel rays (dense budget or hash pool, over a 2^16-slot hash). The
    scene, the passes and the check are the cell's own."""
    import copy

    cell = copy.deepcopy(cell)
    cell.traffic.update(width=128, height=72, trace_frames=2)
    render = cell.config["render"]
    if render["gi_cache"] == "dense":
        render.setdefault("surfels", {})["dense_refresh_budget"] = 4096
    else:
        render["surfels"]["pool_size"] = 4096
        render["spatial_hash"]["capacity"] = 1 << 16
    return cell


def run_tiny(workload: str, seed: int, seconds: float = 1.0,
             trace: bool = False, patch=None):
    """A whole run of ``workload`` at :func:`tiny` size on the CPU, the
    look for a card skipped; ``patch(module)`` may break the port's frame
    before it runs. Returns (result line, run)."""
    import time

    import torch

    from benchmark import harness
    from benchmark.run import result_line

    cell = tiny(load_cell(workload))
    device = torch.device("cpu")
    run, records, loop = harness.run_cell(cell, seed, seconds, trace, device,
                                          time.perf_counter())
    nums = harness.check_records(cell, loop, records, device, run)
    return result_line(cell, run, nums, {}, trace), run


def sharded_cell(tmp_path, ranks: int):
    """A ray-sharded cell of ``ranks`` ranks: castle-dense's file with
    ``"parallel": {"shard": "rays"}``, copied under ``tmp_path``, on the
    orbit-1080p mix and ``dense-orbit-1080p``'s check (the start, a
    seeded frame and the one after the window), at :func:`tiny` size."""
    from benchmark import spec

    config = spec.load_json(ROOT / "benchmark/configs/castle-dense.json")
    config["parallel"] = {"shard": "rays"}
    path = tmp_path / "castle-dense-sharded.json"
    path.write_text(json.dumps(config))
    return tiny(spec.make_cell("dense-orbit-1080p", ranks, str(path),
                               "orbit-1080p"))


def run_sharded_tiny(cell, seed: int, seconds: float = 1.0,
                     trace: bool = False, hook: str | None = None,
                     control: bool = False) -> dict:
    """A whole run of the sharded ``cell`` on its ranks under gloo on the
    CPU; ``hook`` (a function of ``test_harness_faults``, by name) may
    break the port in every rank. Returns rank 0's report
    (``ranks.run_cell``)."""
    import time

    from benchmark import ranks

    if hook is not None:
        hook = f"test_harness_faults:{hook}"
    return ranks.run_cell(cell, seed, seconds, trace, "cpu",
                          time.perf_counter(), hook=hook, control=control)
