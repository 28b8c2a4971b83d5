"""The benchmark of ``dust_tpu_torch``: one run of one cell on the card.

Usage (from the root of a checkout):
  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
      --trace <0|1>

``--workload`` names a cell of ``BENCHMARK.json``. The run builds the
cell's scene from its configuration, warms up the cell's own frames,
renders a closed loop of frames for ``--seconds`` (the window), and then
checks the frames it rendered against the plain reference in
``benchmark/reference`` (see ``benchmark/check.py``). With ``--trace 0``
the result carries the cell's end-to-end metrics; with ``--trace 1`` a
short slice of the window runs under ``torch.profiler`` and the result
carries its per-layer metrics.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (frames in the window), ``failed`` (edits that never
landed), ``metrics``, ``device`` and, traced, ``breakdown``; last,
``checks``: each compared number with its limit, which also end
standard error. The run exits non-zero and prints no result without a
CUDA device (or with fewer than the cell asks for), without the port,
or when ``jax``, ``jaxlib``, ``flax`` or ``dust_tpu`` was loaded.

A ray-sharded cell (``spec.Cell.sharded``) runs as ``chips`` ranks, one
process per card (``benchmark/ranks.py``); this process starts and
watches them and prints rank 0's result once every rank has ended well.
Its metrics are rank 0's clock and trace, ``memory_peak_bytes`` the
largest over the ranks. A rank that fails ends the run: every rank is
killed, nothing is printed to standard output, and the exit code is 6.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dust_tpu")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout else out.stderr


def summary_lines(workload: str, seed: int, run, check_s: float) -> list:
    """The run's summary for standard error: frames, set-up, the check's
    time, the card, and ``frame_ms`` by third of the window."""
    import torch

    thirds = [run.ends[k * run.frames // 3:(k + 1) * run.frames // 3]
              for k in range(3)]
    return [f"# {workload} seed {seed}: {run.frames} frames, set-up "
            f"{run.setup_s:.3f} s, check {check_s:.3f} s, {card_name()}, "
            f"torch {torch.__version__}",
            "# frame_ms by third of the window: " + ", ".join(
                f"{1e3 * (t[-1] - t[0]) / max(len(t) - 1, 1):.3f}"
                for t in thirds if t)]


def result_line(cell, run, nums: dict, device_info: dict, trace: bool):
    """The result's JSON object and whether every number is in its
    limit."""
    from benchmark.spec import metric_reader

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": nums.get(k), "limit": lim}
              for k, lim in cell.check["limits"].items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": run.frames,
           "failed": run.unlanded, "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        out["breakdown"] = {
            "device_ops": run.trace.top(run.trace.device_ops),
            "idle_gaps": run.trace.top(run.trace.idle_gaps)}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    # Import the benchmark as a package from the checkout's root, not its
    # modules from the script's directory.
    sys.path[0] = str(ROOT)
    from benchmark import harness, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    try:
        import dust_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run: the port is not in this checkout: {e}", file=sys.stderr)
        return 4
    if cell.sharded:
        from benchmark import ranks

        try:
            report = ranks.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_START)
        except ranks.RankFailed as e:
            print(f"run: {e}", file=sys.stderr)
            return 6
        found = sorted(set(report["forbidden"]) | set(forbidden_modules()))
        if found:
            print(f"run: JAX packages were loaded: {found}", file=sys.stderr)
            return 5
        out, lines = report["out"], report["lines"]
    else:
        device = torch.device("cuda", 0)
        run, records, loop = harness.run_cell(cell, args.seed, args.seconds,
                                              bool(args.trace), device,
                                              T_START)
        torch.cuda.synchronize(device)
        device_info = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
        if run.trace is not None:
            device_info.update(busy_s=run.trace.busy_s,
                               window_s=run.trace.wall_s)
        found = forbidden_modules()
        if found:
            print(f"run: JAX packages were loaded: {found}", file=sys.stderr)
            return 5
        t = time.perf_counter()
        nums = harness.check_records(cell, loop, records, device, run)
        out = result_line(cell, run, nums, device_info, bool(args.trace))
        lines = summary_lines(args.workload, args.seed, run,
                              time.perf_counter() - t)
    for line in lines:
        print(line, file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
