"""The readings that the check's limits are set from, for one cell, in
one process: the program against the reference on each of ``--seeds``
(the lower readings), and the control, the reference in bfloat16,
against the reference on each of ``--control-seeds`` (the upper
readings). Each seed renders a short window (``--seconds``) and checks
the same frames a run checks. Needs the card.

Usage: python3 benchmark/calibrate.py --workload <cell>
    --seeds 1,2,... --control-seeds 7,8,9 [--seconds 3]

Prints one JSON line per seed and side, then the summary: each number's
largest program reading and smallest control reading. A ray-sharded
cell runs each seed on its ranks (``benchmark/ranks.py``), the control
on rank 0 beside the check.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import check, harness, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    lower: dict = {}
    upper: dict = {}
    for seed in sorted(set(seeds) | set(controls)):
        t = time.perf_counter()
        if cell.sharded:
            from benchmark import ranks

            report = ranks.run_cell(cell, seed, args.seconds, False, "cuda",
                                    t, control=seed in controls)
            program = {k: c["value"]
                       for k, c in report["out"]["checks"].items()}
            frames = report["out"]["attempted"]
        else:
            run, records, loop = harness.run_cell(cell, seed, args.seconds,
                                                  False, device, t)
            recs = harness.host_records(loop, records)
            ref = harness.reference(cell, loop, device)
            del loop
            program = check.check(ref, recs) if seed in seeds else {}
            report = dict(control=check.control(ref, recs)
                          if seed in controls else {})
            frames = run.frames
            del ref, recs
            torch.cuda.empty_cache()
        if seed in seeds:
            print(json.dumps({"seed": seed, "side": "program", **program}),
                  flush=True)
            for k, v in program.items():
                lower[k] = max(lower.get(k, 0.0), v)
        if seed in controls:
            nums = report["control"]
            print(json.dumps({"seed": seed, "side": "control", **nums}),
                  flush=True)
            for k, v in nums.items():
                upper[k] = min(upper.get(k, float("inf")), v)
        print(f"# seed {seed}: {frames} frames, "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
