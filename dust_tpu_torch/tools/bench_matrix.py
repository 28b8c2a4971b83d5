"""Every bench config, one JSON line each (port of ``tools/bench_matrix.sh``).

Runs ``python -m dust_tpu_torch.bench`` once per config, each in its own
process with a 3000 s limit, and writes one line per config,
``{"config", "elapsed_s", "result"}`` (``result``: the bench's JSON
line, or null when it failed or printed none), to ``$OUT`` (default
``bench_matrix.jsonl``), and the benches' standard error to a log beside
it (``.jsonl`` replaced by ``.log``). There is no retry: a config that
fails leaves a null result, and the run exits non-zero.

Usage:
  [OUT=path.jsonl] python -m dust_tpu_torch.tools.bench_matrix
      [--configs gi,stress] [bench arguments, e.g. --device cpu --small]

Arguments the tool does not know are passed to every bench run, after
the config's own.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# (name, the bench's arguments), as tools/bench_matrix.sh runs them.
CONFIGS = (
    ("gi", ["--frames", "16"]),
    ("primary-shadow", ["--config", "primary-shadow", "--frames", "16"]),
    ("hash-reference", ["--config", "hash-reference", "--frames", "8"]),
    ("gi-4k", ["--config", "gi-4k", "--frames", "8"]),
    ("flythrough", ["--config", "flythrough", "--frames", "8"]),
    ("stress", ["--config", "stress", "--frames", "8"]),
)
TIMEOUT_S = 3000
REPO = Path(__file__).resolve().parents[2]


def _bench_line(stdout: str):
    """The bench's JSON line (its last line that parses), or None."""
    for line in reversed(stdout.splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return None


def run_matrix(configs, extra, out: str, timeout: float = TIMEOUT_S,
               log=print) -> list:
    """Runs each (name, arguments) of ``configs`` with ``extra`` appended;
    writes ``out`` and its log. Returns the lines written, as dicts."""
    log_path = (out[:-len(".jsonl")] if out.endswith(".jsonl") else out) \
        + ".log"
    rows = []
    with open(out, "w") as out_f, open(log_path, "w") as log_f:
        for name, args in configs:
            log_f.write(f"=== {name} ===\n")
            log_f.flush()
            cmd = [sys.executable, "-m", "dust_tpu_torch.bench"] + list(args) \
                + list(extra)
            start = time.perf_counter()
            try:
                r = subprocess.run(cmd, stdout=subprocess.PIPE,
                                   stderr=log_f, text=True, timeout=timeout,
                                   cwd=REPO)
                result = _bench_line(r.stdout) if r.returncode == 0 else None
            except subprocess.TimeoutExpired:
                log_f.write(f"timed out after {timeout} s\n")
                result = None
            elapsed = time.perf_counter() - start
            row = {"config": name, "elapsed_s": elapsed, "result": result}
            out_f.write(json.dumps(row) + "\n")
            out_f.flush()
            line = f"{name} done in {elapsed:.1f}s: {json.dumps(result)}"
            log_f.write(line + "\n")
            log_f.flush()
            log(line)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    names = [c[0] for c in CONFIGS]
    ap.add_argument("--configs", default=",".join(names),
                    help="comma-separated subset of " + ",".join(names))
    args, extra = ap.parse_known_args(argv)
    pick = args.configs.split(",")
    unknown = sorted(set(pick) - set(names))
    if unknown:
        ap.error(f"unknown configs {unknown}")
    configs = [c for c in CONFIGS if c[0] in pick]
    rows = run_matrix(configs, extra, os.environ.get("OUT",
                                                     "bench_matrix.jsonl"))
    return 0 if all(r["result"] is not None for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
