"""A ray-sharded cell's run: ``chips`` ranks, one process per card (rank
r on ``cuda:r`` under NCCL; on the CPU, for the tests, under gloo),
joined through a ``torch.distributed.FileStore`` in a temporary
directory (no network; NCCL's own bootstrap kept to the loopback
device), each on the program's own entry points
(``dust_tpu_torch.parallel.init_process_group``, ``make_mesh``) and each
running :func:`benchmark.harness.run_cell` with its mesh.

The launching process (``run.py``) starts the ranks and watches them. It
takes rank 0's result line and every rank's memory peak and loaded JAX
modules, and returns the result once every rank has exited with code 0.
A rank that exits otherwise (it raised, was killed, or a collective of
its timed out after ``parallel.TIMEOUT_S``) ends the run at once: every
other rank is killed, and there is no result. A rank whose launcher has
gone exits by itself. The ranks print nothing to standard output.

``python -m benchmark.ranks <job.json> <rank>`` is one rank; the job
file, written by :func:`run_cell`, holds the cell and the run's
arguments.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
POLL_S = 0.2  # how often the launcher looks at its ranks


class RankFailed(RuntimeError):
    """A rank exited with another code than 0, or left no result."""


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, hook: str | None = None,
             control: bool = False) -> dict:
    """Runs the sharded ``cell`` on ``cell.chips`` ranks on ``device``
    (``"cuda"`` or ``"cpu"``); ``t_start`` is the launcher's
    ``time.perf_counter()`` when the run began, so that ``setup_s``
    counts the ranks' start. ``hook`` (``"module:function"``, importable
    from ``sys.path``) is called with the mesh in every rank before the
    run: the tests break the program there. Returns rank 0's report:
    ``out`` (the result line, with the largest memory peak over the
    ranks), ``lines`` (its lines for standard error), ``forbidden`` (JAX
    modules any rank had loaded) and, with ``control``, ``control``: the
    control's numbers on the same frames (``check.control``). Raises
    :class:`RankFailed`."""
    started = time.monotonic() - (time.perf_counter() - t_start)
    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        job = Path(tmp) / "job.json"
        job.write_text(json.dumps(dict(
            cell=dataclasses.asdict(cell), seed=seed, seconds=seconds,
            trace=trace, device=device, started=started, hook=hook,
            control=control,
            store=str(Path(tmp) / "store"), out=tmp, path=sys.path)))
        env = dict(os.environ)
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "benchmark.ranks", str(job), str(r)],
            cwd=ROOT, env=env, stdin=subprocess.DEVNULL, stdout=2)
            for r in range(cell.chips)]
        try:
            _watch(procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        reports = []
        for r in range(cell.chips):
            path = Path(tmp) / f"rank{r}.json"
            if not path.exists():
                raise RankFailed(f"rank {r} exited with code 0 but left no "
                                 f"report")
            reports.append(json.loads(path.read_text()))
    report = reports[0]
    report["out"]["device"]["memory_peak_bytes"] = max(
        r["memory_peak_bytes"] for r in reports)
    report["forbidden"] = sorted({m for r in reports for m in r["forbidden"]})
    report["lines"].append("# memory_peak_bytes by rank: " + ", ".join(
        str(r["memory_peak_bytes"]) for r in reports))
    return report


def _watch(procs: list) -> None:
    """Returns when every rank has exited with code 0; raises
    :class:`RankFailed` as soon as one exits otherwise."""
    while True:
        codes = [p.poll() for p in procs]
        failed = [f"rank {r} with code {code}" for r, code in enumerate(codes)
                  if code not in (None, 0)]
        if failed:
            raise RankFailed(f"of {len(procs)} ranks, {', '.join(failed)} "
                             f"exited; the other ranks are killed")
        if all(code == 0 for code in codes):
            return
        time.sleep(POLL_S)


def _exit_with_launcher(launcher: int) -> None:
    """Ends this rank when its launcher has gone."""
    while os.getppid() == launcher:
        time.sleep(1.0)
    os._exit(1)


def rank_main(job_path: str, rank: int) -> int:
    """One rank of :func:`run_cell`'s job: joins the group, runs the
    cell, and (rank 0) checks the frames; writes its report to
    ``rank<r>.json`` beside the job. A rank that raises prints the
    traceback and exits with code 1 at once."""
    threading.Thread(target=_exit_with_launcher, args=(os.getppid(),),
                     daemon=True).start()
    job = json.loads(Path(job_path).read_text())
    sys.path[:] = job["path"]
    t_start = time.perf_counter() - (time.monotonic() - job["started"])
    import torch
    import torch.distributed as dist

    from benchmark import check, harness, spec
    from benchmark.run import forbidden_modules, result_line, summary_lines
    from dust_tpu_torch import parallel

    cell = spec.Cell(**job["cell"])
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    size = cell.chips
    try:
        parallel.init_process_group(rank, size, job["device"],
                                    dist.FileStore(job["store"], size))
        mesh = parallel.make_mesh()
        if job["hook"]:
            module, name = job["hook"].split(":")
            getattr(__import__(module, fromlist=[name]), name)(mesh)
        device = mesh.device
        run, records, loop = harness.run_cell(
            cell, job["seed"], job["seconds"], job["trace"], device, t_start,
            mesh)
        peak = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
        report = dict(memory_peak_bytes=peak, forbidden=forbidden_modules())
        t = time.perf_counter()
        recs = harness.host_records(loop, records)
        if rank == 0:
            ref = harness.reference(cell, loop, device)
            run.hdda_least_s = harness.hdda_least_s(ref, mesh)
            nums = check.check(ref, recs)
            device_info = {"platform": "gpu" if device.type == "cuda"
                           else device.type, "count": size}
            if device.type == "cuda":
                device_info["kind"] = torch.cuda.get_device_name(device)
            if run.trace is not None:
                device_info.update(busy_s=run.trace.busy_s,
                                   window_s=run.trace.wall_s)
            report.update(out=result_line(cell, run, nums, device_info,
                                          job["trace"]),
                          lines=summary_lines(cell.name, job["seed"], run,
                                              time.perf_counter() - t))
            if job["control"]:
                report["control"] = check.control(ref, recs)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    tmp = Path(job["out"]) / f"rank{rank}.json.tmp"
    tmp.write_text(json.dumps(report))
    tmp.replace(Path(job["out"]) / f"rank{rank}.json")
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2])))
