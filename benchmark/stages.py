"""The traced slice by the program's own spans (``dust.*``, opened by
``dust_tpu_torch.utils.profiling.trace_annotation`` while a profiler
runs): each span's host time, and the device time, blocking calls and
idle gaps of each stage of the frame. The spans share a clock with the
device activity, so a kernel, copy or memset counts for the stage open
where the runtime call that launched it began (matched by correlation
id).

Usage (from the root of a checkout, on a card):
  python3 benchmark/stages.py --workload <name> --seed <n>

renders the cell's warm-up and the frames before its traced slice as
``run.py`` does, traces the slice (the cell's ``trace_frames``) under
``torch.profiler`` and prints one JSON object: ms a frame by stage
(device, host, idle), blocking calls a frame by stage, each
``dust.*`` span's host ms a frame, and the slice's device total as
``devtrace`` reads it, which the stages, ``NO_STAGE`` and ``NO_LAUNCH``
add up to. No check is made and no metric of ``BENCHMARK.json`` is
read."""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
from pathlib import Path

SPAN = "dust."
# The stages of the frame: ``render_frame``'s five steps, which do not
# overlap.
STAGES = ("dust.primary", "dust.sun", "dust.gather", "dust.refresh",
          "dust.post")
NO_STAGE = "(no stage)"
NO_LAUNCH = "(launch not found)"
# Host calls that launch device work; a device activity carries the
# correlation id of the call that launched it.
LAUNCH_CALLS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Stages:
    frames: int
    span_host_s: dict       # dust.* span -> inclusive host seconds
    stage_device_s: dict    # stage open at the launch -> device seconds
    stage_syncs: dict       # stage -> blocking calls (devtrace.SYNC_CALLS)
    stage_idle_s: dict      # stage open where each idle gap begins -> s

    def per_frame(self) -> dict:
        """The tables a frame: ms, and blocking calls."""
        f = self.frames
        return {
            "span_host_ms": {k: 1e3 * v / f
                             for k, v in sorted(self.span_host_s.items())},
            "stage_device_ms": {k: 1e3 * v / f
                                for k, v in self.stage_device_s.items()},
            "stage_syncs": {k: v / f for k, v in self.stage_syncs.items()},
            "stage_idle_ms": {k: 1e3 * v / f
                              for k, v in self.stage_idle_s.items()}}


def stage_tables(spans, launches, activities, syncs, gaps) -> tuple:
    """The slice by the program's spans. ``spans``: (start, end, name) of
    each ``dust.*`` span on the slice's thread; ``launches``: (start,
    correlation id) of each launching call; ``activities``: (correlation
    id, length) of each device activity within the slice; ``syncs``: the
    start of each blocking call; ``gaps``: (start, end) of each idle gap;
    times in ns. Returns (span_host_s, stage_device_s, stage_syncs,
    stage_idle_s): each span name's inclusive seconds; device seconds by
    the stage open where the activity's launching call began (``NO_STAGE``
    outside every stage, ``NO_LAUNCH`` where no call has its correlation
    id); blocking calls by the stage open where each began; idle seconds
    by the stage open where each gap begins."""
    span_host_s: dict = {}
    for s, e, name in spans:
        span_host_s[name] = span_host_s.get(name, 0.0) + (e - s) * 1e-9
    stages = sorted(sp for sp in spans if sp[2] in STAGES)
    starts = [s for s, _, _ in stages]

    def stage_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return stages[i][2] if i >= 0 and t < stages[i][1] else NO_STAGE

    launched = {corr: stage_at(t) for t, corr in launches}
    stage_device_s: dict = {}
    for corr, length in activities:
        k = launched.get(corr, NO_LAUNCH)
        stage_device_s[k] = stage_device_s.get(k, 0.0) + length * 1e-9
    stage_syncs: dict = {}
    for t in syncs:
        k = stage_at(t)
        stage_syncs[k] = stage_syncs.get(k, 0) + 1
    stage_idle_s: dict = {}
    for s, e in gaps:
        k = stage_at(s)
        stage_idle_s[k] = stage_idle_s.get(k, 0.0) + (e - s) * 1e-9
    return span_host_s, stage_device_s, stage_syncs, stage_idle_s


def read(prof, frames: int) -> Stages:
    """The slice that ``devtrace.SLICE`` spans in ``prof``, by stage; its
    window, device activity, blocking calls and idle gaps are those that
    ``devtrace.read`` counts."""
    from benchmark import devtrace

    events = prof.profiler.kineto_results.events()
    mark = next(e for e in events if e.name() == devtrace.SLICE
                and devtrace._kind(e) == "user_annotation")
    lo, hi = mark.start_ns(), mark.end_ns()
    thread = mark.start_thread_id()
    device, spans, launches, activities, syncs = [], [], [], [], []
    for e in events:
        kind = devtrace._kind(e)
        s, end = e.start_ns(), e.end_ns()
        if kind in LAUNCH_CALLS:
            launches.append((s, e.correlation_id()))
        if kind in devtrace.DEVICE_ACTIVITIES:
            s, end = max(s, lo), min(end, hi)
            if end > s:
                device.append((s, end))
                activities.append((e.correlation_id(), end - s))
        elif kind in devtrace.HOST_ACTIVITIES and lo <= s < hi:
            if kind == "cuda_runtime" and e.name() in devtrace.SYNC_CALLS:
                syncs.append(s)
            if (kind == "user_annotation" and e.name().startswith(SPAN)
                    and e.start_thread_id() == thread):
                spans.append((s, end, e.name()))
    gaps, prev = [], lo
    for s, end in devtrace._merge(device):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, end)
    if hi > prev:
        gaps.append((prev, hi))
    return Stages(frames, *stage_tables(spans, launches, activities, syncs,
                                        gaps))


def trace_slice(cell, seed: int, device) -> tuple:
    """The cell's warm-up and the window's frames before the traced slice,
    as ``harness.run_cell`` renders them, then the slice under the
    profiler. Returns (``devtrace.Slice``, :class:`Stages`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import devtrace, harness

    loop = harness.Frames(cell, seed, device, harness.Run(cell=cell))
    for k in range(cell.traffic["warmup_frames"]):
        loop.step()
        if k == 0 and loop.editor is not None and loop.editor.refit_in_flight:
            loop.edit_step(block=True)
    for _ in range(harness.SLICE_START):
        loop.step()
    frames = cell.traffic["trace_frames"]
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(devtrace.SLICE):
            for _ in range(frames):
                loop.step(record_function)
    return devtrace.read(prof, frames), read(prof, frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("stages: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    if cell.sharded:
        print("stages: a ray-sharded cell is traced by run.py --trace 1 "
              "alone (rank 0's slice)", file=sys.stderr)
        return 2
    sl, st = trace_slice(cell, args.seed, torch.device("cuda", 0))
    out = dict(workload=args.workload, seed=args.seed, frames=st.frames,
               device_total_ms=1e3 * sum(sl.device_ops.values()) / sl.frames,
               traced_frame_ms=1e3 * sl.wall_s / sl.frames,
               **st.per_frame())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
