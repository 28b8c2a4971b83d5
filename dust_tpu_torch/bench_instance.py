"""Every launch of the single-instance HDDA kernel in a loop-route frame,
timed on the card, for one or more builds of the kernel.

Usage, from the root of a checkout, on a CUDA device:
  python -m dust_tpu_torch.bench_instance [--source A.cu --source B.cu]
      [--probe] [--out build/bench_instance/result.json]

1. Records every ``hdda_instance`` launch of one stress frame (bench.py
   --config stress: 3x3 castles + 2 teapots, 11 instances, 1920x1080)
   and of one edits frame (bench_edits' castle + teapot, 2 instances),
   both on the loop route (``DUST_PALLAS_SCENE=loop``): 66 and 12
   launches.
2. Builds each ``--source`` (default: the package's ``csrc/hdda.cu``)
   through :func:`dust_tpu_torch.csrc.build`, with the package's nvcc
   flags, and prints each instance kernel's registers, stack and spills
   (ptxas -v).
3. Times every launch for every source from a CUDA-graph replay, the
   sources in turns (A, B, ..., B, A), and each mode's launches of a
   frame replayed back to back from one graph. Prints per launch the
   mode, instance, rays, active rays (not s_min >= s_stop) and
   chip_smoke.py's bound (what each ray needs), and per mode the sums.
4. Holds every source's outputs equal (torch.equal) to the first
   source's on every launch, and the first source's to the plain
   version on the busiest launch (the most active rays) of each mode.
5. With ``--probe``: builds an instrumented copy of each source (made
   from its text into ``build/``; the instrumentation lives only here)
   and, on the busiest stress launch of each mode, reports the active
   lanes per warp step of the walk (``__activemask()`` at every march
   iteration, in-cell sub-step and micro step) and, from
   ``%globaltimer`` around each active ray's walk, each block's tail (its
   last walk's end less the mean end of its walks) and the launch's (the
   last 1% of the walks to end).

Numbers are printed with the card's name and power limit and written as
JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import io
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "dust_tpu_torch" / "csrc" / "hdda.cu"
BUILD = REPO / "build" / "bench_instance"


def _smoke():
    """chip_smoke.py's helpers (frame set-up, recording, timing, bound)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


# ---------------------------------------------------------------------------
# Builds
# ---------------------------------------------------------------------------

# The instrumentation: each (anchor, replacement) must match exactly once.
_PROBE_HEAD = r"""namespace {

// ---- probe (bench_instance --probe) ----
__device__ unsigned long long* g_probe_steps;  // per warp: steps, lanes
__device__ unsigned long long* g_probe_time;   // per thread: start, end, block
__device__ __forceinline__ unsigned long long probe_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void probe_step() {
  if (g_probe_steps == nullptr) return;
  const unsigned am = __activemask();
  if ((threadIdx.x & 31) == __ffs(am) - 1) {
    const size_t w = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5;
    atomicAdd(g_probe_steps + 2 * w, 1ull);
    atomicAdd(g_probe_steps + 2 * w + 1, (unsigned long long)__popc(am));
  }
}
"""

_PROBE_WRAP = r"""template <int MODE>
__device__ CoreOut traverse(const Ray& ray, const int* __restrict__ l1,
                            const int4* __restrict__ l2,
                            const int2* __restrict__ mask, float s_min,
                            float s_stop, float s_ao, int rounds) {
  const unsigned long long t0 = probe_clock();
  const CoreOut c = traverse_body<MODE>(ray, l1, l2, mask, s_min, s_stop,
                                        s_ao, rounds);
  if (g_probe_time != nullptr && !(s_min >= s_stop)) {
    const size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    atomicMin(g_probe_time + 3 * t, t0);
    atomicMax(g_probe_time + 3 * t + 1, probe_clock());
    g_probe_time[3 * t + 2] = blockIdx.x;
  }
  return c;
}

template <int MODE>
__device__ void trace_ray("""

_PROBE_SET = r"""
extern "C" int probe_set(void* steps, void* times, void* /*stream*/) {
  cudaMemcpyToSymbol(g_probe_steps, &steps, sizeof(void*));
  cudaMemcpyToSymbol(g_probe_time, &times, sizeof(void*));
  return static_cast<int>(cudaGetLastError());
}
"""

_PROBE_PATCH = [
    ("namespace {\n", _PROBE_HEAD),
    ("__device__ CoreOut traverse(const Ray& ray,",
     "__device__ CoreOut traverse_body(const Ray& ray,"),
    ("template <int MODE>\n__device__ void trace_ray(", _PROBE_WRAP),
    ("    for (int it = 0; it < kMarchCap && active && !cand; ++it) {\n",
     "    for (int it = 0; it < kMarchCap && active && !cand; ++it) {\n"
     "      probe_step();\n"),
    ("      for (int ss = 0; ss < Traits<MODE>::kSub; ++ss) {\n",
     "      for (int ss = 0; ss < Traits<MODE>::kSub; ++ss) {\n"
     "        probe_step();\n"),
    ("  for (int it = 0; it < kMicroCap; ++it) {\n",
     "  for (int it = 0; it < kMicroCap; ++it) {\n    probe_step();\n"),
]


def instrument(text: str) -> str:
    """The probe copy of a kernel source (see the module docstring)."""
    for old, new in _PROBE_PATCH:
        if text.count(old) != 1:
            raise ValueError(f"probe anchor found {text.count(old)} times: "
                             f"{old!r}")
        text = text.replace(old, new)
    return text + _PROBE_SET


def ptxas_table(err: str) -> dict:
    """{kernel: registers, stack, spill stores, spill loads} from nvcc's
    -Xptxas -v report."""
    rows, name = {}, None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.setdefault(name, {})["registers"] = int(m.group(1))
    return rows


class Build:
    """One source's library (:class:`dust_tpu_torch.csrc.Library`), built
    with the package's flags; ``ptxas`` is its ptxas report's table.
    :meth:`launcher` launches its
    ``hdda_instance_launch``, whose parameters are read from the source (a
    ``scratch`` pointer where it takes one: the designs with a queue in
    device memory, PERF.md section 6)."""

    def __init__(self, label, source, stem):
        from dust_tpu_torch import csrc

        self.label = label
        text = Path(source).read_text()
        m = re.search(r'extern "C" int hdda_instance_launch\((.*?)\)', text,
                      re.S)
        self.scratch = "scratch" in m.group(1)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.launches = collections.Counter()
        entries = {"hdda_instance_launch": (
            [ci] + [vp] * 12 + [ci, ci] + ([vp] if self.scratch else []),
            self.launches)}
        if "probe_set(" in text:
            entries["probe_set"] = ([vp, vp], self.launches)
        self.lib = csrc.Library(Path(source).resolve(), stem, entries)
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            self.lib.build(verbose=True)
        self.ptxas = ptxas_table(report.getvalue())

    def launcher(self, rec):
        """A function that launches ``rec`` into outputs allocated once;
        it returns them."""
        from dust_tpu_torch.ops import hdda

        l1, l2, mask, o, d, s_min, s_stop, s_ao = rec["args"]
        n, dev = o.shape[0], o.device
        fused = rec["mode"] == "ao_fg"
        s0 = torch.empty(n, dtype=torch.float32, device=dev)
        row = torch.empty(n, dtype=torch.int32, device=dev)
        s1 = torch.empty(n, dtype=torch.float32, device=dev) if fused else None
        bit = None if fused else torch.empty(n, dtype=torch.int32, device=dev)
        scratch = (torch.empty(n + 1, dtype=torch.int32, device=dev)
                   if self.scratch else None)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        head = [hdda.MODES.index(rec["mode"]), ptr(l1), ptr(l2), ptr(mask),
                ptr(o), ptr(d), ptr(s_min), ptr(s_stop),
                ptr(s_ao if fused else None), ptr(s0), ptr(s1), ptr(row),
                ptr(bit), n, hdda.ROUNDS]
        tail = [ptr(scratch)] if self.scratch else []
        outs = (s0, s1, row) if fused else (s0, row, bit)

        def go():
            self.lib.launch("hdda_instance_launch", *head, *tail, device=dev,
                            count=rec["mode"])
            return outs

        return go

    def probe_set(self, steps, times, dev):
        """Point the probe's buffers at ``steps`` and ``times`` (or off)."""
        self.lib.launch("probe_set", steps, times, device=dev,
                        count="probe_set")


def build_all(sources, probe=False):
    """Builds every source (with ``probe``, its instrumented copy, written
    into ``build/``); returns a :class:`Build` per source."""
    BUILD.mkdir(parents=True, exist_ok=True)
    builds = []
    for i, src in enumerate(sources):
        stem = Path(src).stem
        if probe:
            stem += "_probe"
            copy = BUILD / f"{i}_{stem}.cu"
            copy.write_text(instrument(Path(src).read_text()))
            builds.append(Build(str(src), copy, stem))
        else:
            builds.append(Build(str(src), src, stem))
    return builds


# ---------------------------------------------------------------------------
# The frames' launches
# ---------------------------------------------------------------------------

def record_loop_frame(smoke, render, n_inst, frame):
    """Every ``hdda_instance`` launch of ``render()`` (after one warm-up
    call) on the loop route: [{frame, mode, trace, inst, args (the
    wrapper's 8)}], instances in index order within each trace."""
    from dust_tpu_torch.ops import hdda

    launches = []
    os.environ["DUST_PALLAS_SCENE"] = "loop"
    try:
        render()
        smoke._recording(hdda, "hdda_instance",
                         smoke._record_instance_launches(launches), render)
    finally:
        os.environ.pop("DUST_PALLAS_SCENE", None)
    torch.cuda.synchronize()
    recs, seen = [], dict.fromkeys(hdda.MODES, 0)
    for mode, args in launches:
        k = seen[mode]
        seen[mode] += 1
        recs.append(dict(frame=frame, mode=mode, trace=k // n_inst,
                         inst=k % n_inst, args=args))
    return recs


def frames(smoke, dev):
    """The stress frame's and the edits frame's launches."""
    from dust_tpu_torch import bench_edits

    stress = smoke._setup(dev, smoke.WIDTH, smoke.HEIGHT, "stress")
    counter = iter(range(1000))
    recs = record_loop_frame(
        smoke, lambda: smoke._render(stress, next(counter), stress["state"]),
        stress["scene"].num_instances, "stress")
    del stress
    edits = bench_edits.setup(dev)
    recs += record_loop_frame(smoke, lambda: bench_edits.render(edits),
                              edits["scene"].num_instances, "edits")
    return recs


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_launches(smoke, builds, recs):
    """Per launch, each build's ms (the mean of its two turns, A B .. B A),
    and each build's outputs held equal to the first build's."""
    order = list(range(len(builds))) + list(reversed(range(len(builds))))
    for rec in recs:
        gos = [b.launcher(rec) for b in builds]
        ms = [[] for _ in builds]
        for b in order:
            ms[b].append(smoke._kernel_ms(gos[b]))
        rec["ms"] = [sum(v) / len(v) for v in ms]
        first = gos[0]()
        for b, go in enumerate(gos[1:], 1):
            for x, y in zip(first, go()):
                if not torch.equal(x, y):
                    raise SystemExit(f"{builds[b].label} differs from "
                                     f"{builds[0].label} on {rec['frame']} "
                                     f"{rec['mode']} instance {rec['inst']}")


def time_frames(smoke, builds, recs):
    """{frame: {mode: [ms per build]}}: each mode's launches of a frame in
    frame order, replayed back to back from one CUDA graph."""
    out = {}
    order = list(range(len(builds))) + list(reversed(range(len(builds))))
    for frame in dict.fromkeys(r["frame"] for r in recs):
        out[frame] = {}
        for mode in dict.fromkeys(r["mode"] for r in recs):
            group = [r for r in recs if r["frame"] == frame
                     and r["mode"] == mode]
            ms = [[] for _ in builds]
            for b in order:
                gos = [builds[b].launcher(r) for r in group]
                ms[b].append(smoke._kernel_ms(lambda: [g() for g in gos]))
                del gos
            out[frame][mode] = [sum(v) / len(v) for v in ms]
    return out


def busiest(recs, frame):
    """{mode: the launch of ``frame`` with the most active rays}."""
    out = {}
    for r in recs:
        if r["frame"] == frame and (r["mode"] not in out or r["active"]
                                    > out[r["mode"]]["active"]):
            out[r["mode"]] = r
    return out


def hold_plain(builds, recs):
    """The first build against the plain version on the busiest launch of
    each mode of each frame (torch.equal)."""
    from dust_tpu_torch.ops import hdda

    for frame in dict.fromkeys(r["frame"] for r in recs):
        for mode, rec in busiest(recs, frame).items():
            k = builds[0].launcher(rec)()
            p = hdda.hdda_instance_plain(*rec["args"], mode)
            if not all(torch.equal(a, b) for a, b in zip(k, p)):
                raise SystemExit(f"{builds[0].label} differs from the plain "
                                 f"version on {frame} {mode}")
            print(f"{frame} {mode} busiest launch ({rec['active']} active of "
                  f"{rec['n']}): {builds[0].label} equal to the plain version")


# ---------------------------------------------------------------------------
# Probe
# ---------------------------------------------------------------------------

def probe(build, rec):
    """Active lanes per warp step, and the blocks' and the launch's tails
    (see the module docstring), of ``build`` (an instrumented copy) on
    ``rec``."""
    n = rec["n"]
    dev = rec["args"][3].device
    threads = n + 132 * 2048 + 1024
    go = build.launcher(rec)
    go()
    steps = torch.zeros(2 * (threads // 32 + 1), dtype=torch.int64,
                        device=dev)
    build.probe_set(steps.data_ptr(), None, dev)
    go()
    torch.cuda.synchronize()
    build.probe_set(None, None, dev)
    st = steps.view(-1, 2).cpu().numpy()
    st = st[st[:, 0] > 0]
    per_warp = st[:, 1] / st[:, 0]
    times = torch.zeros(3 * threads, dtype=torch.int64, device=dev)
    times.view(-1, 3)[:, 0] = -1          # atomicMin's start (UINT64_MAX)
    build.probe_set(None, times.data_ptr(), dev)
    go()
    torch.cuda.synchronize()
    build.probe_set(None, None, dev)
    t = times.view(-1, 3).cpu().numpy()
    t = t[t[:, 0] != -1]
    start, end, block = t[:, 0], t[:, 1], t[:, 2]
    t0 = start.min()
    span = float(end.max() - t0)
    order = np.argsort(block, kind="stable")
    blk, first = np.unique(block[order], return_index=True)
    b_start = np.minimum.reduceat(start[order], first)
    b_end = np.maximum.reduceat(end[order], first)
    b_mean = np.add.reduceat(end[order].astype(np.float64), first) / np.diff(
        np.append(first, len(order)))
    b_span = (b_end - b_start).astype(np.float64)
    b_tail = (b_end - b_mean) / np.maximum(b_span, 1.0)
    q = lambda a: [float(x) for x in np.percentile(a, [50, 90, 100])]  # noqa
    return dict(
        warp_steps=int(st[:, 0].sum()),
        lanes_per_step=float(st[:, 1].sum() / max(st[:, 0].sum(), 1)),
        simt_efficiency=float(st[:, 1].sum() / max(32 * st[:, 0].sum(), 1)),
        lanes_per_step_by_warp_p10_p50_p90=[
            float(x) for x in np.percentile(per_warp, [10, 50, 90])],
        walks=int(len(start)), blocks=int(len(blk)),
        launch_span_us=span / 1e3,
        last_1pct_of_walks_us=float(end.max() - np.percentile(end, 99)) / 1e3,
        block_span_us_p50_p90_max=[x / 1e3 for x in q(b_span)],
        block_tail_share_p50_p90_max=q(b_tail))


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--source", action="append", default=[],
                    help="a CUDA source with hdda_instance_launch "
                         "(repeatable; default: the package's)")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--out", default=str(BUILD / "result.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_instance: no CUDA device", file=sys.stderr)
        return 1
    from dust_tpu_torch import bench

    smoke = _smoke()
    card = bench.card_name()
    print(card)
    dev = torch.device(smoke.DEVICE)
    sources = args.source or [str(SOURCE)]
    builds = build_all(sources)
    for b in builds:
        for name, row in b.ptxas.items():
            if "instance" in name:
                print(f"ptxas {Path(b.label).name} {name}: {row}")
    recs = frames(smoke, dev)
    for r in recs:
        r["n"] = r["args"][3].shape[0]
        r["bytes"], r["active"] = smoke._instance_bytes(r["args"], r["mode"])
        r["bound_ms"] = smoke._instance_bound(r["args"], r["mode"])[0]
    hold_plain(builds, recs)
    time_launches(smoke, builds, recs)
    labels = [Path(b.label).name for b in builds]
    print(f"per launch, ms for {', '.join(labels)} [{card}]:")
    for r in recs:
        print(f"  {r['frame']:6s} {r['mode']:12s} trace {r['trace']} inst "
              f"{r['inst']:2d}: {r['n']} rays, {r['active']} active, bound "
              f"{r['bound_ms']:.4f} ms; "
              + ", ".join(f"{m:.4f}" for m in r["ms"]))
    graphs = time_frames(smoke, builds, recs)
    summary = {}
    for frame, by_mode in graphs.items():
        summary[frame] = {}
        for mode, g_ms in by_mode.items():
            group = [r for r in recs if r["frame"] == frame
                     and r["mode"] == mode]
            sums = [sum(r["ms"][b] for r in group) for b in range(len(builds))]
            bound = sum(r["bound_ms"] for r in group)
            summary[frame][mode] = dict(
                launches=len(group), bound_ms=bound, sum_ms=sums,
                graph_ms=g_ms, active=sum(r["active"] for r in group))
            print(f"{frame} {mode}: {len(group)} launches, bound {bound:.4f} "
                  f"ms; summed " + ", ".join(
                      f"{labels[b]} {sums[b]:.4f} ({100 * bound / sums[b]:.1f}"
                      f"%)" for b in range(len(builds)))
                  + "; one graph " + ", ".join(f"{m:.4f}" for m in g_ms)
                  + f" ms [{card}]")
    result = dict(card=card, sources=labels,
                  ptxas={labels[i]: b.ptxas for i, b in enumerate(builds)},
                  summary=summary,
                  launches=[{k: v for k, v in r.items() if k != "args"}
                            for r in recs])
    if args.probe:
        del builds
        probes = build_all(sources, probe=True)
        result["probe"] = {}
        for b, label in zip(probes, labels):
            result["probe"][label] = {}
            for mode, rec in busiest(recs, "stress").items():
                p = probe(b, rec)
                result["probe"][label][mode] = p
                print(f"probe {label} stress {mode} busiest ({rec['active']} "
                      f"active): {json.dumps(p)}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"written to {args.out} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
