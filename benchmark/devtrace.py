"""The device trace of a traced run: ``torch.profiler`` over a short
steady slice of the window, read in memory (nothing is written to disk).
What it yields: the slice's wall time, the seconds in which a kernel or
a copy ran on the card, every device operation's time by name, the
HDDA kernels' time and count, the host calls that block on the device,
and the idle gaps by what the host was doing when each began."""

from __future__ import annotations

import dataclasses
import re

from torch.autograd import DeviceType

SLICE = "bench.slice"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# Runtime calls after which the host holds until the device has caught up.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
HDDA_MARK = "hdda"
# Host events that name what the host was doing in an idle gap.
LABELS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class Slice:
    frames: int
    wall_s: float
    busy_s: float
    kernels: int
    kernel_s: float
    device_ops: dict        # name -> seconds on the card
    hdda_s: float
    hdda_kernels: int
    host_syncs: int
    idle_gaps: dict         # what the host was doing -> idle seconds

    def top(self, table: dict, k: int = 10) -> list:
        return [[name, s] for name, s in
                sorted(table.items(), key=lambda kv: -kv[1])[:k]]


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters, the
    functor it applies kept: ``elementwise_kernel[MulFunctor]``."""
    base = re.sub(r"^void |\(anonymous namespace\)::|at::native::|std::", "",
                  name)
    head = re.split(r"[<(]", base, maxsplit=1)[0].strip()
    functors = re.findall(r"(\w+Functor\w*|direct_copy_kernel_cuda|"
                          r"\w+_kernel_impl\w*)", base[len(head):])
    inner = [f for f in functors if "Functor" in f or "copy" in f]
    return f"{head}[{inner[-1]}]" if inner else head


def _merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _label_gaps(host, gaps) -> dict:
    """Idle seconds by the innermost host event open on the slice's
    thread where each gap begins (host events of one thread nest)."""
    points = sorted((g[0], g[1] - g[0]) for g in gaps)
    events = sorted(host)
    out: dict = {}
    stack: list = []
    i = 0
    for t, length in points:
        while i < len(events) and events[i][0] <= t:
            s, e, name = events[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        label = stack[-1][2] if stack else "(outside any host event)"
        out[label] = out.get(label, 0.0) + length * 1e-9
    return out


def _kind(e) -> str:
    """An event's activity, as the trace's categories name it (read from
    the device and the name where the profiler does not give it)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    annotation = e.is_user_annotation() or name.startswith("bench.")
    if e.device_type() == DeviceType.CUDA:
        if annotation:
            return "gpu_user_annotation"
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def read(prof, frames: int) -> Slice:
    """The slice that the ``SLICE`` annotation spans in ``prof``."""
    events = prof.profiler.kineto_results.events()
    mark = next(e for e in events if e.name() == SLICE
                and _kind(e) == "user_annotation")
    lo, hi = mark.start_ns(), mark.end_ns()
    thread = mark.start_thread_id()
    device, host = [], []
    ops: dict = {}
    kernels = hdda_kernels = syncs = 0
    hdda_ns = kernel_ns = 0
    for e in events:
        kind = _kind(e)
        s, e_end = e.start_ns(), e.end_ns()
        if kind in DEVICE_ACTIVITIES:
            s, e_end = max(s, lo), min(e_end, hi)
            if e_end <= s:
                continue
            name = short_name(e.name())
            device.append((s, e_end))
            ops[name] = ops.get(name, 0.0) + (e_end - s) * 1e-9
            if kind == "kernel":
                kernels += 1
                kernel_ns += e_end - s
                if HDDA_MARK in e.name():
                    hdda_kernels += 1
                    hdda_ns += e_end - s
        elif kind in HOST_ACTIVITIES and lo <= s < hi:
            if kind == "cuda_runtime" and e.name() in SYNC_CALLS:
                syncs += 1
            if kind in LABELS and e.start_thread_id() == thread:
                host.append((s, e_end, e.name()))
    busy = _merge(device)
    gaps, prev = [], lo
    for s, e_end in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e_end)
    if hi > prev:
        gaps.append((prev, hi))
    return Slice(frames=frames, wall_s=(hi - lo) * 1e-9,
                 busy_s=sum(e - s for s, e in busy) * 1e-9, kernels=kernels,
                 kernel_s=kernel_ns * 1e-9,
                 device_ops=ops, hdda_s=hdda_ns * 1e-9,
                 hdda_kernels=hdda_kernels, host_syncs=syncs,
                 idle_gaps=_label_gaps(host, gaps))
