"""Tracing and profiling utilities (port of :mod:`dust_tpu.utils.profiling`).

Reference mapping: ``tracing`` spans and GPU debug labels become
``torch.profiler`` traces with named ranges; the frame-time diagnostics
(``FrameTimeDiagnosticsPlugin``) become :class:`FrameDiagnostics`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["device_sync", "best_of", "FrameDiagnostics", "trace_annotation",
           "start_trace", "stop_trace"]

log = logging.getLogger("dust_tpu_torch")


def device_sync(x: torch.Tensor) -> float:
    """Block until ``x`` is computed; returns its checksum (the sum of its
    finite values, as float32). Reading the sum back synchronises."""
    x = x.float()
    return float(torch.where(torch.isfinite(x), x, 0.0).sum())


def best_of(fn, reps: int, device):
    """Times ``fn()`` after one warm-up call: ``reps`` calls, each between
    two synchronisations of ``device``. Returns (fn's last result, the
    best host seconds of a call, the best device milliseconds between
    CUDA events recorded around a call, or None on the CPU)."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    out = fn()
    sync()
    host, dev = float("inf"), None
    for _ in range(reps):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            end.record()
        sync()
        host = min(host, time.perf_counter() - t0)
        if cuda:
            ms = start.elapsed_time(end)
            dev = ms if dev is None else min(dev, ms)
    return out, host, dev


class FrameDiagnostics:
    """Rolling frame-time statistics (logged every ``report_every``
    frames)."""

    def __init__(self, report_every: int = 60):
        self.report_every = report_every
        self._times: list[float] = []
        self._last = None

    def frame(self, sync_value=None) -> None:
        now = time.perf_counter()
        if sync_value is not None:
            device_sync(sync_value)
            now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) >= self.report_every:
                dts = self._times
                avg = sum(dts) / len(dts)
                log.info(
                    "frame time avg %.2f ms (min %.2f / max %.2f) — %.1f fps",
                    avg * 1e3, min(dts) * 1e3, max(dts) * 1e3, 1.0 / avg,
                )
                self._times = []
        self._last = now


_NO_SPAN = contextlib.nullcontext()


def trace_annotation(name: str):
    """A named range in the trace of the running ``torch.profiler`` (the
    analog of vkCmdBeginDebugUtilsLabelEXT, rhyolite/src/debug.rs:226-301):
    ``torch.profiler.record_function(name)``. With no profiler running it
    returns one shared no-op context manager, so a span costs one flag
    read and records nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


_PROFILER = None
_LOG_DIR = None


def start_trace(log_dir: str) -> None:
    """Start tracing the host and, where there is one, the CUDA device;
    :func:`stop_trace` writes the Chrome trace into ``log_dir``."""
    global _PROFILER, _LOG_DIR
    if _PROFILER is not None:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _PROFILER = torch.profiler.profile(activities=activities)
    _PROFILER.start()
    _LOG_DIR = log_dir


def stop_trace() -> str:
    """Stop the trace; returns the path of the Chrome trace it wrote."""
    global _PROFILER
    if _PROFILER is None:
        raise RuntimeError("no trace is running")
    prof, _PROFILER = _PROFILER, None
    prof.stop()
    path = os.path.join(_LOG_DIR, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
