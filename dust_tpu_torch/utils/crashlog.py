"""Crash telemetry, the analog of the sentry crate (port of
:mod:`dust_tpu.utils.crashlog`).

Reference: ``crates/sentry``: sentry SDK init, GPU context enrichment, a
DEVICE_LOST hook that captures a GPU crash dump and exits. Here: an
excepthook that writes a crash report (exception, CUDA device context,
engine config, recent log records) to a local file; no network, no SDK.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
import tempfile
import traceback

__all__ = ["install", "capture"]

_context: dict = {}
_LOG_RING: list[str] = []
_MAX_LOGS = 200


class _RingHandler(logging.Handler):
    def emit(self, record):
        _LOG_RING.append(self.format(record))
        del _LOG_RING[:-_MAX_LOGS]


def _device_context() -> dict:
    """GPU-context enrichment (sentry/src/lib.rs:100-190): the CUDA
    devices' names and compute capabilities, and the versions. A query
    that fails (device lost, a CUDA error) is reported as ``error``: the
    report is written all the same."""
    try:
        import torch

        devices = []
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                devices.append({
                    "name": torch.cuda.get_device_name(i),
                    "capability": list(torch.cuda.get_device_capability(i)),
                    "id": i})
        return {
            "cuda_available": torch.cuda.is_available(),
            "count": len(devices),
            "devices": devices,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
        }
    except Exception as e:  # device lost / CUDA init failure
        return {"error": repr(e)}


def capture(exc_type=None, exc=None, tb=None, extra: dict | None = None,
            directory: str | None = None) -> str:
    """Write a crash report into ``directory`` (the temporary directory by
    default); returns the file path."""
    directory = directory or tempfile.gettempdir()
    report = {
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "exception": "".join(
            traceback.format_exception(exc_type, exc, tb)
        ) if exc_type else None,
        "device": _device_context(),
        "context": dict(_context, **(extra or {})),
        "recent_logs": list(_LOG_RING),
        "argv": sys.argv,
        "pid": os.getpid(),
    }
    path = os.path.join(
        directory, f"dust_tpu_torch_crash_{os.getpid()}_"
        f"{int(datetime.datetime.now().timestamp())}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return path


def install(context: dict | None = None, directory: str | None = None) -> None:
    """Install the excepthook and the log capture (SentryPlugin analog)."""
    _context.update(context or {})
    handler = _RingHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logging.getLogger().addHandler(handler)

    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            path = capture(exc_type, exc, tb, directory=directory)
            print(f"[dust_tpu_torch] crash report written to {path}",
                  file=sys.stderr)
        finally:
            prev(exc_type, exc, tb)

    sys.excepthook = hook
