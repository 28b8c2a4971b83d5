"""How the port's hand-written native libraries are built, loaded,
launched and counted.

:func:`build` compiles a library at first use into
``build/dust_tpu_torch/lib<stem>_<tag>.so``, ``tag`` hashed from the
source and the flags, so an edited source or flag rebuilds and nothing
else does: the CUDA sources of this directory with :data:`NVCC_FLAGS`
(every kernel's bit parity with its plain version rests on their
``-fmad=false``), ``native``'s ``voxcore.cpp`` with g++. A
:class:`Library` binds one CUDA source's entry points at its first
launch (importing builds and loads nothing) and counts each launch in
its wrapper module's counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = ["NVCC_FLAGS", "build", "Library", "check", "on_cuda",
           "f32_recip"]

_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _DIR.parents[1] / "build" / "dust_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(source: Path, stem: str, compiler: str, flags: list[str],
          verbose: bool = False) -> Path:
    """Compile ``source`` with ``compiler`` and ``flags`` into
    ``build/dust_tpu_torch/lib<stem>_<tag>.so`` unless a library built
    from the same source and flags is already there. The library is
    written under a temporary name and renamed into place, so processes
    that build at once each load a whole file. A missing compiler raises
    ``RuntimeError`` before anything is written, a failed compile with
    the compiler's message. ``verbose`` (nvcc) compiles even so, with
    ``-Xptxas -v``, and prints the report."""
    source = Path(source)
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"lib{stem}_{tag}.so"
    if out.exists() and not verbose:
        return out
    path = shutil.which(compiler)
    if path is None:
        raise RuntimeError(f"{compiler} not found: {source.name} is built "
                           "with it")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [path, *flags, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp,
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{compiler} failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


class Library:
    """One CUDA source's library: ``source`` (a file of this directory,
    or a path), ``stem``, and for each C entry point its argument types
    before the stream that :meth:`launch` appends, and the counter dict
    its launches are counted in. An entry point returns a CUDA error
    code (0: none)."""

    def __init__(self, source: str | Path, stem: str,
                 entries: dict[str, tuple[list, dict]]):
        self.source = _DIR / source
        self.stem = stem
        self.entries = entries
        self.handle = None              # loaded at the first launch
        self._lock = threading.Lock()

    def build(self, verbose: bool = False) -> Path:
        """Compile the source with :data:`NVCC_FLAGS` (:func:`build`)."""
        return build(self.source, self.stem, _nvcc(), NVCC_FLAGS, verbose)

    def _load(self) -> ctypes.CDLL:
        with self._lock:
            if self.handle is None:
                handle = ctypes.CDLL(str(self.build()))
                for name, (argtypes, _counter) in self.entries.items():
                    fn = getattr(handle, name)
                    fn.argtypes = [*argtypes, ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                self.handle = handle
        return self.handle

    def launch(self, entry: str, *args, device: torch.device, count: str):
        """Call ``entry`` with ``args`` and the current stream of
        ``device``; raise on a CUDA error, else count a launch under
        ``count``."""
        fn = getattr(self._load(), entry)
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{entry} failed: CUDA error {err}")
        self.entries[entry][1][count] += 1


def check(name: str, t: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    """``t``, or raise: ``TypeError`` unless its dtype is ``dtype``,
    ``ValueError`` unless its shape is ``shape``, it is on ``device`` and
    contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t


def on_cuda(name: str, device: torch.device, n: int, what: str):
    """Raise ``ValueError`` unless ``device`` is a CUDA device and ``n``
    ``what`` (rays, keys) fit one launch's int32 count."""
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} {what}, more than a launch takes")


def f32_recip(x: float) -> float:
    """1 / x rounded to float32, as PyTorch's CUDA kernel takes a float32
    tensor divided by the Python number ``x``: it multiplies by this
    reciprocal."""
    return float(np.float32(1.0 / x))
