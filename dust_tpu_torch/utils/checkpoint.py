"""Checkpoint / resume for frame state and scenes (port of
:mod:`dust_tpu.utils.checkpoint`).

A tree of the port's state (frozen dataclasses, NamedTuples, dicts,
tuples and lists, with tensors, numpy arrays and Python numbers as
leaves) is saved as a plain ``.npz``: one array per leaf, the tree's
structure as a string, and the format version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["save_state", "load_state", "FORMAT_VERSION"]

FORMAT_VERSION = 1

_NUMBERS = (bool, int, float)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: list) -> str:
    """Appends ``tree``'s leaves to ``leaves`` in order and returns its
    structure string (a leaf is ``*``)."""
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic) + _NUMBERS):
        leaves.append(tree)
        return "*"
    if tree is None or isinstance(tree, str):
        return repr(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        inner = ", ".join(f"{f.name}={_flatten(getattr(tree, f.name), leaves)}"
                          for f in dataclasses.fields(tree))
        return f"{type(tree).__name__}({inner})"
    if _is_namedtuple(tree):
        inner = ", ".join(f"{k}={_flatten(getattr(tree, k), leaves)}"
                          for k in tree._fields)
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                          for k in sorted(tree))
        return "{" + inner + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_flatten(x, leaves) for x in tree)
        return f"{type(tree).__name__}[{inner}]"
    raise TypeError(f"checkpoint: cannot store a {type(tree).__name__}")


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in order, from the iterator
    ``leaves``."""
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic) + _NUMBERS):
        return next(leaves)
    if tree is None or isinstance(tree, str):
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, k), leaves)
                            for k in tree._fields))
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return type(tree)(_unflatten(x, leaves) for x in tree)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(path: str, state) -> None:
    """Save a tree of tensors (FrameState, DeviceScene, ...) to ``.npz``."""
    leaves: list = []
    structure = _flatten(state, leaves)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
    arrays["__version__"] = np.asarray([FORMAT_VERSION], np.int32)
    np.savez_compressed(path, **arrays)


def _spec(x) -> tuple:
    """(shape, numpy dtype) of a leaf, without copying a tensor."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), torch.empty(0, dtype=x.dtype).numpy().dtype
    a = np.asarray(x)
    return a.shape, a.dtype


def _restore(arr: np.ndarray, want):
    """A loaded leaf as ``want``'s kind: a tensor on its device, a numpy
    array, or a Python number."""
    if isinstance(want, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(want.device)
    if isinstance(want, (np.ndarray, np.generic)):
        return np.array(arr, copy=True)
    return type(want)(arr.item())


def load_state(path: str, like):
    """Load a state saved by :func:`save_state`; ``like`` gives the tree's
    structure, and each tensor leaf's device.

    A checkpoint from another configuration fails loudly instead of
    loading into the wrong slots: the stored structure, every leaf's shape
    and dtype, the format version and the presence of every leaf are all
    checked before any leaf goes to a device."""
    data = np.load(path)
    if "__version__" in data:
        ver = int(data["__version__"][0])
        if ver != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format version {ver} != supported "
                f"{FORMAT_VERSION}")
    want: list = []
    structure = _flatten(like, want)
    if "__treedef__" in data:
        stored = bytes(data["__treedef__"]).decode()
        if stored != structure:
            raise ValueError(
                "checkpoint structure mismatch:\n"
                f"  stored:   {stored[:200]}\n"
                f"  expected: {structure[:200]}")
    n = len(want)
    arrays = []
    for i, w in enumerate(want):
        key = f"leaf_{i}"
        if key not in data:
            raise ValueError(f"checkpoint is missing leaf {i} of {n}")
        arr = data[key]
        shape, dtype = _spec(w)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"checkpoint leaf {i} shape {arr.shape} != expected {shape}")
        if arr.dtype != dtype:
            raise ValueError(
                f"checkpoint leaf {i} dtype {arr.dtype} != expected {dtype}")
        arrays.append(arr)
    return _unflatten(like, iter(_restore(a, w) for a, w in zip(arrays, want)))
