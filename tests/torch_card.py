"""What the tests that hold the port's kernels on the card share:
``chip_smoke.py``'s equality helpers, loaded as a module, and the
``card`` fixture. Those tests run on the card with ``--noconftest``
(``tests/conftest.py`` imports jax, which the card's machine may lack),
so this is a module of its own, imported by its top-level name; it
imports nothing of jax."""

from __future__ import annotations

import functools
import importlib.util
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def chip_smoke():
    """``chip_smoke.py`` (at the root of the repo) as a module, loaded
    once a process."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def card():
    """The CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
