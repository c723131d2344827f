"""Kernel dispatch — counterpart of ``apex_tpu/ops/dispatch.py``.

The rule is fixed by the tensor, not by a crossover: a kernel wrapper runs
the plain PyTorch version for a tensor on the CPU and launches its hand
kernel for a tensor on the card (or raises if the kernel does not take the
dtype or shape). There is no measured crossover and no fallback.

One switch remains: ``with dispatch.backend("reference"):`` forces the
plain versions on the card, so ``chip_smoke.py`` and tests can hold a
kernel against its plain version on the same inputs. The switch is
process-wide, not per thread or context: PyTorch runs the backward of a
CUDA graph on its own device thread, which a context variable set by the
caller does not reach, so the plain run's backward would launch kernels.
"""

from __future__ import annotations

import contextlib

import torch

_VALID = ("auto", "reference")

_state = {"backend": "auto"}


def get_backend() -> str:
    return _state["backend"]


@contextlib.contextmanager
def backend(name: str):
    """Temporarily force a backend: ``"reference"`` runs every plain
    version, ``"auto"`` is the default rule."""
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}, got {name!r}")
    prev = _state["backend"]
    _state["backend"] = name
    try:
        yield
    finally:
        _state["backend"] = prev


def use_kernel(t: torch.Tensor) -> bool:
    """True when a wrapper must launch its kernel for ``t``: ``t`` lies on
    the card and the plain versions are not forced."""
    return t.is_cuda and _state["backend"] != "reference"
