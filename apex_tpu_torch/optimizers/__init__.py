"""Fused optimizers over flat fp32 master buffers (counterpart of
``apex_tpu/optimizers``). Names import lazily."""

from __future__ import annotations

import importlib

_EXPORTS = {"FusedOptimizer": "base", "GroupState": "base",
            "FusedLAMB": "fused_lamb", "FusedAdam": "fused_adam",
            "FusedSGD": "fused_sgd", "FusedNovoGrad": "fused_novograd",
            "LARC": "larc"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
