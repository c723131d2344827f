"""Parallelism (counterpart of ``apex_tpu/parallel``). Ported so far: the
local training core of ``SyncBatchNorm``. Names import lazily."""

from __future__ import annotations

import importlib

_EXPORTS = {"SyncBatchNorm": "sync_batchnorm"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
