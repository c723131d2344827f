"""Observability (counterpart of ``apex_tpu/prof``): the overflow and
underflow censuses of ``numerics`` and the pending-notes channel of
``metrics``. Names import lazily."""

from __future__ import annotations

import importlib

_EXPORTS = {"TreeMeta": "numerics", "tree_meta": "numerics",
            "GradCensus": "numerics", "grad_census": "numerics",
            "empty_census": "numerics", "select_census": "numerics",
            "culprit_table": "numerics", "UnderflowCensus": "numerics",
            "underflow_census": "numerics", "underflow_summary": "numerics",
            "hist_labels": "numerics", "HIST_EDGES_LOG2": "numerics",
            "note_kind": "metrics"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
