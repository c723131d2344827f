"""Observability (counterpart of ``apex_tpu/prof``): the overflow and
underflow censuses of ``numerics``, the pending-notes channel of
``metrics``, the request-lifecycle span tracer of ``spans``, the in-run
SLO monitor of ``slo`` and the live fleet plane of ``live`` (the router
tier's alert sources). Names import lazily; ``spans``, ``slo`` and
``live`` are stdlib only, so importing them loads no torch."""

from __future__ import annotations

import importlib

_EXPORTS = {"TreeMeta": "numerics", "tree_meta": "numerics",
            "GradCensus": "numerics", "grad_census": "numerics",
            "empty_census": "numerics", "select_census": "numerics",
            "culprit_table": "numerics", "UnderflowCensus": "numerics",
            "underflow_census": "numerics", "underflow_summary": "numerics",
            "hist_labels": "numerics", "HIST_EDGES_LOG2": "numerics",
            "note_kind": "metrics",
            "SpanTracer": "spans", "merge_process_traces": "spans",
            "merged_chrome_trace": "spans",
            "write_merged_chrome_trace": "spans",
            "SLOMonitor": "slo", "SLORule": "slo",
            "parse_slo_rules": ("slo", "parse_rules"),
            "LiveCollector": "live", "LiveEmitter": "live"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        mod, attr = _EXPORTS[name], name
        if isinstance(mod, tuple):
            mod, attr = mod
        return getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
