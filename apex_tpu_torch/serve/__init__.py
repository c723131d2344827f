"""Serving tier of the port (counterpart of ``apex_tpu/serve``): the slot
KV pool (dense and paged), the continuous-batching engine, fused and
serialized, with speculative decoding and the shared-prefix page cache,
its device programs as CUDA graphs (``serve.programs``), synthetic
traffic with the ``serving`` summary and its span-derived views, and the
multi-replica router tier (``serve.router``: policies, admission,
autoscaler, in-process and socket replicas).

Names import lazily, as ``prof`` does: ``serve.router`` and
``serve.prefix`` are stdlib only, so a process that hosts the router
(the socket transport's parent) loads no torch."""

from __future__ import annotations

import importlib

_EXPORTS = {"ContinuousBatchingEngine": "engine", "Request": "engine",
            "RequestResult": "engine", "draft_from_prefix": "engine",
            "PrefixCache": "prefix", "chain_hashes": "prefix",
            "prefix_route_key": "prefix",
            "PagedSlotState": "slots", "PagePool": "slots",
            "SlotState": "slots", "arena_byte_report": "slots",
            "init_cache_arena": "slots", "init_paged_state": "slots",
            "init_slot_state": "slots",
            "parse_dist": "traffic", "poisson_requests": "traffic",
            "summarize_serving": "traffic",
            "request_phases_from_spans": "traffic",
            "serving_percentiles_from_spans": "traffic",
            "tail_attribution": "traffic",
            "Router": "router", "RouterFeed": "router",
            "EngineReplica": "router", "AdmissionController": "router",
            "OccupancyScaler": "router", "merge_router_run": "router"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
