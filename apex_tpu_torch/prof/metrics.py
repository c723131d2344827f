"""Telemetry notes — the part of ``apex_tpu/prof/metrics.py`` the fp16_utils
path and ``prof.slo``'s logger-less alerts use: the record kinds (:131-135)
and ``note_kind`` with its list of pending notes (:235-252). With no logger
to flush them, notes wait in the list (the newest 256), as in the JAX
package; the sidecar logger comes with the rest of ``prof/``."""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

__all__ = ["note_kind"]

_KINDS = ("header", "step", "event", "amp", "compile", "recompile",
          "memory", "collectives", "stall", "close",
          "amp_overflow", "numerics", "fleet_skew", "desync",
          "serving", "span", "alert", "snapshot", "restore",
          "live_drop", "router", "flightrec")

_PENDING_NOTES: deque = deque(maxlen=256)


def note_kind(kind: str, name: Optional[str] = None, **fields) -> None:
    """Queue a record of ``kind`` for whichever logger flushes next — the
    channel the legacy FP16_Optimizer and fp16_utils scalers use for their
    ``amp_overflow`` records."""
    if kind not in _KINDS:
        raise ValueError(f"unknown record kind {kind!r}")
    _PENDING_NOTES.append((time.time(), kind, name, fields))
