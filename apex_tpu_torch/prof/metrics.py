"""Runtime telemetry — structured per-step metrics as schema-versioned JSONL
(counterpart of ``apex_tpu/prof/metrics.py``).

Every run leaves a machine-readable sidecar (``TELEM_*.jsonl``) of what
happened: per-step and interval timings and throughput, the loss scalers'
overflow, skip and growth counters, compile and recompile events, per-device
memory watermarks — the same records, kinds and keys as the JAX package's,
so ``tools/telemetry_report.py`` renders a sidecar of either.

Overhead discipline:

- ``log_step`` only appends to an in-memory buffer; nothing is formatted
  or written per step.
- a tensor argument (loss, loss scale, scaler counters) is copied on its
  device when it is logged (``detach().clone()``, asynchronous). A torch
  tensor can change after the call — a CUDA graph's outputs are static
  buffers the next replay overwrites, optimizers and scalers write in
  place — so the logger keeps its own copy, where the JAX logger can keep
  the array itself. The copies are fetched at :meth:`MetricsLogger.flush`
  only, each device's in one transfer: no host sync on the step path.
- the port's compiles are its CUDA-graph captures (``serve.programs``) and
  its ``nvcc`` builds (``ops.cuda``), reported to the installed
  :class:`CompileTracker` by :func:`record_compile` as they happen.
- memory watermarks (``torch.cuda.memory_stats``) are sampled at close.

Importing this module loads no torch; a logger consults torch only when the
program has already imported it, and the card only when CUDA is already
initialized, so writing a sidecar never starts a context.

Schema (``docs/OBSERVABILITY.md`` of the JAX package is the normative
reference): one JSON object per line, every record carrying ``{"v":
SCHEMA_VERSION, "kind": ..., "t": unix_seconds}``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

__all__ = ["SCHEMA_VERSION", "SUPPORTED_VERSIONS", "SCHEMA_NAME",
           "MetricsLogger", "CompileTracker", "validate_record",
           "read_sidecar", "default_sidecar_path", "per_process_path",
           "process_identity", "note", "note_kind", "record_compile",
           "tracked_bytes_per_device"]

# The version history is the JAX package's (apex_tpu/prof/metrics.py:59-126):
# v11 adds the ``flightrec`` kind and span trace context. Old sidecars stay
# readable — SUPPORTED_VERSIONS is the parse contract; SCHEMA_VERSION is what
# new sidecars are written at.
SCHEMA_VERSION = 11
SUPPORTED_VERSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)
SCHEMA_NAME = "apex_tpu.telemetry"

_KINDS = ("header", "step", "event", "amp", "compile", "recompile",
          "memory", "collectives", "stall", "close",
          "amp_overflow", "numerics", "fleet_skew", "desync",
          "serving", "span", "alert", "snapshot", "restore",
          "live_drop", "router", "flightrec")

# compile events (``record_compile``): a CUDA graph captured from a Python
# body stands for a jaxpr trace and a backend compile at once, an nvcc build
# for a backend compile
CAPTURE_EVENT = "/apex_tpu_torch/cuda_graph/capture_duration"
BUILD_EVENT = "/apex_tpu_torch/nvcc/build_duration"


def _torch():
    """torch if the program has imported it, else None: telemetry never
    imports it on its own."""
    return sys.modules.get("torch")


def _cuda_initialized() -> bool:
    torch = _torch()
    return torch is not None and torch.cuda.is_initialized()


def default_sidecar_path(tag: str, directory: Optional[str] = None) -> str:
    """``TELEM_<tag>_<utc>.jsonl`` in ``directory`` (the working directory
    by default). Multi-process runs additionally get a
    ``.p{process_index}`` suffix, applied by :class:`MetricsLogger`
    itself so explicit paths are covered too."""
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    base = directory or os.getcwd()
    return os.path.join(base, f"TELEM_{tag}_{stamp}.jsonl")


def process_identity(process_index: Optional[int] = None,
                     process_count: Optional[int] = None
                     ) -> "tuple[int, int]":
    """Resolve ``(process_index, process_count)`` for telemetry tagging.

    Priority: explicit arguments > an initialized ``torch.distributed``
    group of more than one process > the launcher environment
    (``RANK``/``WORLD_SIZE``) > ``(0, 1)``."""
    if process_index is not None or process_count is not None:
        return int(process_index or 0), int(process_count or 1)
    torch = _torch()
    try:
        dist = torch.distributed if torch is not None else None
        if dist is not None and dist.is_available() \
                and dist.is_initialized() and dist.get_world_size() > 1:
            return int(dist.get_rank()), int(dist.get_world_size())
    except Exception:
        pass
    try:
        pc = int(os.environ.get("WORLD_SIZE", 1))
        pi = int(os.environ.get("RANK", 0))
    except ValueError:
        return 0, 1
    return (pi, pc) if pc > 1 else (0, 1)


def per_process_path(path: str, process_index: int) -> str:
    """``TELEM_run.jsonl`` -> ``TELEM_run.p3.jsonl``: the per-process
    sidecar naming of a multi-process run (what ``telemetry_report.py
    --fleet`` pairs on). Idempotent for paths that already carry the
    suffix."""
    root, ext = os.path.splitext(path)
    tag = f".p{int(process_index)}"
    if root.endswith(tag) or f"{tag}." in os.path.basename(path):
        return path
    return root + tag + ext


def validate_record(rec: Any) -> None:
    """Raise ``ValueError`` unless ``rec`` is a well-formed telemetry
    record of a supported schema version."""
    if not isinstance(rec, dict):
        raise ValueError(f"record is not an object: {rec!r}")
    v = rec.get("v")
    if v not in SUPPORTED_VERSIONS:
        raise ValueError(f"schema version {v!r} not in "
                         f"{SUPPORTED_VERSIONS}")
    kind = rec.get("kind")
    if kind not in _KINDS:
        raise ValueError(f"unknown record kind {kind!r}")
    if not isinstance(rec.get("t"), (int, float)):
        raise ValueError(f"record missing numeric 't': {rec!r}")


def read_sidecar(path: str) -> list:
    """Parse and validate a telemetry sidecar; raises on any malformed
    line. Returns the record list (header first)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}")
            validate_record(rec)
            out.append(rec)
    if not out:
        raise ValueError(f"{path}: empty sidecar")
    if out[0]["kind"] != "header":
        raise ValueError(f"{path}: first record is {out[0]['kind']!r}, "
                         f"expected 'header'")
    return out


# Framework-internal announcement channel: subsystems with no logger
# reference (the fp16_utils scalers, a logger-less SLO monitor) drop notes
# here; any active MetricsLogger drains them into records at its next flush.
# Bounded: with no logger running, old notes fall off instead of leaking.
_PENDING_NOTES: deque = deque(maxlen=256)


def note(name: str, **fields) -> None:
    """Record a framework event for whichever telemetry logger flushes
    next (one deque append when telemetry is off)."""
    _PENDING_NOTES.append((time.time(), "event", name, fields))


def note_kind(kind: str, name: Optional[str] = None, **fields) -> None:
    """Like :func:`note` with an explicit record kind — the channel the
    legacy FP16_Optimizer and fp16_utils scalers use for ``amp_overflow``
    records identical to :meth:`MetricsLogger.log_overflow`'s."""
    if kind not in _KINDS:
        raise ValueError(f"unknown record kind {kind!r}")
    _PENDING_NOTES.append((time.time(), kind, name, fields))


def _leaves(tree) -> list:
    """The leaves of nested dicts (in sorted key order, as a JAX pytree
    flattens them), lists, tuples and dataclasses; ``None`` is no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    fields = getattr(tree, "__dataclass_fields__", None)
    if fields is not None:
        return [x for k in fields for x in _leaves(getattr(tree, k))]
    return [tree]


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``bfloat16``: the JAX package's dtype names."""
    return str(dtype).replace("torch.", "")


def _itemsize(dtype) -> int:
    size = getattr(dtype, "itemsize", None)
    if size is None:       # a numpy dtype class or name
        import numpy as np
        size = np.dtype(dtype).itemsize
    return int(size)


def tracked_bytes_per_device(tree) -> int:
    """Bytes of a tree of tensors (or arrays) on one device: each leaf's
    elements times its element size: a ZeRO rank's state is its shard, so
    the bytes are the rank's own. Metadata only — no host sync."""
    total = 0
    for x in _leaves(tree):
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is None or dtype is None:
            continue
        n = 1
        for d in tuple(shape):
            n *= int(d)
        total += n * _itemsize(dtype)
    return total


def record_compile(event: str, duration_s: float) -> None:
    """Report one compile (a CUDA-graph capture, an nvcc build) to the
    installed :class:`CompileTracker`, if any. Called where the compile
    happens; costs a lookup when no logger tracks compiles."""
    t = CompileTracker._installed
    if t is not None:
        t._on_duration(event, duration_s)


def _is_tensor(x) -> bool:
    torch = _torch()
    return torch is not None and isinstance(x, torch.Tensor)


def _snap(v, copies: list):
    """The logger's own copy of a field: tensors cloned on their device
    (asynchronous; each copy also appended to ``copies``), containers
    walked, everything else as it is."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_snap(i, copies) for i in v]
    if isinstance(v, dict):
        return {k: _snap(x, copies) for k, x in v.items()}
    if _is_tensor(v):
        c = v.detach().clone()
        copies.append(c)
        return c
    return v


def _to_python(x):
    """Host-fetch one possibly-device scalar (used where no batched fetch
    ran, as in a flight-recorder dump)."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    try:
        return float(x)
    except Exception:
        return str(x)


def _sanitize(v, fetched: Optional[dict] = None):
    """Make a buffered field JSON-ready: plain types pass through,
    containers recurse, tensors take their value from ``fetched`` (by
    ``id``, from :func:`_fetch_all`) or are fetched one by one."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_sanitize(i, fetched) for i in v]
    if isinstance(v, dict):
        return {k: _sanitize(x, fetched) for k, x in v.items()}
    if fetched is not None and id(v) in fetched:
        return fetched[id(v)]
    return _to_python(v)


def _fetch_all(found: list, streams) -> "tuple[dict, int]":
    """Fetch the logger's tensor copies ``found``: the one-element tensors
    of a device stacked as float64 (exact for the int32 counters and the
    16- and 32-bit scalars) and brought to the host in one transfer, after
    the streams that cloned them. Returns ``{id(tensor): value}`` and the
    number of transfers from a card; a tensor of more elements becomes its
    text, as ``float()`` fails on it in the JAX logger."""
    if not found:
        return {}, 0
    import torch
    out: dict = {}
    by_dev: dict = {}
    for t in found:
        if t.numel() != 1:
            out[id(t)] = str(t.detach().cpu().numpy())
        else:
            by_dev.setdefault(t.device, []).append(t)
    transfers = 0
    for dev, ts in by_dev.items():
        if dev.type == "cuda":
            cur = torch.cuda.current_stream(dev)
            for s in streams:
                if s.device == dev and s != cur:
                    cur.wait_stream(s)
            transfers += 1
        vals = torch.stack([t.reshape(()).to(torch.float64)
                            for t in ts]).cpu().tolist()
        for t, v in zip(ts, vals):
            out[id(t)] = v
    return out, transfers


class CompileTracker:
    """Count the port's compiles: CUDA-graph captures and nvcc builds,
    reported by :func:`record_compile`. One tracker is installed
    process-wide at a time; installing a new one deactivates the previous
    one, so repeated logger lifecycles do not stack."""

    _installed: "CompileTracker | None" = None
    _lock = threading.Lock()

    def __init__(self):
        self.active = True
        self.counts: dict = {}
        self.durations_s: dict = {}
        self._mu = threading.Lock()

    def _on_duration(self, event: str, duration_s: float) -> None:
        if not self.active:
            return
        with self._mu:
            self.counts[event] = self.counts.get(event, 0) + 1
            self.durations_s[event] = (
                self.durations_s.get(event, 0.0) + duration_s)

    def snapshot(self) -> dict:
        """The JAX record's keys: ``backend_compiles`` counts captures and
        builds (each makes device code), ``jaxpr_traces`` the captures (a
        Python body traced into a program)."""
        with self._mu:
            counts = dict(self.counts)
            durs = {k: round(v, 4) for k, v in self.durations_s.items()}
        captures = counts.get(CAPTURE_EVENT, 0)
        return {
            "backend_compiles": captures + counts.get(BUILD_EVENT, 0),
            "jaxpr_traces": captures,
            "counts": counts,
            "durations_s": durs,
        }

    def stop(self) -> None:
        self.active = False
        with CompileTracker._lock:
            if CompileTracker._installed is self:
                CompileTracker._installed = None

    @classmethod
    def install(cls) -> "CompileTracker":
        """Register a fresh tracker (deactivating any previous one)."""
        with cls._lock:
            if cls._installed is not None:
                cls._installed.active = False
            t = cls()
            cls._installed = t
        return t


class MetricsLogger:
    """Schema-versioned JSONL telemetry writer.

    ::

        logger = MetricsLogger("TELEM_run.jsonl", run="bench",
                               meta={"batch": 384})
        for step in range(n):
            ... train ...
            logger.log_step(step, step_ms=dt * 1e3, throughput=img_s,
                            unit="img/s", loss=loss,        # device ok
                            loss_scale=amp_state[0].scale)  # device ok
        logger.log_amp(handle.scalers[0], amp_state[0])
        logger.close()

    Tensor arguments are copied on their device when logged and fetched at
    flush boundaries only (one transfer a device per ``flush_every``
    steps), never on the step path.
    """

    def __init__(self, path: str, *, run: str = "train",
                 meta: Optional[dict] = None, flush_every: int = 50,
                 track_compiles: bool = True, tail_len: int = 32,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.process_index, self.process_count = process_identity(
            process_index, process_count)
        if self.process_count > 1:
            # every process handed the same path must not clobber its
            # peers' sidecars
            path = per_process_path(path, self.process_index)
        self.path = path
        self.run = run
        self.flush_every = max(int(flush_every), 1)
        self._buf: list = []
        self._tees: list = []
        self._mu = threading.RLock()
        self._tail: deque = deque(maxlen=tail_len)  # for stall snapshots
        self._closed = False
        self._steps_since_flush = 0
        self._last_compile_snapshot: dict = {}
        self._recompile_sigs: dict = {}
        self._copies: list = []            # tensor copies not yet fetched
        self._streams: set = set()         # streams that cloned them
        self.fetches = 0                   # device-to-host transfers made
        self.compile_tracker = (CompileTracker.install()
                                if track_compiles else None)
        # truncate: one sidecar = one run (header first, close last)
        self._fh = open(path, "w")
        header = {"schema": f"{SCHEMA_NAME}/{SCHEMA_VERSION}",
                  "run": run, "pid": os.getpid(),
                  "process_index": self.process_index,
                  "process_count": self.process_count}
        if _cuda_initialized():      # never start a context for this
            header["backend"] = "gpu"
            header["devices"] = _torch().cuda.device_count()
        if meta:
            header["meta"] = meta
        self._emit("header", header)
        self.flush()

    # -- record plumbing ---------------------------------------------------
    def add_tee(self, fn: Callable) -> None:
        """Register a per-record tee (how a ``prof.live.LiveEmitter`` and a
        ``prof.flightrec.FlightRecorder`` ride the logger). The callback
        sees every buffered record dict as buffered — tensors are the
        logger's device copies — and runs on the emitting (possibly step)
        path, so it must be O(1) and non-blocking. A raising tee is
        dropped rather than allowed to cost the run its sidecar."""
        self._tees.append(fn)

    def _emit(self, kind: str, fields: dict) -> None:
        with self._mu:
            if self._closed:
                return
            rec = {"v": SCHEMA_VERSION, "kind": kind,
                   "t": round(time.time(), 3)}
            copies: list = []
            rec.update(_snap(fields, copies))
            for t in copies:
                if t.is_cuda:         # the flush waits for these copies
                    self._streams.add(_torch().cuda.current_stream(t.device))
            self._copies.extend(copies)
            self._buf.append(rec)
        for fn in tuple(self._tees):
            try:
                fn(rec)
            except Exception:
                try:
                    self._tees.remove(fn)
                except ValueError:
                    pass

    # -- per-step ----------------------------------------------------------
    def log_step(self, step: int, *, step_ms=None, throughput=None,
                 unit: Optional[str] = None, loss=None, loss_scale=None,
                 input_wait_ms=None, steps: int = 1, **extra) -> None:
        """Buffer one step (or interval: ``steps`` > 1) record. Scalar
        arguments may be tensors — copied now, fetched at flush.

        ``input_wait_ms`` is the host-input stall accounted to this step;
        for an interval record it is the per-step mean, as ``step_ms``."""
        fields = {"step": int(step)}
        if steps != 1:
            fields["steps"] = int(steps)
        if step_ms is not None:
            fields["step_ms"] = step_ms
        if throughput is not None:
            fields["throughput"] = throughput
        if unit is not None:
            fields["unit"] = unit
        if loss is not None:
            fields["loss"] = loss
        if loss_scale is not None:
            fields["loss_scale"] = loss_scale
        if input_wait_ms is not None:
            fields["input_wait_ms"] = input_wait_ms
        fields.update(extra)
        self._emit("step", fields)
        with self._mu:
            self._steps_since_flush += 1
            if self._steps_since_flush >= self.flush_every:
                self.flush()

    def event(self, name: str, **fields) -> None:
        """Buffer a free-form event record (phase transitions, errors)."""
        self._emit("event", dict(fields, name=name))

    # -- AMP / scaler ------------------------------------------------------
    def log_amp(self, scaler, state, loss_id: int = 0) -> None:
        """Record an ``amp.scaler.ScalerState``'s event counters
        (overflow/skip/growth — device int32 scalars, copied now and
        fetched at the next flush). Call at flush boundaries, not per
        step."""
        import dataclasses as _dc
        fields = {f.name: getattr(state, f.name)
                  for f in _dc.fields(state)}
        fields["loss_scale"] = fields.pop("scale", None)
        fields = {k: v for k, v in fields.items() if v is not None}
        self._emit("amp", {"loss_id": loss_id,
                           "dynamic": bool(getattr(scaler, "dynamic",
                                                   True)), **fields})

    # -- numerics (prof.numerics, schema 2) --------------------------------
    def log_overflow(self, meta, census, *, loss_id: int = 0,
                     loss_scale=None, source: str = "amp",
                     **extra) -> None:
        """Emit an ``amp_overflow`` record naming the parameters whose
        gradients went nonfinite: ``meta`` is the ``prof.numerics.
        tree_meta`` of the gradient tree, ``census`` a carried
        ``GradCensus``. This is the one host sync of the provenance path
        — call it only when a skip happened, never per step."""
        from apex_tpu_torch.prof import numerics as _n
        fields = {"loss_id": loss_id, "source": source,
                  "culprits": _n.culprit_table(meta, census)}
        step = int(census.step)
        if step >= 0:
            fields["step"] = step
        if loss_scale is not None:
            fields["loss_scale"] = loss_scale   # copied now, fetched later
        fields.update(extra)
        self._emit("amp_overflow", fields)

    def log_numerics(self, meta, census, *, step=None, **extra) -> None:
        """Emit a ``numerics``/underflow record from a ``prof.numerics.
        UnderflowCensus`` (host fetch here — call at the sampling cadence,
        not per step)."""
        from apex_tpu_torch.prof import numerics as _n
        fields = {"what": "underflow",
                  **_n.underflow_summary(meta, census)}
        if step is not None:
            fields["step"] = int(step)
        fields.update(extra)
        self._emit("numerics", fields)

    def log_coverage(self, report, label: str = "step", **extra) -> None:
        """Emit a ``numerics``/coverage record from any report with a
        ``summary_dict()``."""
        self._emit("numerics", {"what": "coverage", "fn": label,
                                **report.summary_dict(), **extra})

    # -- fleet (schema 3) --------------------------------------------------
    def log_fleet_skew(self, **fields) -> None:
        """Emit a ``fleet_skew`` record (per-process step-duration EMAs and
        the slowest process and its lag)."""
        self._emit("fleet_skew", fields)

    def log_desync(self, **fields) -> None:
        """Emit a ``desync`` record (a cross-process disagreement). An
        incident: persisted immediately."""
        self._emit("desync", fields)
        self.flush()

    # -- serving (schema 4) ------------------------------------------------
    def log_serving(self, **fields) -> None:
        """Emit a ``serving`` record — the ``serve.summarize_serving``
        payload of one finished serving run. Once per run, flushed at once:
        the run's headline."""
        self._emit("serving", fields)
        self.flush()

    # -- spans / alerts (prof.spans / prof.slo, schema 5) ------------------
    def log_spans(self, tracer_or_records) -> int:
        """Emit ``span`` records — from a ``prof.spans.SpanTracer`` (its
        completed ring) or an iterable of span field dicts. Each keeps the
        span's own wall-clock ``t``. Call once per run or phase boundary,
        never per span."""
        recs = (tracer_or_records.records()
                if hasattr(tracer_or_records, "records")
                else list(tracer_or_records))
        for fields in recs:
            self._emit("span", dict(fields))
        if recs:
            self.flush()
        return len(recs)

    def log_alert(self, **fields) -> None:
        """Emit an ``alert`` record — an in-run SLO violation
        (``prof.slo.SLOMonitor``) or a watchdog stall (``rule: "stall"``).
        An incident: flushed immediately."""
        self._emit("alert", fields)
        self.flush()

    # -- runtime recovery (schema 6) ---------------------------------------
    def log_snapshot(self, **fields) -> None:
        """Emit a ``snapshot`` record — one committed snapshot
        generation."""
        self._emit("snapshot", fields)

    def log_restore(self, **fields) -> None:
        """Emit a ``restore`` record — one restore from the last good
        snapshot. An incident: flushed immediately."""
        self._emit("restore", fields)
        self.flush()

    # -- live telemetry plane (prof.live, schema 7) ------------------------
    def log_live_drop(self, **fields) -> None:
        """Emit a ``live_drop`` record — one process's live-stream drop
        accounting (``process``, ``drops``, ``sent``, ``endpoint``)."""
        self._emit("live_drop", fields)

    # -- router tier (serve.router, schema 8) ------------------------------
    def log_router(self, **fields) -> None:
        """Emit a ``router`` record — one routing run's decision ledger
        (``serve.router.Router.summary``). Once per run, flushed at
        once."""
        self._emit("router", fields)
        self.flush()

    # -- flight recorder (prof.flightrec, schema 11) -----------------------
    def log_flightrec(self, **fields) -> None:
        """Emit a ``flightrec`` record — one flight-recorder dump
        announcement (trigger rule and scope, dump ``path``, counts, the
        window). An incident: flushed immediately."""
        self._emit("flightrec", fields)
        self.flush()

    # -- compile -----------------------------------------------------------
    def log_compiles(self) -> None:
        """Emit the cumulative compile-counter snapshot (with the delta
        against the previous snapshot, so intervals are attributable)."""
        if self.compile_tracker is None:
            return
        snap = self.compile_tracker.snapshot()
        prev = self._last_compile_snapshot
        delta = snap["backend_compiles"] - prev.get("backend_compiles", 0)
        self._last_compile_snapshot = snap
        self._emit("compile", {**snap, "backend_compiles_delta": delta})

    def track_recompiles(self, fn: Callable, name: str) -> Callable:
        """Wrap a callable so a change in its arguments' shapes or dtypes
        after the first call emits a ``recompile`` record naming them (the
        change that makes a captured program capture again).

        The signature is shapes and dtypes over a plain walk of dicts,
        lists, tuples and tensors: no host sync."""

        def _sig(args, kwargs):
            return tuple(
                (tuple(x.shape) if hasattr(x, "shape") else None,
                 _dtype_name(getattr(x, "dtype", type(x).__name__)))
                for x in _leaves((list(args), kwargs)))

        def wrapped(*args, **kwargs):
            sig = _sig(args, kwargs)
            with self._mu:
                seen = self._recompile_sigs.setdefault(name, [])
                fresh = sig not in seen
                if fresh:
                    seen.append(sig)
                    n = len(seen)
            if fresh and n > 1:
                self._emit("recompile", {
                    "fn": name,
                    "n_signatures": n,
                    "avals": [list(s) for s in sig],
                })
            return fn(*args, **kwargs)

        wrapped.__name__ = f"telemetry[{name}]"
        return wrapped

    # -- memory ------------------------------------------------------------
    def log_memory(self) -> None:
        """Sample ``torch.cuda.memory_stats`` per device under the JAX
        record's keys (``bytes_in_use``, ``peak_bytes_in_use``,
        ``num_allocs``; the allocator reports no limit or largest
        allocation, so those keys are left out). Without an initialized
        CUDA (a CPU run) one record says ``available: False``, so the
        sidecar says why the column is empty."""
        if not _cuda_initialized():
            self._emit("memory", {"device": "0", "available": False})
            return
        cuda = _torch().cuda
        for d in range(cuda.device_count()):
            try:
                stats = cuda.memory_stats(d)
            except Exception:
                stats = None
            if not stats:
                self._emit("memory", {"device": str(d),
                                      "available": False})
                continue
            keep = {k: stats[src] for k, src in (
                ("bytes_in_use", "allocated_bytes.all.current"),
                ("peak_bytes_in_use", "allocated_bytes.all.peak"),
                ("num_allocs", "allocation.all.allocated")) if src in stats}
            self._emit("memory", {"device": str(d), "available": True,
                                  **keep})

    def log_state_bytes(self, *, params=None, opt_state=None,
                        label: Optional[str] = None, **extra) -> None:
        """Emit a ``memory`` record with the bytes of the run's persistent
        state on one device: each tensor's ``numel() * element_size()``
        (a ZeRO rank's shard is what it holds). Metadata only — no host
        sync.
        ``devices`` is written when CUDA is initialized."""
        fields: dict = {"tracked": True}
        if label is not None:
            fields["label"] = label
        total = 0
        for name, tree in (("params", params), ("opt_state", opt_state)):
            if tree is not None:
                b = tracked_bytes_per_device(tree)
                fields[f"{name}_bytes_per_device"] = b
                total += b
        fields["state_bytes_per_device"] = total
        if _cuda_initialized():
            fields["devices"] = _torch().cuda.device_count()
        fields.update(extra)
        self._emit("memory", fields)

    # -- collectives -------------------------------------------------------
    def log_collectives(self) -> None:
        """Snapshot ``parallel.collectives``' tally into a ``collectives``
        record (the JAX logger's keys): the bytes and calls of the last
        step (``collectives.step_scope``), and the host-observed latency
        histogram under ``latency``. Nothing is emitted when both are
        empty; a process that never loaded the module has no tally (and
        prof loads no torch)."""
        _c = sys.modules.get("apex_tpu_torch.parallel.collectives")
        if _c is None:
            return
        snap = dict(_c.collective_bytes())
        lat = _c.collective_latency()
        if lat:
            snap["latency"] = lat
        if snap:
            self._emit("collectives", snap)

    # -- stall (called by prof.watchdog) -----------------------------------
    def log_stall(self, snapshot: dict) -> None:
        self._emit("stall", snapshot)
        self.flush()

    def tail(self, n: int = 10) -> list:
        """Last ``n`` already-written records (the watchdog's 'what was
        the run doing' snapshot source)."""
        with self._mu:
            return list(self._tail)[-n:]

    # -- flush / close -----------------------------------------------------
    def flush(self) -> None:
        """The host-sync boundary: fetch the buffered tensors (one transfer
        a device), write JSONL. Samples nothing: memory is an explicit call
        so the caller controls when device queries happen."""
        # drain framework notes into records of their declared kind
        while _PENDING_NOTES:
            try:
                t, kind, name, fields = _PENDING_NOTES.popleft()
            except IndexError:
                break
            with self._mu:
                if not self._closed:
                    rec = {"v": SCHEMA_VERSION, "kind": kind,
                           "t": round(t, 3)}
                    if name is not None:
                        rec["name"] = name
                    rec.update(fields)
                    self._buf.append(rec)
        with self._mu:
            if self._closed and not self._buf:
                return
            buf, self._buf = self._buf, []
            copies, self._copies = self._copies, []
            streams, self._streams = self._streams, set()
            self._steps_since_flush = 0
            # the fetch stays under the lock: replica threads sharing the
            # logger wait for it, not the other way round
            fetched, transfers = _fetch_all(copies, streams)
            self.fetches += transfers
            out_lines = []
            for rec in buf:
                rec = {k: _sanitize(v, fetched) for k, v in rec.items()}
                if rec.get("kind") == "amp":
                    # device int32 counters came back as floats
                    for k, v in rec.items():
                        if isinstance(v, float) and k.endswith(
                                ("_count", "unskipped")):
                            rec[k] = int(v)
                out_lines.append(json.dumps(rec))
                self._tail.append(rec)
            if out_lines:
                self._fh.write("\n".join(out_lines) + "\n")
                self._fh.flush()

    def close(self) -> None:
        """Final flush: compile totals, memory watermarks, then the
        ``close`` record."""
        with self._mu:
            if self._closed:
                return
        self.log_compiles()
        self.log_memory()
        self.log_collectives()
        self._emit("close", {"run": self.run})
        self.flush()
        with self._mu:
            self._closed = True
        if self.compile_tracker is not None:
            self.compile_tracker.stop()
        try:
            self._fh.close()
        except Exception:
            pass

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
