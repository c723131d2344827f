# Copied from apex_tpu/prof/spans.py (stdlib only), so the port imports
# nothing of the JAX package. The export formats (record fields, the
# Chrome trace's names, MERGE_SCHEMA) are the JAX module's, so the same
# tools read both packages' traces.
"""Request-lifecycle span tracing — the host-side phase timeline (r13).

The r07–r12 telemetry records say WHAT a run achieved (step percentiles,
serving latency aggregates); none of them say WHERE a slow request's
time went. A p99 serving request is slow for exactly one of a few
reasons — it queued, its prefill serialized behind other admissions, it
contended for decode steps, or host retirement bookkeeping lagged — and
distinguishing them needs begin/end events with parent linkage, not
aggregates. This module is that layer: a low-overhead host-side span
tracer whose output is consumable three ways —

- **schema-5 ``span`` telemetry records** (:meth:`SpanTracer.records`,
  written via ``MetricsLogger.log_spans``) so the standard sidecar
  carries the phase timeline and ``tools/telemetry_report.py`` can
  build the tail-attribution table offline;
- **Chrome trace-event JSON** (:meth:`SpanTracer.chrome_trace`) —
  loadable in Perfetto / ``chrome://tracing``, one track per request;
- **live open-span snapshots** (:meth:`SpanTracer.open_spans`) — what
  was in flight when the watchdog declared a stall.

Overhead discipline (the <2% budget, same contract as prof.metrics):
``begin``/``end`` are a clock read, an int bump, and a dict/deque
append — no formatting, no I/O, no host syncs. The buffer is a ring
(``capacity`` completed spans; the oldest fall off and are counted in
``dropped``), so an unbounded run cannot OOM the host. Spans-off is a
``None`` tracer at the call site — literally zero instrumentation cost.

Timestamps are ``time.perf_counter()`` relative to the tracer's epoch
(``now()``); callers that already stamp phase times on their own
relative clock (the serve engine's request results) pass explicit
``t0``/``t1`` so derived views (span vs ``summarize_serving``) agree
exactly instead of within-epsilon.

r22 (distributed tracing, schema 11): spans of one request carry a
fleet-wide ``trace`` id (stamped by ``serve.router`` on every submit,
riding the socket frames) plus a ``hop`` counter, and
:func:`merge_process_traces` clock-aligns N per-process span sidecars
into ONE Perfetto-loadable timeline — one lane (pid) per process, one
track (tid) per trace id — so a killed-replica request renders as
route → prefill → decode → death → replay hop → retire across two
lanes. :meth:`SpanTracer.drain_records` is the streaming export a
process that may die mid-run uses to persist completed spans
incrementally.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["Span", "SpanTracer", "merge_process_traces",
           "merged_chrome_trace", "write_merged_chrome_trace"]


class Span:
    """One completed span. ``t0``/``t1`` are seconds on the tracer's
    clock (relative to its epoch); ``attrs`` are free-form and ride
    both export formats."""

    __slots__ = ("sid", "parent", "name", "t0", "t1", "attrs")

    def __init__(self, sid, parent, name, t0, t1, attrs):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0

    def __repr__(self):  # debugging aid only
        return (f"Span({self.name!r}, {self.dur_s * 1e3:.3f} ms, "
                f"sid={self.sid}, parent={self.parent})")


class SpanTracer:
    """Ring-buffered begin/end span recorder with parent linkage.

    ::

        tr = SpanTracer()
        rid = tr.begin("request", request=7)
        with tr.span("prefill_chunk", parent=rid, chunk=0):
            ...
        tr.end(rid, tokens=12)
        telem.log_spans(tr)                    # schema-5 span records
        tr.write_chrome_trace("trace.json")    # Perfetto-loadable

    Thread-safe (the serve scheduler and a telemetry flush may race);
    the lock is uncontended in the single-threaded hot path.
    """

    def __init__(self, *, capacity: int = 65536,
                 wall0: Optional[float] = None):
        self._epoch = time.perf_counter()
        # wall-clock anchor so span records carry absolute 't' like
        # every other telemetry record (pairing with step records)
        self.wall0 = time.time() if wall0 is None else float(wall0)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._done: deque = deque(maxlen=self.capacity)
        self._open: dict = {}          # sid -> [name, parent, t0, attrs]
        self._next = 0
        self.dropped = 0
        self._mu = threading.Lock()

    # -- clock -------------------------------------------------------------
    def now(self) -> float:
        """Seconds since the tracer's epoch (the span timebase)."""
        return time.perf_counter() - self._epoch

    # -- recording ---------------------------------------------------------
    def begin(self, name: str, *, parent: Optional[int] = None,
              t0: Optional[float] = None, **attrs) -> int:
        """Open a span; returns its id (pass as ``parent`` to nest).
        ``t0`` (tracer-relative seconds) backdates the start — the queue
        span of a request that arrived before the scheduler looked."""
        t = self.now() if t0 is None else float(t0)
        with self._mu:
            self._next += 1
            sid = self._next
            self._open[sid] = [name, parent, t, attrs]
        return sid

    def end(self, sid: int, *, t1: Optional[float] = None,
            **attrs) -> Optional[Span]:
        """Close span ``sid`` (extra attrs merge over begin's). Unknown
        ids are ignored — an eviction-raced end must not raise on the
        serving hot path."""
        t = self.now() if t1 is None else float(t1)
        with self._mu:
            ent = self._open.pop(sid, None)
            if ent is None:
                return None
            name, parent, t0, a0 = ent
            if attrs:
                a0 = {**a0, **attrs}
            sp = Span(sid, parent, name, t0, max(t, t0), a0)
            if len(self._done) == self._done.maxlen:
                self.dropped += 1
            self._done.append(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str, *, parent: Optional[int] = None, **attrs):
        """Context-managed begin/end; yields the span id."""
        sid = self.begin(name, parent=parent, **attrs)
        try:
            yield sid
        finally:
            self.end(sid)

    def instant(self, name: str, *, parent: Optional[int] = None,
                t: Optional[float] = None, **attrs) -> int:
        """A zero-duration marker span (the 'retire' tick)."""
        ts = self.now() if t is None else float(t)
        sid = self.begin(name, parent=parent, t0=ts, **attrs)
        self.end(sid, t1=ts)
        return sid

    # -- views -------------------------------------------------------------
    @property
    def open_count(self) -> int:
        with self._mu:
            return len(self._open)

    @property
    def completed_count(self) -> int:
        with self._mu:
            return len(self._done)

    def open_spans(self, limit: int = 32) -> "list[dict]":
        """What is in flight RIGHT NOW (oldest first) — the watchdog's
        'what was the run doing when it stalled' payload."""
        now = self.now()
        with self._mu:
            rows = [{"name": name, "span": sid,
                     "age_ms": round((now - t0) * 1e3, 3),
                     **({"parent": parent} if parent is not None else {}),
                     **({"attrs": dict(attrs)} if attrs else {})}
                    for sid, (name, parent, t0, attrs)
                    in self._open.items()]
        rows.sort(key=lambda r: -r["age_ms"])
        return rows[:limit]

    def spans(self) -> "list[Span]":
        """Completed spans, oldest first (non-destructive)."""
        with self._mu:
            return list(self._done)

    # -- exports -----------------------------------------------------------
    def _record(self, s: Span) -> dict:
        rec = {"t": round(self.wall0 + s.t0, 3), "name": s.name,
               "span": s.sid, "t0_s": round(s.t0, 6),
               "dur_ms": round(s.dur_s * 1e3, 4)}
        if s.parent is not None:
            rec["parent"] = s.parent
        if s.attrs:
            rec["attrs"] = dict(s.attrs)
        return rec

    def records(self) -> "list[dict]":
        """Schema-5 ``span`` record field dicts (one per completed
        span), ready for ``MetricsLogger.log_spans``. ``t`` is the
        wall-clock start (tracer epoch + offset) so span records sort
        with the sidecar's other kinds; ``t0_s`` keeps the precise
        relative timebase the tail-attribution math uses."""
        return [self._record(s) for s in self.spans()]

    def drain_records(self) -> "list[dict]":
        """Like :meth:`records` but DESTRUCTIVE: completed spans are
        removed from the ring as they are exported, so repeated
        ``telem.log_spans(tracer.drain_records())`` calls persist each
        span exactly once. This is how a replica that may be killed
        mid-run (r22 fleet_smoke ``--kill-rank``) gets its spans onto
        disk before dying — the merged fleet timeline can only show a
        dead lane's prefill if the dead process streamed it out. Open
        spans stay open (they export on a later drain if they ever
        complete)."""
        with self._mu:
            done = list(self._done)
            self._done.clear()
        return [self._record(s) for s in done]

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the Perfetto/chrome://tracing
        format): complete ("X") events in microseconds, sorted by
        timestamp, one ``tid`` track per request (``request`` attr)
        with scheduler-level spans on track 0."""
        pid = os.getpid()
        events = [{"ph": "M", "pid": pid, "tid": 0,
                   "name": "process_name",
                   "args": {"name": "apex_tpu.spans"}}]
        rows = []
        for s in self.spans():
            attrs = s.attrs or {}
            rows.append({
                "ph": "X", "pid": pid,
                "tid": int(attrs.get("request", 0)) + 1
                if "request" in attrs else 0,
                "name": s.name, "cat": "apex",
                "ts": round(s.t0 * 1e6, 3),
                "dur": round(s.dur_s * 1e6, 3),
                "args": {**attrs, "span": s.sid,
                         **({"parent": s.parent}
                            if s.parent is not None else {})},
            })
        rows.sort(key=lambda e: e["ts"])
        return {"traceEvents": events + rows,
                "displayTimeUnit": "ms",
                "otherData": {"source": "apex_tpu.prof.spans",
                              "dropped_spans": self.dropped}}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# ---------------------------------------------------------------------------
# Fleet trace merge (r22, schema 11)
# ---------------------------------------------------------------------------

MERGE_SCHEMA = "apex_tpu.trace_merge/1"

# span names that belong to ONE request's lifecycle (engine-side r13
# names + router-side r22 names). A span with one of these names that
# resolves to no trace/request id is an ORPHAN — it can never join a
# merged timeline, which is exactly what the apex_lint ``orphan-span``
# rule guards at the source level and what the CI smoke asserts to be
# zero at the artifact level. Scheduler-scope spans (``decode_step``,
# ``prefill_batch``, warmup) are shared across requests by design and
# are NOT request-scope.
REQUEST_SCOPE_SPANS = ("request", "queue", "prefill_chunk", "commit",
                       "decode", "retire", "route", "admission", "shed",
                       "redirect", "replay_hop", "replay_stitch")


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    if not n:
        return None
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def _resolve_trace(rec, by_sid):
    """Walk a span record's parent chain (within its own lane) to the
    nearest ancestor carrying a ``trace`` attr. Returns (trace, hop) —
    (None, None) when the chain dead-ends (e.g. the parent died open
    on a killed replica and never exported)."""
    seen = set()
    r = rec
    while r is not None:
        attrs = r.get("attrs") or {}
        if "trace" in attrs:
            return attrs["trace"], attrs.get("hop")
        parent = r.get("parent")
        if parent is None or parent in seen:
            return None, None
        seen.add(parent)
        r = by_sid.get(parent)
    return None, None


def _resolve_request(rec, by_sid):
    """The request-id counterpart of ``_resolve_trace``: a span's own
    ``attrs.request``, else the nearest ancestor's. A span that reaches
    a request id is LINKED even when no trace id exists for it yet (an
    un-routed run has no trace context at all — its spans are
    traceless, not orphaned)."""
    seen = set()
    r = rec
    while r is not None:
        attrs = r.get("attrs") or {}
        if attrs.get("request") is not None:
            return attrs["request"]
        parent = r.get("parent")
        if parent is None or parent in seen:
            return None
        seen.add(parent)
        r = by_sid.get(parent)
    return None


def merge_process_traces(record_lists, *, names=None):
    """Clock-align N per-process telemetry sidecars (validated record
    lists, ``metrics.read_sidecar`` output) into ONE fleet trace.

    Reuses the r10 ``aggregate_fleet`` pairing contract: replica
    sidecars must carry v3 ``process_index``/``process_count`` header
    tags, duplicate indices are refused, and a ROUTER sidecar (one
    carrying ``router`` records, or a ``role: "router"`` header) is
    pulled aside from the index checks — it becomes the first lane.

    Clock alignment: every span record carries both a wall-clock ``t``
    (rounded to ms) and the exact tracer-relative ``t0_s``; each lane's
    wall epoch is estimated as ``median(t - t0_s)`` over its spans, so
    within-lane deltas stay EXACT (one constant shift per lane) and
    cross-lane skew is bounded by the wall rounding, not by clock drift
    accumulated over the run.

    Trace identity: a span's ``attrs.trace`` (stamped by the router on
    submit, propagated by the engine), else the nearest ancestor's via
    parent-chain walk, else the fleet-wide ``request -> trace`` map (a
    killed replica's queue/commit spans resolve this way — their parent
    ``request`` span died open and never exported).

    Returns a dict (``MERGE_SCHEMA``): ``lanes`` (one row per process),
    ``span_records`` (every span, rebased onto the merged timebase,
    tagged with ``lane`` and resolved ``attrs.trace``/``hop`` — directly
    consumable by ``serve.traffic`` phase/percentile math), ``traces``
    (per-trace summary: lanes touched, hop count, replay flag),
    ``multi_lane`` (trace ids whose life crossed processes) and
    ``orphans`` (request-scope spans that resolved to no trace)."""
    if not record_lists:
        raise ValueError("no sidecars given")
    names = list(names or [f"<sidecar {i}>"
                           for i in range(len(record_lists))])
    if len(names) != len(record_lists):
        raise ValueError("names/record_lists length mismatch")

    lanes = []
    seen_pi: dict = {}
    pcs = set()
    for name, recs in zip(names, record_lists):
        if not recs or recs[0].get("kind") != "header":
            raise ValueError(f"{name}: first record is not a header")
        hdr = recs[0]
        spans = [r for r in recs if r.get("kind") == "span"]
        is_router = (hdr.get("role") == "router"
                     or (hdr.get("meta") or {}).get("role") == "router"
                     or any(r.get("kind") == "router" for r in recs))
        pi = hdr.get("process_index")
        if not is_router:
            pc = hdr.get("process_count")
            if pi is None or pc is None:
                raise ValueError(
                    f"{name}: header carries no process_index/"
                    f"process_count (schema {hdr.get('schema')}) — "
                    f"trace merge needs v3 per-process sidecars")
            if pi in seen_pi:
                raise ValueError(f"{name}: duplicate process_index {pi} "
                                 f"(already seen in {seen_pi[pi]})")
            seen_pi[pi] = name
            pcs.add(int(pc))
        wall0 = _median([float(r["t"]) - float(r.get("t0_s", 0.0))
                         for r in spans if "t" in r])
        lanes.append({"name": name, "kind": ("router" if is_router
                                             else "replica"),
                      "process": (None if is_router else int(pi)),
                      "wall0": wall0, "records": spans,
                      "run": hdr.get("run")})
    if len(pcs) > 1:
        raise ValueError(f"sidecars disagree on process_count: "
                         f"{sorted(pcs)} — they are not one fleet")
    # router lane first, then replicas by process index — stable lane
    # numbering for the chrome export and the tests
    lanes.sort(key=lambda ln: (ln["kind"] != "router",
                               ln["process"] if ln["process"] is not None
                               else -1))

    # -- pass 1: per-lane parent-chain trace resolution -----------------
    t_base = None
    staged = []     # (lane_index, rec, abs_t0, trace, hop)
    for li, ln in enumerate(lanes):
        by_sid = {r.get("span"): r for r in ln["records"]}
        for r in ln["records"]:
            attrs = r.get("attrs") or {}
            trace, hop = _resolve_trace(r, by_sid)
            if hop is None:
                hop = attrs.get("hop")
            rid = _resolve_request(r, by_sid)
            abs_t0 = ((ln["wall0"] or 0.0) + float(r.get("t0_s", 0.0)))
            if t_base is None or abs_t0 < t_base:
                t_base = abs_t0
            staged.append((li, r, abs_t0, trace, hop, rid))
    if t_base is None:
        t_base = 0.0

    # -- pass 2: request -> trace map rescue + merged records -----------
    req_trace: dict = {}
    req_hops: dict = {}
    for _, r, _, trace, hop, rid in staged:
        if trace is not None and rid is not None:
            req_trace.setdefault(rid, trace)
            if hop is not None:
                req_hops[rid] = max(req_hops.get(rid, 0), int(hop))
    merged = []
    orphans = []
    traces: dict = {}
    for li, r, abs_t0, trace, hop, rid in staged:
        attrs = dict(r.get("attrs") or {})
        if trace is None and rid is not None:
            trace = req_trace.get(rid)
        out = dict(r)
        out["lane"] = li
        rel = abs_t0 - t_base
        out["t0_s"] = round(rel, 9)
        out["t"] = round(t_base + rel, 6)
        if trace is not None:
            attrs["trace"] = trace
            if hop is not None:
                attrs.setdefault("hop", int(hop))
            out["attrs"] = attrs
            tr = traces.setdefault(trace, {
                "spans": 0, "lanes": set(), "hops": 0,
                "requests": set(), "replay": False})
            tr["spans"] += 1
            tr["lanes"].add(li)
            if hop is not None:
                tr["hops"] = max(tr["hops"], int(hop))
            if rid is not None:
                tr["requests"].add(rid)
                tr["hops"] = max(tr["hops"], req_hops.get(rid, 0))
            if r.get("name") in ("replay_hop", "redirect"):
                tr["replay"] = True
        elif r.get("name") in REQUEST_SCOPE_SPANS and rid is None:
            # no trace resolved AND no request id reachable through
            # the parent chain: the span passes none of the linking
            # attrs and is unplaceable on the merged timeline. A span
            # that DOES reach a request id in a run with no trace
            # context at all (un-routed) is traceless, not orphaned.
            orphans.append({"lane": li, "name": r.get("name"),
                            "span": r.get("span")})
        merged.append(out)
    merged.sort(key=lambda r: (r["t0_s"], r["lane"]))
    for tr in traces.values():
        tr["lanes"] = sorted(tr["lanes"])
        tr["requests"] = sorted(tr["requests"])
    multi = sorted(t for t, tr in traces.items() if len(tr["lanes"]) > 1)
    return {
        "schema": MERGE_SCHEMA,
        "t0_wall": round(t_base, 6),
        "lanes": [{"lane": li, "name": ln["name"], "kind": ln["kind"],
                   "process": ln["process"], "run": ln["run"],
                   "wall0": (round(ln["wall0"], 6)
                             if ln["wall0"] is not None else None),
                   "spans": len(ln["records"])}
                  for li, ln in enumerate(lanes)],
        "span_records": merged,
        "traces": traces,
        "multi_lane": multi,
        "orphans": orphans,
    }


def merged_chrome_trace(merge: dict) -> dict:
    """Chrome trace-event JSON of a :func:`merge_process_traces` result:
    one ``pid`` LANE per process (router first), one ``tid`` TRACK per
    trace id (the same trace renders at the same track across lanes, so
    a replayed request reads straight across the timeline), spans with
    no trace on track 0."""
    tids: dict = {}
    for r in merge["span_records"]:
        trace = (r.get("attrs") or {}).get("trace")
        if trace is not None and trace not in tids:
            tids[trace] = len(tids) + 1
    events = []
    for ln in merge["lanes"]:
        label = (f"router [{ln['name']}]" if ln["kind"] == "router"
                 else f"p{ln['process']} [{ln['name']}]")
        events.append({"ph": "M", "pid": ln["lane"], "tid": 0,
                       "name": "process_name",
                       "args": {"name": label}})
    named = set()
    rows = []
    for r in merge["span_records"]:
        attrs = dict(r.get("attrs") or {})
        trace = attrs.get("trace")
        tid = tids.get(trace, 0)
        pid = r["lane"]
        if trace is not None and (pid, tid) not in named:
            named.add((pid, tid))
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": f"trace {trace}"}})
        rows.append({
            "ph": "X", "pid": pid, "tid": tid,
            "name": r["name"], "cat": "apex",
            "ts": round(float(r["t0_s"]) * 1e6, 3),
            "dur": round(float(r.get("dur_ms", 0.0)) * 1e3, 3),
            "args": {**attrs, "span": r.get("span"),
                     **({"parent": r["parent"]}
                        if r.get("parent") is not None else {})},
        })
    rows.sort(key=lambda e: e["ts"])
    return {"traceEvents": events + rows,
            "displayTimeUnit": "ms",
            "otherData": {"source": "apex_tpu.prof.spans.merge",
                          "schema": merge["schema"],
                          "lanes": len(merge["lanes"]),
                          "traces": len(merge["traces"]),
                          "multi_lane": merge["multi_lane"],
                          "orphan_spans": len(merge["orphans"])}}


def write_merged_chrome_trace(merge: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(merged_chrome_trace(merge), f)
    return path
