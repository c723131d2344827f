# Copied from apex_tpu/prof/live.py (stdlib only), so the port imports
# nothing of the JAX package. A ``logger`` is any object with the methods
# called here (``log_alert``, ``event``, ``log_live_drop``, ``flush``,
# ``add_tee``): the port's MetricsLogger comes with ROADMAP.md Queue 1,
# slice 8.
"""Live fleet telemetry plane (r18) — see the fleet WHILE it runs.

Every observability layer before this one is post-hoc: records land in
per-process sidecar files (``prof.metrics``) and are joined after the
run ends (``prof.fleet.aggregate_fleet``, ``telemetry_report --fleet``).
Nothing in-flight can see the fleet — a router deciding where to send
the next request, an autoscaler watching occupancy, an operator asking
"which replica is sick RIGHT NOW" all need the view TorchTitan
(arXiv:2410.06511) treats as a first-class always-on metrics plane.
This module is that plane, in three pieces:

- :class:`LiveEmitter` — the per-process producer, tee'd off a
  ``MetricsLogger`` (``MetricsLogger.add_tee``) and/or fed directly
  (``observe``). The STEP-PATH contract is absolute: producing a sample
  is one bounded-queue ``put_nowait`` — no socket call, no blocking
  ``Queue.put``, no formatting. A background sender thread owns the
  connection (unix or TCP socket, newline-delimited JSON) and all the
  blocking; when the queue is full or the collector unreachable,
  samples are DROPPED AND COUNTED, never waited on. The final drop
  count is reported to the collector (``bye`` message) and written
  into the process's own sidecar as a schema-7 ``live_drop`` record.
  The ``blocking-emit-on-step-path`` apex_lint rule encodes this
  contract statically.
- :class:`LiveCollector` — the fleet-side consumer: accepts N process
  streams, maintains rolling windows keyed ``(process, metric)``, and
  computes FLEET aggregates no per-process monitor can: cross-replica
  occupancy (min / skew, with the collapsing replica named), TTFT /
  token-latency percentiles over the MERGED request stream, step-time
  skew, fleet queue depth. On top of the windows sit (a) fleet-scope
  SLO evaluation — the same ``prof.slo`` rule grammar, every alert
  carrying ``scope: "fleet"`` and firing the existing
  ``SLOMonitor.on_alert`` seam (``runtime.Supervisor`` today, router
  admission control next); (b) a Prometheus-text ``/metrics`` HTTP
  endpoint plus a ``/snapshot`` JSON twin (what ``tools/serve_top.py``
  renders); (c) a final-state flush into an ordinary telemetry sidecar
  (``live_replica``/``live_fleet`` event records + ``live_drop``
  accounting) so ``telemetry_report.py`` renders the LIVE table with
  no new schema kinds.

Why fleet-scope rules are not redundant with per-process ones: a
replica whose traffic collapsed serves its few requests FAST — its own
``ttft_p95_ms`` monitor is green — while the fleet is quietly running
on N-1 replicas. ``occupancy_min`` / ``occupancy_skew`` /
``step_skew_frac`` exist only at the collector, because only the
collector holds every replica's window (the r10 ``FleetProbe`` gathers
a single EMA through a collective; this plane streams the metrics out
of band and needs no lockstep).

Endpoints are strings: ``tcp:HOST:PORT`` or ``unix:/path.sock``
(:func:`parse_endpoint`). Module-level imports are stdlib-only (the
SLO monitor binds lazily), so hosting a collector costs a package
import but never forces a jax backend init — a launcher parent can run
one next to the fleet it spawned (``tools/fleet_smoke.py --live``).
"""

from __future__ import annotations

import json
import os
import queue
import socket
import threading
import time
from collections import deque
from typing import Callable, Optional

__all__ = ["LiveEmitter", "LiveCollector", "parse_endpoint",
           "DEFAULT_QUEUE", "MERGED_METRICS", "DERIVED_METRICS",
           "prometheus_name"]

DEFAULT_QUEUE = 2048

# metrics whose raw per-process samples feed the fleet monitor directly
# — percentile rules over these evaluate on the MERGED stream (a fleet
# ttft_p95_ms is the p95 across every replica's requests)
MERGED_METRICS = ("ttft_ms", "token_lat_ms", "step_ms", "itl_ms")

# metrics the collector DERIVES across replicas (recomputed every
# ``eval_every`` ingested samples); these are the rules no per-process
# monitor can express
DERIVED_METRICS = ("occupancy_min", "occupancy_mean", "occupancy_skew",
                   "step_skew_frac", "queue_depth_max")


def parse_endpoint(spec: str) -> "tuple[str, object]":
    """``"tcp:HOST:PORT"`` -> ``("tcp", (host, port))``;
    ``"unix:/path"`` -> ``("unix", path)``. Bare ``HOST:PORT`` is
    accepted as tcp."""
    if spec.startswith("unix:"):
        return "unix", spec[len("unix:"):]
    if spec.startswith("tcp:"):
        spec = spec[len("tcp:"):]
    host, _, port = spec.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"bad live endpoint {spec!r}: expected tcp:HOST:PORT or "
            f"unix:/path.sock")
    return "tcp", (host, int(port))


def _connect(kind: str, addr, timeout: float = 2.0) -> socket.socket:
    if kind == "unix":
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.settimeout(timeout)
    s.connect(addr)
    s.settimeout(5.0)
    return s


# ---------------------------------------------------------------------------
# The per-process producer
# ---------------------------------------------------------------------------

# telemetry record kinds worth streaming when tee'd off a MetricsLogger
# (high-rate kinds are exactly what the plane is for; bulk kinds like
# span dumps stay in the sidecar)
_TEE_KINDS = frozenset(("step", "serving", "alert", "stall",
                        "fleet_skew", "desync", "snapshot", "restore"))


class LiveEmitter:
    """Non-blocking per-process metric streamer.

    ::

        em = LiveEmitter("tcp:127.0.0.1:9444", process_index=rank,
                         process_count=world, run="serve")
        em.attach(metrics_logger)         # tee every telemetry record
        em.observe("ttft_ms", 12.3)       # or feed samples directly
        ...
        em.close()                        # bye + schema-7 live_drop

    ``observe``/``tee_record`` cost one ``Queue.put_nowait`` — the
    producer NEVER touches the socket, never blocks, never formats.
    A full queue or a dead collector drops the sample and bumps
    :attr:`drops`; the step path is unaffected either way.

    ``throttle_ms`` slows the background sender per message — the
    drop-accounting injection knob (CI / tests), also reachable via
    ``APEX_LIVE_THROTTLE_MS``.
    """

    _FLUSH_S = 0.05    # sender drain cadence (see _sender: polling,
    #                    never a blocking get — producers wake nobody)

    def __init__(self, endpoint: str, *, process_index: int = 0,
                 process_count: int = 1, run: str = "run",
                 queue_size: int = DEFAULT_QUEUE,
                 throttle_ms: Optional[float] = None):
        self.kind, self.addr = parse_endpoint(endpoint)
        self.endpoint = endpoint
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.run = run
        if throttle_ms is None:
            throttle_ms = float(os.environ.get(
                "APEX_LIVE_THROTTLE_MS", 0.0))
        self.throttle_s = max(float(throttle_ms), 0.0) * 1e-3
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(queue_size),
                                                         1))
        self.drops = 0
        self.sent = 0
        self._logger = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sender,
                                        name="apex-live-emitter",
                                        daemon=True)
        self._enqueue({"k": "hello", "p": self.process_index,
                       "process_count": self.process_count,
                       "run": run, "pid": os.getpid()})
        self._thread.start()

    # -- the step-path surface (everything here must stay O(1)) ------------
    def _enqueue(self, msg: dict) -> None:
        try:
            self._q.put_nowait(msg)
        except queue.Full:
            self.drops += 1

    def observe(self, metric: str, value, **tags) -> None:
        """Stream one metric sample (non-blocking; drops are counted)."""
        msg = {"k": "m", "m": metric, "v": float(value)}
        if tags:
            msg["tags"] = tags
        self._enqueue(msg)

    def observe_many(self, **metrics) -> None:
        """Stream several metric samples as ONE queue entry / wire
        message — the per-step idiom (a 0.5 ms CPU decode step cannot
        afford three queue round-trips; ``observe_many(step_ms=...,
        occupancy=..., queue_depth=...)`` costs one)."""
        self._enqueue({"k": "mm",
                       "m": {k: float(v) for k, v in metrics.items()}})

    def tee_record(self, rec: dict) -> None:
        """``MetricsLogger`` tee callback: forward the streamable kinds
        with only their plain-scalar fields (device arrays are held by
        reference until the logger's flush — fetching one here would be
        a host sync on the step path, so they are simply omitted)."""
        kind = rec.get("kind")
        if kind not in _TEE_KINDS:
            return
        slim = {k: v for k, v in rec.items()
                if isinstance(v, (bool, int, float, str))}
        self._enqueue({"k": "rec", "rec": slim})

    def attach(self, logger) -> "LiveEmitter":
        """Tee this emitter off a ``MetricsLogger`` (and remember it so
        :meth:`close` can write the ``live_drop`` accounting record into
        the process's own sidecar)."""
        logger.add_tee(self.tee_record)
        self._logger = logger
        return self

    # -- the background half (all blocking lives here) ---------------------
    def _sender(self) -> None:
        # The sender POLLS: it drains whatever accumulated every
        # ``_FLUSH_S`` and never blocks on the queue. This matters —
        # a blocking ``q.get`` makes every producer ``put_nowait``
        # notify a waiting thread, i.e. one context switch per decode
        # step, which taxed a 0.5 ms CPU step ~25% before this shape.
        # With no waiter, a put is a mutex + append; the live view
        # trails reality by at most the flush interval.
        sock = None
        backoff = 0.05
        hb = 0                  # iteration-counted heartbeat cadence
        pending: list = []      # hello/bye survive reconnects
        while True:
            batch = pending
            pending = []
            if not batch:
                cap = 1 if self.throttle_s else 256
                while len(batch) < cap:
                    try:
                        batch.append(self._q.get_nowait())
                    except queue.Empty:
                        break
            if not batch:
                if self._stop.is_set():
                    # queue drained: the bye carries the FINAL drop
                    # count (synthesized here, not enqueued — a full
                    # queue must not cost the accounting)
                    batch = [{"k": "bye"}]
                else:
                    time.sleep(self._FLUSH_S)
                    hb += 1
                    if sock is None or hb % 20:
                        continue
                    # ~1 s idle heartbeat: keeps the collector's
                    # last-seen age honest + carries the drop count
                    batch = [{"k": "hb"}]
            for msg in batch:
                if msg.get("k") in ("hb", "bye"):
                    msg["drops"] = self.drops
                    msg["sent"] = self.sent
                msg.setdefault("p", self.process_index)
            if sock is None:
                try:
                    sock = _connect(self.kind, self.addr)
                    backoff = 0.05
                except OSError:
                    keep = [m for m in batch
                            if m.get("k") in ("hello", "bye")]
                    self.drops += len(batch) - len(keep)
                    pending = keep         # control msgs are retried
                    if self._stop.is_set():
                        break              # dead collector: give up
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 1.0)
                    continue
            try:
                sock.sendall("".join(json.dumps(m) + "\n"
                                     for m in batch).encode())
                self.sent += len(batch)
            except OSError:
                self.drops += len(batch)
                try:
                    sock.close()
                except OSError:
                    pass
                sock = None
            if self.throttle_s:
                time.sleep(self.throttle_s)
            if any(m.get("k") == "bye" for m in batch):
                break
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self, timeout: float = 5.0) -> dict:
        """Drain (bounded), send ``bye`` with the final drop count, and
        write the schema-7 ``live_drop`` record into the attached
        logger's sidecar. Off the step path by definition."""
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join(timeout)
        summary = {"process": self.process_index, "drops": self.drops,
                   "sent": self.sent, "endpoint": self.endpoint}
        if self._logger is not None:
            try:
                self._logger.log_live_drop(**summary)
            except Exception:
                pass
        return summary


# ---------------------------------------------------------------------------
# The fleet-side consumer
# ---------------------------------------------------------------------------

def prometheus_name(metric: str) -> str:
    """Telemetry metric -> Prometheus exposition name
    (``ttft_ms`` -> ``apex_live_ttft_ms``; documented in
    docs/OBSERVABILITY.md's /metrics name-mapping table)."""
    return "apex_live_" + metric


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, round(q / 100.0 * (len(sorted_vals) - 1))))
    return float(sorted_vals[idx])


class _ProcState:
    """Rolling per-replica state (windows keyed by metric)."""

    def __init__(self, window: int):
        self.window = window
        self.win: dict[str, deque] = {}
        self.run: Optional[str] = None
        self.samples = 0
        self.records = 0
        self.drops = 0
        self.sent = 0
        self.last_seen = time.time()
        self.alerts = 0
        self.serving: Optional[dict] = None
        self.closed = False

    def push(self, metric: str, value: float) -> None:
        self.win.setdefault(metric, deque(maxlen=self.window)) \
            .append(float(value))
        self.samples += 1
        self.last_seen = time.time()

    def mean(self, metric: str) -> Optional[float]:
        w = self.win.get(metric)
        return (sum(w) / len(w)) if w else None

    def pct(self, metric: str, q: float) -> Optional[float]:
        w = self.win.get(metric)
        return _percentile(sorted(w), q) if w else None


class LiveCollector:
    """Ingest N process streams; evaluate fleet-scope SLOs; serve
    ``/metrics``.

    ::

        col = LiveCollector(rules="occupancy_min>=0.2@8,ttft_p95_ms<=250",
                            logger=telem).start()
        col.on_alert(supervisor_or_router_callback)
        ... emitters connect to col.endpoint ...
        col.close()      # final state -> live_replica/live_fleet records

    ``address``: ``("127.0.0.1", 0)`` (default, ephemeral TCP) or a
    unix-socket path string. ``http_port``: 0 = ephemeral, None =
    /metrics off. Thread-safe; every alert record carries
    ``scope: "fleet"`` (and the culprit ``process`` where a derived
    metric names one).
    """

    def __init__(self, *, address=None, rules=None, logger=None,
                 window: int = 256, min_samples: int = 4,
                 eval_every: int = 8, http_port: Optional[int] = 0,
                 on_alert: Optional[Callable] = None):
        import dataclasses as _dc

        from apex_tpu_torch.prof.slo import SLOMonitor, parse_rules
        self.logger = logger
        self.window = int(window)
        self.eval_every = max(int(eval_every), 1)
        # RLock: an on_alert callback fired under ingest may read
        # snapshot()/prometheus() from the same thread
        self._mu = threading.RLock()
        self._procs: dict[int, _ProcState] = {}
        self._ingested = 0
        # DERIVED metrics are observed under their FULL name
        # (``queue_depth_max``, ``occupancy_mean``, ...), but the slo
        # grammar resolves ``*_max``/``*_mean`` rule names into an
        # aggregation over the STRIPPED metric — which the collector
        # never feeds the monitor. Remap those rules back onto the
        # derived stream (the window then aggregates successive
        # derived evaluations, which is the fleet semantic).
        rule_list = [
            (_dc.replace(r, metric=r.name)
             if r.name in DERIVED_METRICS and r.metric != r.name
             else r)
            for r in parse_rules(rules or [])]
        self.monitor = SLOMonitor(rule_list, logger=logger,
                                  min_samples=min_samples,
                                  source="fleet_slo")
        if on_alert is not None:
            self.monitor.on_alert(on_alert)
        self._merged = {r.metric for r in self.monitor.rules
                        if r.metric in MERGED_METRICS}
        self._addr_spec = address if address is not None \
            else ("127.0.0.1", 0)
        self._srv: Optional[socket.socket] = None
        self._http = None
        self._http_port = http_port
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self.endpoint: Optional[str] = None
        self.metrics_url: Optional[str] = None
        self._closed = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "LiveCollector":
        if isinstance(self._addr_spec, str):
            path = self._addr_spec
            if os.path.exists(path):
                os.unlink(path)
            srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            srv.bind(path)
            self.endpoint = f"unix:{path}"
        else:
            host, port = self._addr_spec
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, int(port)))
            self.endpoint = f"tcp:{host}:{srv.getsockname()[1]}"
        srv.listen(32)
        srv.settimeout(0.2)
        self._srv = srv
        t = threading.Thread(target=self._accept_loop,
                             name="apex-live-accept", daemon=True)
        t.start()
        self._threads.append(t)
        if self._http_port is not None:
            self._start_http(self._http_port)
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._reader, args=(conn,),
                                 name="apex-live-reader", daemon=True)
            t.start()
            self._threads.append(t)

    def _reader(self, conn: socket.socket) -> None:
        conn.settimeout(None)
        buf = b""
        try:
            while not self._stop.is_set():
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        try:
                            self._dispatch(json.loads(line))
                        except (ValueError, KeyError):
                            pass        # one bad line must not kill a stream
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- ingest ------------------------------------------------------------
    def _proc(self, p: int) -> _ProcState:
        st = self._procs.get(p)
        if st is None:
            st = self._procs[p] = _ProcState(self.window)
        return st

    def _dispatch(self, msg: dict) -> None:
        kind = msg.get("k")
        p = int(msg.get("p", 0))
        with self._mu:
            st = self._proc(p)
            st.last_seen = time.time()
            if kind == "hello":
                st.run = msg.get("run")
            elif kind == "m":
                self._ingest_sample(p, st, str(msg["m"]),
                                    float(msg["v"]))
            elif kind == "mm":
                for metric, v in (msg.get("m") or {}).items():
                    # no float(v) here: _ProcState.push coerces, and a
                    # bare float(name) in this (timed) scope reads as a
                    # device fetch to the host-sync lint rule
                    self._ingest_sample(p, st, str(metric), v)
            elif kind == "rec":
                self._ingest_record(p, st, msg.get("rec") or {})
            elif kind in ("hb", "bye"):
                st.drops = int(msg.get("drops", st.drops))
                st.sent = int(msg.get("sent", st.sent))
                if kind == "bye":
                    st.closed = True

    def _ingest_record(self, p: int, st: _ProcState, rec: dict) -> None:
        st.records += 1
        kind = rec.get("kind")
        if kind == "step":
            if rec.get("step_ms") is not None:
                self._ingest_sample(p, st, "step_ms",
                                    float(rec["step_ms"]))
            if rec.get("active_slots") is not None and st.serving:
                slots = st.serving.get("slots")
                if slots:
                    self._ingest_sample(
                        p, st, "occupancy",
                        float(rec["active_slots"]) / float(slots))
            if rec.get("queue_depth") is not None:
                self._ingest_sample(p, st, "queue_depth",
                                    float(rec["queue_depth"]))
        elif kind == "serving":
            st.serving = rec
        elif kind == "alert":
            st.alerts += 1

    def _ingest_sample(self, p: int, st: _ProcState, metric: str,
                       value: float) -> None:
        st.push(metric, value)
        # merged-stream rules see every replica's raw samples
        if metric in self._merged:
            self.monitor.observe(metric, value,
                                 context={"scope": "fleet",
                                          "process": p})
        self._ingested += 1
        if self._ingested % self.eval_every == 0:
            self._eval_derived()

    def _eval_derived(self) -> None:
        """Recompute the cross-replica metrics and feed the monitor —
        the rules only a fleet view can evaluate. Caller holds _mu."""
        occ = {p: st.mean("occupancy")
               for p, st in self._procs.items()}
        occ = {p: v for p, v in occ.items() if v is not None}
        if occ:
            lo_p = min(occ, key=occ.get)
            self.monitor.observe("occupancy_min", occ[lo_p],
                                 context={"scope": "fleet",
                                          "process": lo_p})
            self.monitor.observe(
                "occupancy_mean", sum(occ.values()) / len(occ),
                context={"scope": "fleet"})
            if len(occ) > 1:
                self.monitor.observe(
                    "occupancy_skew", max(occ.values()) - occ[lo_p],
                    context={"scope": "fleet", "process": lo_p})
        emas = {p: st.mean("step_ms") for p, st in self._procs.items()}
        emas = {p: v for p, v in emas.items() if v is not None}
        if len(emas) > 1:
            hi_p = max(emas, key=emas.get)
            med = _percentile(sorted(emas.values()), 50)
            self.monitor.observe(
                "step_skew_frac",
                (emas[hi_p] - min(emas.values())) / max(med, 1e-9),
                context={"scope": "fleet", "process": hi_p})
        qd = [st.win["queue_depth"][-1] for st in self._procs.values()
              if st.win.get("queue_depth")]
        if qd:
            self.monitor.observe("queue_depth_max", max(qd),
                                 context={"scope": "fleet"})

    # -- the remediation seam (same contract as SLOMonitor) ----------------
    def on_alert(self, callback: Callable[[dict], None]) -> None:
        """Register a fleet-alert consumer — ``runtime.Supervisor`` or
        the router tier's admission control. Every payload carries
        ``scope: "fleet"``."""
        self.monitor.on_alert(callback)

    @property
    def alerts(self) -> list:
        return self.monitor.alerts

    # -- read views --------------------------------------------------------
    def snapshot(self) -> dict:
        """The fleet state as one JSON-able dict (``/snapshot``,
        ``serve_top``, and the close-time flush all read this)."""
        now = time.time()
        with self._mu:
            rows = []
            drops_total = 0
            for p in sorted(self._procs):
                st = self._procs[p]
                drops_total += st.drops
                sv = st.serving or {}
                rows.append({
                    "process": p, "run": st.run,
                    "samples": st.samples, "records": st.records,
                    "occupancy": st.mean("occupancy"),
                    "step_p50_ms": st.pct("step_ms", 50),
                    "ttft_p95_ms": st.pct("ttft_ms", 95),
                    "token_lat_p95_ms": st.pct("token_lat_ms", 95),
                    "queue_depth": (st.win["queue_depth"][-1]
                                    if st.win.get("queue_depth")
                                    else None),
                    "completed": sv.get("completed"),
                    "offered": sv.get("requests"),
                    "spec_k": sv.get("spec_k"),
                    "spec_accept_mean": sv.get("spec_accept_mean"),
                    "drops": st.drops, "sent": st.sent,
                    "alerts": st.alerts,
                    "age_s": round(now - st.last_seen, 3),
                    "closed": st.closed,
                })
            merged: dict[str, list] = {}
            for st in self._procs.values():
                for m in MERGED_METRICS:
                    if st.win.get(m):
                        merged.setdefault(m, []).extend(st.win[m])
            fleet = {"processes": len(rows),
                     "alerts": len(self.monitor.alerts),
                     "rules": [r.name for r in self.monitor.rules],
                     "violated": sorted({a["rule"] for a
                                         in self.monitor.alerts}),
                     "drops_total": drops_total}
            for m, vals in merged.items():
                s = sorted(vals)
                fleet[m] = {"p50": round(_percentile(s, 50), 3),
                            "p95": round(_percentile(s, 95), 3),
                            "p99": round(_percentile(s, 99), 3)}
            occ = [r["occupancy"] for r in rows
                   if r["occupancy"] is not None]
            if occ:
                fleet["occupancy"] = {
                    "min": round(min(occ), 4),
                    "mean": round(sum(occ) / len(occ), 4),
                    "max": round(max(occ), 4)}
        return {"t": now, "fleet": fleet, "replicas": rows}

    def prometheus(self) -> str:
        """The ``/metrics`` exposition (Prometheus text format 0.0.4).
        Gauges per replica (``process`` label), merged-stream latency
        percentiles as ``quantile``-labelled gauges, plus counters for
        samples / drops / fleet alerts."""
        snap = self.snapshot()
        out = []

        def head(name, help_txt, typ="gauge"):
            out.append(f"# HELP {name} {help_txt}")
            out.append(f"# TYPE {name} {typ}")

        head(prometheus_name("up"), "replica stream is open (bye=0)")
        for r in snap["replicas"]:
            out.append(f'{prometheus_name("up")}'
                       f'{{process="{r["process"]}"}} '
                       f'{0 if r["closed"] else 1}')
        gauges = (("occupancy", "rolling mean active-slot fraction"),
                  ("step_p50_ms", "rolling decode/train step p50"),
                  ("queue_depth", "last reported admission queue depth"))
        for key, txt in gauges:
            name = prometheus_name(key)
            head(name, txt)
            for r in snap["replicas"]:
                if r[key] is not None:
                    out.append(f'{name}{{process="{r["process"]}"}} '
                               f'{round(r[key], 6)}')
        for m in MERGED_METRICS:
            agg = snap["fleet"].get(m)
            if not agg:
                continue
            name = prometheus_name(m)
            head(name, f"fleet-merged {m} percentiles")
            for q in ("p50", "p95", "p99"):
                out.append(f'{name}{{quantile="0.{q[1:]}"}} {agg[q]}')
        counters = (("samples_total", "samples", "samples ingested"),
                    ("drops_total", "drops",
                     "emitter-side dropped samples"),
                    ("alerts_total", "alerts",
                     "per-replica alert records seen"))
        for name, key, txt in counters:
            pname = prometheus_name(name)
            head(pname, txt, "counter")
            for r in snap["replicas"]:
                out.append(f'{pname}{{process="{r["process"]}"}} '
                           f'{r[key]}')
        head(prometheus_name("fleet_alerts_total"),
             "fleet-scope SLO alerts fired by the collector", "counter")
        out.append(f'{prometheus_name("fleet_alerts_total")} '
                   f'{snap["fleet"]["alerts"]}')
        return "\n".join(out) + "\n"

    # -- /metrics HTTP -----------------------------------------------------
    def _start_http(self, port: int) -> None:
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)
        collector = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/metrics"):
                    body = collector.prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/snapshot"):
                    body = json.dumps(collector.snapshot()).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):    # no stderr spam per scrape
                pass

        self._http = ThreadingHTTPServer(("127.0.0.1", int(port)),
                                         Handler)
        self.metrics_url = (f"http://127.0.0.1:"
                            f"{self._http.server_address[1]}/metrics")
        t = threading.Thread(target=self._http.serve_forever,
                             name="apex-live-http", daemon=True)
        t.start()
        self._threads.append(t)

    # -- close: flush the final state as ordinary telemetry records --------
    def flush_records(self, logger=None) -> int:
        """Write the collector's current state into a ``MetricsLogger``
        as ordinary records: one ``live_replica`` event per replica,
        one ``live_fleet`` event, and one ``live_drop`` record per
        replica that reported drops — so ``telemetry_report.py``
        renders the LIVE table from a plain sidecar."""
        logger = logger or self.logger
        if logger is None:
            return 0
        snap = self.snapshot()
        n = 0
        for r in snap["replicas"]:
            fields = {k: v for k, v in r.items() if v is not None}
            logger.event("live_replica", **fields)
            n += 1
            logger.log_live_drop(process=r["process"],
                                 drops=r["drops"], sent=r["sent"])
            n += 1
        fleet = dict(snap["fleet"])
        for m in MERGED_METRICS:
            if isinstance(fleet.get(m), dict):
                fleet[m + "_p95"] = fleet.pop(m)["p95"]
        if isinstance(fleet.get("occupancy"), dict):
            occ = fleet.pop("occupancy")
            fleet["occupancy_min"] = occ["min"]
            fleet["occupancy_mean"] = occ["mean"]
        fleet["rules"] = ",".join(fleet.get("rules", []))
        fleet["violated"] = ",".join(fleet.get("violated", []))
        logger.event("live_fleet", **fleet)
        logger.flush()
        return n + 1

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        if isinstance(self._addr_spec, str) and \
                os.path.exists(self._addr_spec):
            try:
                os.unlink(self._addr_spec)
            except OSError:
                pass
        self.flush_records()

    def __enter__(self) -> "LiveCollector":
        return self.start() if self._srv is None else self

    def __exit__(self, *exc) -> None:
        self.close()
