# Copied from apex_tpu/serve/router.py (stdlib only at module level), so
# the port imports nothing of the JAX package. What differs: the engine,
# its results and the endpoint parser are the port's, bound lazily; and on
# the card an EngineReplica runs its engine on a CUDA stream of its own,
# refuses an engine whose programs are not all captured, and keeps any
# program from capturing while it runs (serve/programs.py, the fleet).
"""Multi-replica router/autoscaler tier (r19) — million-user serving.

One :class:`~apex_tpu_torch.serve.engine.ContinuousBatchingEngine` is a
single slot pool; production traffic needs N engine replicas behind a
router (ROADMAP north star; TorchTitan, arXiv:2410.06511, is the
production-subsystem framing). This module is that tier, stitched onto
the platform the previous rounds built: replicas are the
``fleet_smoke --serve`` engine shape, their in-flight view is the r18
live telemetry plane (``prof.live``), and admission control is the
first ROUTING consumer of the ``on_alert`` seam.

The pieces:

- **Routing policies** (:data:`POLICIES`): ``least-queue`` (argmin of
  outstanding requests), ``session-affinity`` (a session key maps to
  ONE replica for its lifetime), ``power-of-two-choices`` (two seeded
  random candidates, the less loaded wins — the classic load-balancing
  result: near-least-queue balance at O(1) state reads), and
  ``prefix-affinity`` (r20: route by the prompt's first-page content
  hash — ``serve.prefix.prefix_route_key``, the same chain-hash the
  engine's shared-prefix cache is keyed by — so every request carrying
  a given system prompt lands on the replica whose page pool already
  holds its prefilled pages; affinity finally has something to be
  affine TO).
- **:class:`AdmissionController`** — SLO-driven admission control and
  load-shedding on the ``SLOMonitor.on_alert`` seam (a
  ``prof.live.LiveCollector``'s fleet-scope rules or any per-process
  monitor attach the same way). A tripped budget opens a shed window:
  with shedding ARMED, arrivals inside the window are dropped —
  COUNTED and ATTRIBUTED to the triggering rule + culprit replica
  (the ``unattributed-shed`` lint rule pins this contract); with
  shedding off, the window only REDIRECTS load away from the alert's
  culprit replica (zero-drop mode stays zero-drop).
- **:class:`OccupancyScaler`** — rolling-occupancy-driven
  scale-up/down: mean active-replica occupancy above ``high`` with
  queued work activates a standby replica, below ``low`` drains the
  least-loaded one back out; every decision is a recorded scale event.
- **:class:`Router`** — the hot loop: poll arrivals, consult
  admission, pick a replica, submit. Completions come back on the
  engine's ``on_retire`` seam (in-process) or as ``done`` acks
  (socket transport). A replica that dies with requests in flight —
  its socket drops, or the live plane reports its ``bye``/``restore``
  — has its in-flight requests re-enqueued and redirected to the
  survivors, and (r21) any tokens it already COMMITTED downstream are
  replayed as a prompt extension: the survivor decodes from the
  committed prefix with the remaining budget, so the restarted greedy
  stream is BIT-equal to one that never failed over
  (:meth:`Router.stitch_results` rejoins the prefix; only the decode
  WORK for the committed tokens is lost, never the tokens).
- **Replica handles**: :class:`EngineReplica` runs an engine in a
  daemon thread on a :class:`RouterFeed` (the engine's externally-fed
  admission hook) with a :class:`ReplicaProbe` riding the ``live=``
  seam — one process, N slot pools, the ``serve_bench --router N``
  shape. :class:`RouterServer`/:class:`SocketReplica`/
  :class:`ReplicaClient` are the multiprocess transport
  (``fleet_smoke --serve --router``): newline-JSON over localhost
  TCP, and — the step-path contract the live plane established —
  NOTHING on the routing or scheduler hot path ever touches a
  socket: submits and acks are queue handoffs to background sender
  threads (``blocking-emit-on-step-path`` audits this module).

Module-level imports are stdlib-only: the socket transport's PARENT
hosts the router without ever importing torch (engine/numpy imports
bind lazily inside the in-process replica and child-client paths).
"""

from __future__ import annotations

import dataclasses
import json
import queue
import random
import socket
import threading
import time
from collections import deque
from typing import Callable, Optional

# serve.prefix is itself stdlib-only (hashlib), so this keeps the
# parent-hosts-the-router-without-torch property intact
from apex_tpu_torch.serve.prefix import prefix_route_key

__all__ = ["POLICIES", "Router", "RouterFeed", "EngineReplica",
           "ReplicaProbe", "AdmissionController", "OccupancyScaler",
           "RouterServer", "SocketReplica", "ReplicaClient",
           "WireRequest", "synthetic_requests", "merge_router_run"]

POLICIES = ("least-queue", "session-affinity", "power-of-two-choices",
            "prefix-affinity")


# ---------------------------------------------------------------------------
# Requests on the wire (stdlib-only twin of serve.engine.Request)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WireRequest:
    """A routable request the PARENT process can hold without torch:
    same fields as ``serve.engine.Request`` with the prompt as a plain
    int list. ``ReplicaClient`` rebuilds the real ``Request`` child-
    side; the in-process router path never needs this class.

    ``trace``/``hop`` (r22) are the distributed-trace context: the
    router stamps ``trace`` on first routing and bumps ``hop`` on
    every failover re-enqueue; both ride the socket frames so the
    replica-side engine spans and the router-side spans of one request
    share a fleet-wide id (``prof.spans.merge_process_traces``)."""
    id: int
    prompt: list
    max_new: int
    arrival_s: float = 0.0
    session: Optional[int] = None
    trace: Optional[str] = None
    hop: int = 0


def synthetic_requests(n: int, *, rate: float, prompt_lo: int = 3,
                       prompt_hi: int = 10, new_lo: int = 2,
                       new_hi: int = 10, vocab_size: int = 64,
                       seed: int = 0, sessions: int = 0
                       ) -> "list[WireRequest]":
    """Seed-deterministic Poisson request set as :class:`WireRequest`
    s — the stdlib twin of ``serve.traffic.poisson_requests`` for
    processes hosting the router that must not import torch/numpy
    (the socket transport's parent). ``rate <= 0``: everything arrives
    at t=0. ``sessions`` > 0 assigns each request a session key in [0,
    sessions)."""
    rng = random.Random(seed)
    t = 0.0
    out = []
    for i in range(n):
        if rate > 0:
            t += rng.expovariate(rate)
        plen = rng.randint(prompt_lo, prompt_hi)
        out.append(WireRequest(
            id=i,
            prompt=[rng.randrange(vocab_size) for _ in range(plen)],
            max_new=rng.randint(new_lo, new_hi),
            arrival_s=t if rate > 0 else 0.0,
            session=(rng.randrange(sessions) if sessions else None)))
    return out


# ---------------------------------------------------------------------------
# The engine-side feed (externally-fed admission)
# ---------------------------------------------------------------------------

class RouterFeed:
    """The externally-fed admission source ``engine.run`` consumes:
    ``push`` is the router's submit side, ``poll``/``closed`` the
    engine scheduler's drain side. Thread-safe; ``closed`` only reads
    True once the feed is closed AND drained, so a request pushed just
    before ``close()`` is never lost."""

    def __init__(self):
        self._mu = threading.Lock()
        self._q: list = []
        self._closed = False

    def push(self, req) -> None:
        with self._mu:
            if self._closed:
                raise RuntimeError("push() on a closed RouterFeed")
            self._q.append(req)

    def poll(self) -> list:
        with self._mu:
            out, self._q = self._q, []
            return out

    def close(self) -> None:
        with self._mu:
            self._closed = True

    @property
    def closed(self) -> bool:
        with self._mu:
            return self._closed and not self._q


class ReplicaProbe:
    """The router's in-process tap on a replica's live stream: quacks
    like a ``prof.live.LiveEmitter`` (``observe`` / ``observe_many``)
    so ``engine.run(live=...)`` feeds it at zero extra engine surface,
    keeps a rolling occupancy window for the autoscaler, and forwards
    every sample to a REAL emitter when one is attached (the
    serve_bench ``--router --live`` path streams to a collector AND
    scales off the same observations)."""

    def __init__(self, window: int = 32, forward=None):
        self._mu = threading.Lock()
        self._occ: deque = deque(maxlen=window)
        self.forward = forward

    def observe(self, metric: str, value, **tags) -> None:
        if metric == "occupancy":
            with self._mu:
                self._occ.append(float(value))
        if self.forward is not None:
            self.forward.observe(metric, value, **tags)

    def observe_many(self, **metrics) -> None:
        occ = metrics.get("occupancy")
        if occ is not None:
            with self._mu:
                self._occ.append(float(occ))
        if self.forward is not None:
            self.forward.observe_many(**metrics)

    def occupancy_mean(self) -> Optional[float]:
        with self._mu:
            if not self._occ:
                return None
            return sum(self._occ) / len(self._occ)


# ---------------------------------------------------------------------------
# Replica handles
# ---------------------------------------------------------------------------

class EngineReplica:
    """One in-process engine replica: a ``ContinuousBatchingEngine``
    run in a daemon thread on a :class:`RouterFeed`, with a
    :class:`ReplicaProbe` riding the ``live=`` seam. ``submit`` is a
    lock-guarded list append — nothing on the routing hot path blocks
    on the replica's scheduler.

    On the card (``serve.programs.join_fleet``) ``start`` refuses an
    engine whose programs are not all captured (call ``warmup()``
    first), and the thread feeds, replays and fetches on a CUDA stream
    of its own (``stream``), ordered after the starting thread's work,
    so one replica's fetch never waits for another's replays. While it
    runs, no program of any engine may capture or run eagerly."""

    def __init__(self, engine, index: int, *, emitter=None,
                 telemetry=None, tracer=None, flightrec=None):
        self.engine = engine
        self.index = int(index)
        self.feed = RouterFeed()
        self.probe = ReplicaProbe(forward=emitter)
        self.telemetry = telemetry
        self.tracer = tracer
        self.flightrec = flightrec
        self.alive = True
        self.results = None
        self.stats = None
        self.error: Optional[BaseException] = None
        self.stream = None
        self._thread: Optional[threading.Thread] = None

    def start(self, t0: float, on_retire: Callable) -> None:
        from apex_tpu_torch.serve import programs
        self.stream = programs.join_fleet(self.engine)

        def _run():
            try:
                with programs.fleet_member(self.stream):
                    self.results, self.stats = self.engine.run(
                        self.feed, telemetry=self.telemetry,
                        tracer=self.tracer, live=self.probe, t0=t0,
                        on_retire=on_retire, flightrec=self.flightrec)
            except BaseException as e:      # surfaced by merge_router_run
                self.error = e
                self.alive = False

        self._thread = threading.Thread(
            target=_run, name=f"apex-router-replica-{self.index}",
            daemon=True)
        self._thread.start()

    def submit(self, req) -> None:
        self.feed.push(req)

    def close(self) -> None:
        self.feed.close()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def occupancy(self) -> Optional[float]:
        return self.probe.occupancy_mean()


# ---------------------------------------------------------------------------
# SLO-driven admission control (the on_alert seam's routing consumer)
# ---------------------------------------------------------------------------

class AdmissionController:
    """Turns in-run SLO alerts into routing decisions. Attach it to
    any alert source with the ``on_alert(callback)`` seam — a
    ``prof.live.LiveCollector`` (fleet-scope rules: the intended
    production shape) or a plain ``SLOMonitor``.

    Each alert opens (or extends) a WINDOW of ``window_s`` seconds:

    - shedding ARMED (``shed=True``): arrivals inside the window are
      shed — the router drops them with attribution ``(rule,
      replica)`` instead of queueing past a budget already known
      blown. Load-shedding trades completion for tail latency, and
      the trade is only honest if every shed is counted and named.
    - shedding off: the window only REDIRECTS — the alert's culprit
      replica (the ``process`` a fleet-scope alert names) is avoided
      until the window closes; nothing is ever dropped.
    """

    def __init__(self, *, shed: bool = False, window_s: float = 0.25,
                 rules: Optional[list] = None):
        self.shed = bool(shed)
        self.window_s = float(window_s)
        self.rules = list(rules) if rules else None   # None = any rule
        self._mu = threading.Lock()
        self._until = 0.0           # monotonic deadline of the window
        self._rule: Optional[str] = None
        self._culprit: Optional[int] = None
        self.alerts_consumed = 0

    def attach(self, source) -> "AdmissionController":
        source.on_alert(self._on_alert)
        return self

    # the seam callback: runs on the alert source's thread
    def _on_alert(self, alert: dict) -> None:
        rule = alert.get("rule")
        if self.rules is not None and rule not in self.rules:
            return
        with self._mu:
            self.alerts_consumed += 1
            self._until = time.monotonic() + self.window_s
            self._rule = rule
            self._culprit = alert.get("process")

    def trip(self, rule: str, replica: Optional[int] = None) -> None:
        """Open a window directly (tests / manual remediation)."""
        self._on_alert({"rule": rule, "process": replica})

    def decide(self) -> "tuple[str, Optional[str], Optional[int]]":
        """``("admit" | "shed" | "redirect", rule, culprit)`` for the
        next arrival. O(1), lock-guarded — called on the routing hot
        path."""
        with self._mu:
            if time.monotonic() >= self._until:
                return "admit", None, None
            if self.shed:
                return "shed", self._rule, self._culprit
            return "redirect", self._rule, self._culprit


# ---------------------------------------------------------------------------
# Rolling-occupancy autoscaler
# ---------------------------------------------------------------------------

class OccupancyScaler:
    """Scale the ACTIVE replica set on rolling mean occupancy: above
    ``high`` with queued work -> activate a standby; below ``low`` ->
    drain the least-loaded active replica back out. ``cooldown_s``
    debounces flapping. Pure decision logic — the Router owns the
    active set and records the events."""

    def __init__(self, *, low: float = 0.25, high: float = 0.85,
                 min_replicas: int = 1, max_replicas: int = 0,
                 cooldown_s: float = 0.25):
        if not 0.0 <= low < high <= 1.0:
            raise ValueError(f"need 0 <= low < high <= 1, got "
                             f"({low}, {high})")
        self.low = float(low)
        self.high = float(high)
        self.min_replicas = max(int(min_replicas), 1)
        self.max_replicas = int(max_replicas)    # 0 = fleet size
        self.cooldown_s = float(cooldown_s)
        self._last = -1e9

    def decide(self, occupancies: "dict[int, Optional[float]]",
               queued: int, n_total: int,
               now_s: float) -> "Optional[tuple[str, float]]":
        """``("up"|"down", mean_occ)`` or None. ``occupancies`` maps
        ACTIVE replica index -> rolling mean (None = no samples
        yet)."""
        if now_s - self._last < self.cooldown_s:
            return None
        vals = [v for v in occupancies.values() if v is not None]
        if not vals:
            return None
        mean = sum(vals) / len(vals)
        n_active = len(occupancies)
        cap = self.max_replicas or n_total
        if mean > self.high and queued > 0 and n_active < cap:
            self._last = now_s
            return "up", mean
        if mean < self.low and n_active > self.min_replicas:
            self._last = now_s
            return "down", mean
        return None


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------

def _session_key(req) -> Optional[int]:
    s = getattr(req, "session", None)
    return None if s is None else int(s)


class Router:
    """Route a request stream across N replica handles.

    Replica handles need ``submit(req)``, ``close()`` and an ``index``;
    :class:`EngineReplica` (in-process threads) and
    :class:`SocketReplica` (multiprocess transport) are the shipped
    ones, and tests use plain fakes. Completions are reported back via
    :meth:`on_complete` (the EngineReplica wires ``engine.run``'s
    ``on_retire`` seam to it; SocketReplica's reader thread calls it
    per ``done`` ack) — outstanding depth per replica is
    ``routed - completed``, which is what ``least-queue`` and
    ``power-of-two-choices`` balance on.

    ``admission`` (:class:`AdmissionController`) sheds or redirects
    inside alert windows; ``scaler`` (:class:`OccupancyScaler`) moves
    replicas in and out of the active set on rolling occupancy;
    ``initial_active`` caps how many replicas start active (default
    all — set it with a scaler to watch scale-up happen).

    A replica reported down (:meth:`on_replica_down` — socket EOF, or
    the live plane's ``bye``/``restore`` for that process) leaves the
    candidate set and its in-flight requests are re-enqueued at the
    router and redirected to the survivors. Tokens the dead replica
    already COMMITTED (``partials``) are folded into the re-enqueued
    request's prompt with the budget reduced — the survivor continues
    the stream exactly where it stopped (bit-equal under greedy), and
    :meth:`stitch_results` rejoins the committed prefix so callers see
    one uninterrupted stream per request.
    """

    def __init__(self, replicas, *, policy: str = "least-queue",
                 admission: Optional[AdmissionController] = None,
                 scaler: Optional[OccupancyScaler] = None,
                 seed: int = 0, initial_active: Optional[int] = None,
                 prefix_page: int = 32, tracer=None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        if not replicas:
            raise ValueError("router needs at least one replica")
        if prefix_page < 1:
            raise ValueError(f"prefix_page must be >= 1, "
                             f"got {prefix_page}")
        self.replicas = list(replicas)
        self.policy = policy
        # prefix-affinity: match the fleet's engine page_size so the
        # router's key granularity equals the cache's share granularity
        self.prefix_page = int(prefix_page)
        self.admission = admission
        self.scaler = scaler
        # r22: optional prof.spans.SpanTracer — every routing decision
        # becomes a router-side span (route ⊃ admission, shed/redirect
        # instants, replay_hop/replay_stitch on failover) carrying the
        # same trace id the replica-side engine spans carry
        self.tracer = tracer
        self._traces: dict = {}              # request id -> trace id
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        n = len(self.replicas)
        k = n if initial_active is None else max(1, min(int(
            initial_active), n))
        self.active = set(range(k))
        self.dead: set = set()
        self._affinity: dict = {}            # session -> replica index
        self._prefix_map: dict = {}          # prefix hash -> replica
        self._replayed: dict = {}            # request id -> committed toks
        self._replay_plen: dict = {}         # request id -> ORIGINAL plen
        self._inflight: "list[dict]" = [dict() for _ in range(n)]
        self.routed = [0] * n
        self.completed = [0] * n
        self.redirected = [0] * n
        self.shed_count = [0] * n
        self.shed_log: "list[dict]" = []
        self.scale_events: "list[dict]" = []
        self.candidate_filter: Optional[Callable] = None
        self._t0: Optional[float] = None
        self.duration_s = 0.0

    # -- completion / failure seams ---------------------------------------
    def on_complete(self, index: int, request_id: int) -> None:
        with self._mu:
            self._inflight[index].pop(request_id, None)
            self.completed[index] += 1

    def on_replica_down(self, index: int,
                        partials: "Optional[dict]" = None) -> "list":
        """Mark a replica dead and pull back its in-flight requests;
        returns them ready to re-route (RE-ROUTING is the caller's
        loop's job — they are prepended to the router queue by
        :meth:`run`, or re-routed immediately via :meth:`reroute` by
        transport callbacks).

        ``partials`` (r21) maps request id -> the tokens the dead
        replica already COMMITTED downstream for that request.
        Committed tokens cannot be un-delivered, so instead of
        restarting the stream from scratch (which re-emits — or, at
        temperature, DIVERGES from — what the consumer already has),
        the replay folds them into the request: the survivor gets
        ``prompt + committed`` with ``max_new`` reduced by the prefix
        length, continuing the decode exactly where the dead replica
        stopped. Under greedy decoding the continuation is bit-equal
        to a run that never failed over — only the decode WORK behind
        the committed tokens is lost, never the tokens
        (:meth:`stitch_results` rejoins the prefix for callers). A
        request whose whole budget was already committed is complete:
        counted against the dead replica, not re-enqueued."""
        partials = partials or {}
        with self._mu:
            if index in self.dead:
                return []
            self.dead.add(index)
            self.active.discard(index)
            orphans = list(self._inflight[index].values())
            self._inflight[index].clear()
            # their original routing no longer counts as outstanding;
            # the re-route re-counts them on the new replica
        out = []
        for req in orphans:
            committed = [int(t) for t in
                         partials.get(int(req.id), ())][:int(req.max_new)]
            if not committed:
                out.append(req)
                continue
            with self._mu:
                # a second failover extends the first one's prefix;
                # req.prompt already carries any earlier replay, so
                # the ORIGINAL prompt length is recoverable here
                prior = self._replayed.setdefault(int(req.id), [])
                self._replay_plen.setdefault(
                    int(req.id), len(req.prompt) - len(prior))
                prior.extend(committed)
            if len(committed) >= int(req.max_new):
                # the dying replica committed the full budget — the
                # stream is complete, there is nothing to replay
                with self._mu:
                    self.completed[index] += 1
                continue
            prompt = [int(t) for t in req.prompt] + committed
            if hasattr(req.prompt, "dtype"):     # engine Request: np
                import numpy as np
                prompt = np.asarray(prompt, np.int32)
            out.append(dataclasses.replace(
                req, prompt=prompt,
                max_new=int(req.max_new) - len(committed)))
        return out

    def stitch_results(self, results) -> "list":
        """Rejoin failover streams: for every result whose request had
        a committed prefix replayed (:meth:`on_replica_down`), prepend
        the committed tokens and restore the ORIGINAL prompt length —
        the caller sees one uninterrupted per-request stream, greedy
        bit-equal to a run with no failover. Prepended tokens carry
        the survivor's first token time (their true delivery times
        died with the replica — latency percentiles stay honest about
        what THIS fleet incarnation served). Requests whose whole
        budget was committed before the failover get a synthesized
        completed result (no survivor ever saw them). Results without
        a replay pass through unchanged; call it on the merged result
        list after the replicas join."""
        with self._mu:
            replayed = {k: list(v) for k, v in self._replayed.items()}
        if not replayed:
            return list(results)
        from apex_tpu_torch.serve.engine import RequestResult
        out = []
        seen = set()
        for r in results:
            pre = replayed.get(int(r.id))
            if pre:
                seen.add(int(r.id))
                t0 = (r.token_times[0] if r.token_times
                      else r.finish_s or r.arrival_s)
                r = dataclasses.replace(
                    r, prompt_len=max(r.prompt_len - len(pre), 0),
                    tokens=pre + list(r.tokens),
                    token_times=[t0] * len(pre) + list(r.token_times))
            out.append(r)
        for rid in sorted(set(replayed) - seen):
            pre = replayed[rid]
            out.append(RequestResult(
                id=rid, prompt_len=self._replay_plen.get(rid, 0),
                arrival_s=0.0, finish_s=0.0, tokens=list(pre),
                token_times=[0.0] * len(pre)))
        if self.tracer is not None:
            for rid in sorted(replayed):
                self.tracer.instant(
                    "replay_stitch", request=int(rid),
                    trace=self._traces.get(int(rid))
                    or f"t{int(rid)}",
                    committed=len(replayed[rid]))
        out.sort(key=lambda r: r.id)
        return out

    def reroute(self, reqs, from_index: int) -> "list[dict]":
        """Re-enqueue requests a dying replica never committed: route
        each to a surviving candidate, counting it ``redirected``
        against the ORIGINAL replica. Returns shed rows for any the
        admission controller dropped instead."""
        rows = []
        for req in reqs:
            with self._mu:
                self.redirected[from_index] += 1
            try:
                req.hop = int(getattr(req, "hop", 0) or 0) + 1
            except Exception:
                pass
            if self.tracer is not None:
                rid = int(req.id)
                self.tracer.instant(
                    "replay_hop", request=rid,
                    trace=self._traces.get(rid) or f"t{rid}",
                    hop=int(getattr(req, "hop", 1) or 1),
                    from_replica=int(from_index),
                    committed=len(self._replayed.get(rid, ())))
            rows.extend(self._route_one(req, exclude={from_index}))
        return rows

    # -- candidate selection ----------------------------------------------
    def _candidates(self, req, exclude: set) -> "list[int]":
        cand = [i for i in sorted(self.active)
                if i not in self.dead and i not in exclude]
        if self.candidate_filter is not None:
            kept = [i for i in cand
                    if self.candidate_filter(req, i)]
            if kept:
                cand = kept
        return cand

    def _pick(self, req, cand: "list[int]") -> int:
        depth = {i: len(self._inflight[i]) for i in cand}
        if self.policy == "least-queue":
            return min(cand, key=lambda i: (depth[i], i))
        if self.policy == "power-of-two-choices":
            if len(cand) == 1:
                return cand[0]
            a, b = self._rng.sample(cand, 2)
            return min((a, b), key=lambda i: (depth[i], i))
        if self.policy == "prefix-affinity":
            # pin each first-page CONTENT hash to the replica that
            # first prefilled it: that replica's engine holds the
            # prefix's cached pages, so routing there turns the fleet
            # into a sharded prefix cache (hot system prompts stay
            # replica-local). Prompts shorter than one page (and a
            # pinned replica that died) fall back to least-queue.
            key = prefix_route_key(req.prompt, self.prefix_page)
            if key is None:
                return min(cand, key=lambda i: (depth[i], i))
            pinned = self._prefix_map.get(key)
            if pinned is not None and pinned in cand:
                return pinned
            pick = min(cand, key=lambda i: (depth[i], i))
            self._prefix_map[key] = pick
            return pick
        # session-affinity: pin each session to the replica its first
        # request landed on (least-queue seats new sessions); requests
        # without a session key fall back to least-queue
        s = _session_key(req)
        if s is None:
            return min(cand, key=lambda i: (depth[i], i))
        pinned = self._affinity.get(s)
        if pinned is not None and pinned in cand:
            return pinned
        pick = min(cand, key=lambda i: (depth[i], i))
        self._affinity[s] = pick
        return pick

    # -- trace context (r22) ------------------------------------------------
    def _stamp_trace(self, req) -> str:
        """Stamp (or recover) the request's fleet-wide trace id. The
        id is minted on FIRST routing and sticks across shed/redirect/
        replay — a re-enqueued request keeps the trace its original
        submit carried, so its spans on the dead and surviving lanes
        merge into one track."""
        trace = getattr(req, "trace", None)
        if trace is None:
            trace = self._traces.get(int(req.id)) or f"t{int(req.id)}"
            try:
                req.trace = trace
                if getattr(req, "hop", None) is None:
                    req.hop = 0
            except Exception:
                pass    # a handle without the fields still routes
        self._traces[int(req.id)] = trace
        return trace

    # -- routing one request ----------------------------------------------
    def _route_one(self, req, exclude: "Optional[set]" = None
                   ) -> "list[dict]":
        """Admission -> policy -> submit. Returns [] on a routed
        request, or the one shed row when admission dropped it."""
        exclude = set(exclude or ())
        tr = self.tracer
        trace = self._stamp_trace(req)
        hop = int(getattr(req, "hop", 0) or 0)
        rs = (tr.begin("route", request=int(req.id), trace=trace,
                       hop=hop) if tr is not None else None)
        if self.admission is not None:
            asid = (tr.begin("admission", parent=rs,
                             request=int(req.id), trace=trace)
                    if tr is not None else None)
            action, rule, culprit = self.admission.decide()
            if tr is not None:
                tr.end(asid, action=action,
                       **({"rule": rule} if rule else {}))
        else:
            action, rule, culprit = ("admit", None, None)
        if action == "redirect" and culprit is not None:
            exclude.add(int(culprit))
            if tr is not None:
                tr.instant("redirect", parent=rs, request=int(req.id),
                           trace=trace, rule=rule,
                           culprit=int(culprit))
        cand = self._candidates(req, exclude)
        if not cand and action != "shed":
            # redirect is BEST-EFFORT: a fleet of one (or an alert
            # naming the only survivor) must still route — only an
            # armed shed window may drop
            cand = self._candidates(req, set(exclude)
                                    - {int(culprit)}
                                    if culprit is not None
                                    else set())
        if action == "shed" or not cand:
            # attribute every drop: the rule that tripped (or the
            # no-candidates condition) + the replica the load was
            # heading for (the culprit, else the policy's pick over
            # the unfiltered active set)
            target = culprit
            if target is None:
                fallback = self._candidates(req, set())
                target = (self._pick(req, fallback) if fallback
                          else -1)
            row = {"request": int(req.id),
                   "rule": rule or "no-candidates",
                   "replica": int(target),
                   "t_s": round(self._now(), 4)}
            with self._mu:
                if 0 <= int(target) < len(self.shed_count):
                    self.shed_count[int(target)] += 1
                self.shed_log.append(row)
            if tr is not None:
                tr.instant("shed", parent=rs, request=int(req.id),
                           trace=trace, rule=row["rule"],
                           replica=row["replica"])
                tr.end(rs, outcome="shed")
            return [row]
        pick = self._pick(req, cand)
        with self._mu:
            self._inflight[pick][int(req.id)] = req
            self.routed[pick] += 1
        self.replicas[pick].submit(req)
        if tr is not None:
            tr.end(rs, replica=int(pick))
        return []

    def _now(self) -> float:
        if self._t0 is None:
            return 0.0
        return time.perf_counter() - self._t0

    # -- the scale tick ----------------------------------------------------
    def _scale_tick(self, queued: int) -> None:
        if self.scaler is None:
            return
        occ = {i: self.replicas[i].occupancy()
               for i in sorted(self.active) if i not in self.dead
               and hasattr(self.replicas[i], "occupancy")}
        if not occ:
            return
        verdict = self.scaler.decide(occ, queued,
                                     len(self.replicas) -
                                     len(self.dead), self._now())
        if verdict is None:
            return
        action, mean = verdict
        if action == "up":
            standby = [i for i in range(len(self.replicas))
                       if i not in self.active and i not in self.dead]
            if not standby:
                return
            target = standby[0]
            self.active.add(target)
        else:
            # drain the least-loaded active replica (never below the
            # scaler's floor — decide() already enforced it)
            target = min(occ, key=lambda i: (occ[i] or 0.0, i))
            self.active.discard(target)
        self.scale_events.append({
            "action": action, "replica": int(target),
            "occupancy_mean": round(mean, 4),
            "t_s": round(self._now(), 4),
            "active": len(self.active)})

    # -- the driving loop (in-process and parent-side runs) ----------------
    def run(self, requests, *, t0: Optional[float] = None,
            poll_s: float = 0.0005) -> "list[dict]":
        """Route ``requests`` (engine ``Request`` s or
        :class:`WireRequest` s, sorted by arrival) at their arrival
        times; returns the shed rows. The caller starts/joins the
        replica handles around this (see ``serve_bench --router`` /
        ``fleet_smoke --router``); this loop only routes — replica
        scheduling runs in the replica threads/processes."""
        self._t0 = time.perf_counter() if t0 is None else t0
        pend = deque(sorted(requests,
                            key=lambda r: (r.arrival_s, r.id)))
        shed_rows: "list[dict]" = []
        while pend:
            now = self._now()
            routed_any = False
            while pend and pend[0].arrival_s <= now:
                req = pend.popleft()
                shed_rows.extend(self._route_one(req))
                routed_any = True
            self._scale_tick(queued=len(pend))
            if not pend:
                break
            if not routed_any:
                time.sleep(min(max(pend[0].arrival_s - self._now(),
                                   0.0), poll_s) or poll_s)
        self.duration_s = self._now()
        return shed_rows

    def close(self) -> None:
        for r in self.replicas:
            try:
                r.close()
            except Exception:
                pass

    # -- the ``router`` telemetry record -----------------------------------
    def summary(self) -> dict:
        """The schema-8 ``router`` record payload: policy, per-replica
        routed/completed/shed/redirected counts, shed attribution by
        rule, scale events, and the routed-balance figure (max/mean
        routed across replicas that ever served — 1.0 = perfectly
        balanced)."""
        with self._mu:
            per = []
            for i in range(len(self.replicas)):
                per.append({
                    "replica": i,
                    "routed": self.routed[i],
                    "completed": self.completed[i],
                    "shed": self.shed_count[i],
                    "redirected": self.redirected[i],
                    "outstanding": len(self._inflight[i]),
                    "active": i in self.active,
                    "dead": i in self.dead,
                })
            routed_nz = [p["routed"] for p in per if p["routed"]]
            total_routed = sum(self.routed)
            total_shed = len(self.shed_log)
            by_rule: dict = {}
            for row in self.shed_log:
                by_rule[row["rule"]] = by_rule.get(row["rule"], 0) + 1
            offered = total_routed + total_shed
            return {
                "policy": self.policy,
                "replicas": len(self.replicas),
                "active": len(self.active),
                "offered": offered,
                "routed": total_routed,
                "completed": sum(self.completed),
                "shed": total_shed,
                "redirected": sum(self.redirected),
                "shed_rate": round(total_shed / offered, 4)
                if offered else 0.0,
                "routed_balance": round(
                    max(routed_nz) * len(routed_nz)
                    / max(sum(routed_nz), 1), 4) if routed_nz
                else None,
                "shed_by_rule": by_rule,
                "scale_events": list(self.scale_events),
                "alerts_consumed": (self.admission.alerts_consumed
                                    if self.admission is not None
                                    else 0),
                "duration_s": round(self.duration_s, 4),
                "per_replica": per,
            }

    def log_router(self, logger) -> dict:
        """Write the :meth:`summary` as one schema-8 ``router``
        record."""
        s = self.summary()
        logger.log_router(**s)
        return s


# ---------------------------------------------------------------------------
# In-process helpers (serve_bench --router)
# ---------------------------------------------------------------------------

def merge_router_run(replicas, shed_rows, *,
                     duration_s: Optional[float] = None
                     ) -> "tuple[list, dict]":
    """Fold N finished :class:`EngineReplica` s + the router's shed
    rows into ONE ``(results, stats)`` pair ``summarize_serving`` can
    aggregate: completed results from every replica, one unfinished
    ``RequestResult`` per shed request (so offered - completed - shed
    = LOST stays checkable), engine counters summed, and the
    occupancy denominator kept per-replica-exact
    (``sum(steps_i * slots_i)``, not ``sum(steps) * sum(slots)``)."""
    from apex_tpu_torch.serve.engine import RequestResult
    results: list = []
    stats_list = []
    for rep in replicas:
        if rep.error is not None:
            raise rep.error
        if rep.results:
            results.extend(rep.results)
        if rep.stats:
            stats_list.append(rep.stats)
    for row in shed_rows:
        results.append(RequestResult(id=row["request"], prompt_len=0,
                                     arrival_s=row.get("t_s", 0.0)))
    results.sort(key=lambda r: r.id)
    merged = {
        "duration_s": duration_s if duration_s is not None
        else max((s["duration_s"] for s in stats_list), default=0.0),
        "decode_steps": sum(s["decode_steps"] for s in stats_list),
        "prefill_chunks": sum(s["prefill_chunks"]
                              for s in stats_list),
        "prefill_batches": sum(s["prefill_batches"]
                               for s in stats_list),
        "prefill_batch_sizes": [b for s in stats_list
                                for b in s["prefill_batch_sizes"]],
        "occupancy_sum": sum(s["occupancy_sum"] for s in stats_list),
        "occupancy_denom": sum(s["decode_steps"] * s["slots"]
                               for s in stats_list),
        "queue_depth": [d for s in stats_list
                        for d in s["queue_depth"]],
        "step_ms": [m for s in stats_list for m in s["step_ms"]],
        "slots": sum(s["slots"] for s in stats_list),
        "arena_bytes": sum(s.get("arena_bytes") or 0
                           for s in stats_list),
        "mode": "router",
        "fused": all(s.get("fused") for s in stats_list)
        if stats_list else None,
        # r20: fleet KV accounting sums across replicas; the paged
        # ledger rides only when EVERY replica is paged (mixed fleets
        # report the byte split but no page counts)
        "kv_reserved_bytes": sum(s.get("kv_reserved_bytes") or 0
                                 for s in stats_list) or None,
        "kv_resident_peak_bytes": sum(
            s.get("kv_resident_peak_bytes") or 0
            for s in stats_list) or None,
        "paged": all(s.get("paged") for s in stats_list)
        if stats_list else None,
    }
    if merged["paged"]:
        merged.update(
            page_size=stats_list[0].get("page_size"),
            kv_pages=sum(s.get("kv_pages") or 0 for s in stats_list),
            kv_pages_free=sum(s.get("kv_pages_free") or 0
                              for s in stats_list),
            kv_pages_free_min=sum(s.get("kv_pages_free_min") or 0
                                  for s in stats_list),
        )
        if any(s.get("prefix_lookups") is not None
               for s in stats_list):
            merged.update(
                prefix_hits=sum(s.get("prefix_hits") or 0
                                for s in stats_list),
                prefix_lookups=sum(s.get("prefix_lookups") or 0
                                   for s in stats_list),
                prefix_entries=sum(s.get("prefix_entries") or 0
                                   for s in stats_list),
                prefix_evictions=sum(s.get("prefix_evictions") or 0
                                     for s in stats_list),
            )
    # r21: the fleet's speculative acceptance ledger — token totals
    # sum, the mean recomputes from them (draft_tokens/k = samples),
    # and the accepted-length histogram folds elementwise only when
    # every replica drafted the same k (mixed-k fleets keep totals)
    ks = {s.get("spec_k") for s in stats_list if s.get("spec_k")}
    if ks:
        k = max(ks)
        dt = sum(s.get("spec_draft_tokens") or 0 for s in stats_list)
        at = sum(s.get("spec_accepted_tokens") or 0
                 for s in stats_list)
        merged.update(
            spec_k=k, spec_draft_tokens=dt, spec_accepted_tokens=at,
            spec_accept_mean=(at / (dt / k) if dt else 0.0))
        hists = [s.get("spec_accept_hist") for s in stats_list
                 if s.get("spec_accept_hist")]
        if len(ks) == 1 and hists:
            merged["spec_accept_hist"] = [
                sum(h[i] for h in hists) for i in range(k + 1)]
    return results, merged


# ---------------------------------------------------------------------------
# Multiprocess transport (fleet_smoke --serve --router)
# ---------------------------------------------------------------------------

def _send_loop(sock: socket.socket, q: "queue.Queue",
               on_down: Callable, *, half_close: bool = False) -> None:
    """Shared background sender: drain the queue, own the socket's
    WRITE side. A ``None`` sentinel ends the stream after the backlog
    flushes — ``half_close`` shuts down only the write direction so
    the peer's remaining acks still arrive (the parent-side shape);
    otherwise the socket closes outright (the child's farewell)."""
    try:
        while True:
            msg = q.get()
            if msg is None:
                break
            sock.sendall((json.dumps(msg) + "\n").encode())
    except OSError:
        on_down()
        half_close = False
    finally:
        try:
            if half_close:
                sock.shutdown(socket.SHUT_WR)
            else:
                sock.close()
        except OSError:
            pass


class SocketReplica:
    """Parent-side handle for one remote engine replica. ``submit``
    enqueues the request onto a background sender thread (the routing
    loop never touches the socket); a reader thread turns ``done``
    acks into ``router.on_complete`` calls and a dropped connection
    into ``router.on_replica_down`` + immediate re-enqueue of the
    uncommitted requests."""

    def __init__(self, index: int, conn: socket.socket, router):
        self.index = int(index)
        self.router = router
        self._conn = conn
        self._q: "queue.Queue" = queue.Queue()
        self._down = False
        self._eof_seen = False
        self._sender = threading.Thread(
            target=_send_loop, args=(conn, self._q, self._lost),
            kwargs={"half_close": True},
            name=f"apex-router-send-{index}", daemon=True)
        self._sender.start()
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"apex-router-read-{index}", daemon=True)
        self._reader.start()

    def submit(self, req) -> None:
        # r22: the trace context rides the frame — the replica-side
        # engine spans carry the router's trace id across the process
        # boundary (absent fields keep old peers readable)
        self._q.put_nowait({"k": "req", "id": int(req.id),
                            "prompt": list(map(int, req.prompt)),
                            "max_new": int(req.max_new),
                            "session": _session_key(req),
                            "trace": getattr(req, "trace", None),
                            "hop": int(getattr(req, "hop", 0) or 0)})

    def close(self) -> None:
        self._q.put_nowait({"k": "eof"})
        self._q.put_nowait(None)

    def join(self, timeout: Optional[float] = None) -> None:
        self._reader.join(timeout)

    def _lost(self) -> None:
        if self._down:
            return
        self._down = True
        orphans = self.router.on_replica_down(self.index)
        if orphans:
            self.router.reroute(orphans, self.index)

    def _read_loop(self) -> None:
        buf = b""
        try:
            while True:
                chunk = self._conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    try:
                        msg = json.loads(line)
                    except ValueError:
                        continue
                    if msg.get("k") == "done":
                        self.router.on_complete(self.index,
                                                int(msg["id"]))
                    elif msg.get("k") == "bye":
                        self._eof_seen = True
        except OSError:
            pass
        finally:
            # EOF before the replica's bye = it died mid-stream:
            # re-enqueue whatever it never committed
            if not self._eof_seen:
                self._lost()


class RouterServer:
    """The parent-side rendezvous: listen, accept ``world`` replica
    ``hello`` s, wrap each connection in a :class:`SocketReplica`.
    Same endpoint convention as the live plane
    (``tcp:HOST:PORT``)."""

    def __init__(self, world: int, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.world = int(world)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, int(port)))
        srv.listen(world)
        srv.settimeout(0.2)
        self._srv = srv
        self.endpoint = f"tcp:{host}:{srv.getsockname()[1]}"
        self._conns: "dict[int, socket.socket]" = {}

    def wait_ready(self, timeout: float = 60.0) -> "dict[int, socket.socket]":
        """Accept until every rank said hello (or raise)."""
        deadline = time.monotonic() + timeout
        while len(self._conns) < self.world:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"router: only {len(self._conns)}/{self.world} "
                    f"replicas connected within {timeout}s")
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            conn.settimeout(10.0)
            buf = b""
            while b"\n" not in buf:
                chunk = conn.recv(4096)
                if not chunk:
                    break
                buf += chunk
            try:
                hello = json.loads(buf.split(b"\n", 1)[0])
                rank = int(hello["p"])
            except (ValueError, KeyError):
                conn.close()
                continue
            conn.settimeout(None)
            self._conns[rank] = conn
        return dict(self._conns)

    def make_replicas(self, router_factory) -> "tuple[Router, list]":
        """Build the Router over SocketReplicas (two-phase because the
        replicas need the router for completion callbacks):
        ``router_factory(placeholders)`` -> Router, whose handle list
        is then filled in place."""
        order = sorted(self._conns)
        router = router_factory([None] * len(order))
        for pos, rank in enumerate(order):
            router.replicas[pos] = SocketReplica(
                pos, self._conns[rank], router)
        return router, router.replicas

    def close(self) -> None:
        try:
            self._srv.close()
        except OSError:
            pass


class ReplicaClient:
    """Child-side transport: connect to the parent router, turn
    ``req`` lines into engine ``Request`` s on a :class:`RouterFeed`,
    and ack each retirement with a ``done`` line through a background
    sender (``ack`` is one unbounded ``put_nowait`` — the engine's
    timed scheduler loop calls it via ``on_retire`` and must never
    block on the parent)."""

    def __init__(self, endpoint: str, rank: int):
        from apex_tpu_torch.prof.live import parse_endpoint
        kind, addr = parse_endpoint(endpoint)
        if kind == "unix":
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(10.0)
        sock.connect(addr)
        sock.settimeout(None)
        self._sock = sock
        self.rank = int(rank)
        self.feed = RouterFeed()
        self.t0 = time.perf_counter()
        self.received = 0
        self._q: "queue.Queue" = queue.Queue()
        self._q.put_nowait({"k": "hello", "p": self.rank})
        self._sender = threading.Thread(
            target=_send_loop, args=(sock, self._q, lambda: None),
            name="apex-replica-send", daemon=True)
        self._sender.start()
        self._reader = threading.Thread(
            target=self._read_loop, name="apex-replica-read",
            daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        import numpy as np
        from apex_tpu_torch.serve.engine import Request
        buf = b""
        try:
            while True:
                chunk = self._sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    try:
                        msg = json.loads(line)
                    except ValueError:
                        continue
                    if msg.get("k") == "req":
                        self.received += 1
                        self.feed.push(Request(
                            id=int(msg["id"]),
                            prompt=np.asarray(msg["prompt"],
                                              np.int32),
                            max_new=int(msg["max_new"]),
                            arrival_s=time.perf_counter() - self.t0,
                            session=msg.get("session"),
                            trace=msg.get("trace"),
                            hop=int(msg.get("hop", 0) or 0)))
                    elif msg.get("k") == "eof":
                        self.feed.close()
                        return
        except OSError:
            pass
        finally:
            # a dead parent must not wedge the engine loop forever
            try:
                self.feed.close()
            except Exception:
                pass

    def ack(self, result) -> None:
        """The ``on_retire`` hook: non-blocking completion report."""
        self._q.put_nowait({
            "k": "done", "id": int(result.id),
            "tokens": len(result.tokens),
            "ttft_ms": round((result.ttft_s or 0.0) * 1e3, 3)})

    def close(self) -> None:
        self._q.put_nowait({"k": "bye", "p": self.rank})
        self._q.put_nowait(None)
        self._sender.join(5.0)
