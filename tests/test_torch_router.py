"""Port parity: the router tier (``apex_tpu_torch/serve/router.py``), the
engine's feed and observation hooks, ``prof.slo`` and ``prof.spans``.

The routing logic is held against the JAX router's decision for decision:
the same ``synthetic_requests`` stream through both packages' ``Router`` s
over recording fake replicas, under each policy, an admission window (shed
and redirect), the autoscaler and a failover, must give the same
assignments, shed rows, scale events and ``summary()`` (times aside).
Engine-backed runs use the tiny model of tests/test_router.py (vocab 50,
32 wide, 4 heads, 2 layers, f32) with the JAX weights converted: one
replica's greedy streams equal the plain engine's, two replicas' equal the
JAX router's run of the same requests, the committed-prefix replay
stitches a stream equal to an uninterrupted one, and the socket transport
(``RouterServer`` and two ``ReplicaClient`` s on CPU engines) completes
every request, also when one client's socket closes before its ``bye``.
Also here: the feed contract, the merged shed arm's ``summarize_serving``
against JAX's, ``SLOMonitor`` against JAX's, spans against
``summarize_serving`` and against the JAX engine's spans, the locked launch
accounting and kernel load, and that the router and ``prof`` modules load
no torch. The whole file takes seconds.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path

import jax
import numpy as np
import pytest

from apex_tpu.models import TransformerLM as JLM
from apex_tpu.prof import metrics as jmetrics
from apex_tpu.prof import slo as jslo
from apex_tpu.prof.spans import SpanTracer as JTracer
from apex_tpu.serve import ContinuousBatchingEngine as JEngine
from apex_tpu.serve import Request as JRequest
from apex_tpu.serve import RequestResult as JResult
from apex_tpu.serve import router as jrouter
from apex_tpu.serve import summarize_serving as j_summarize
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM
from apex_tpu_torch.prof import metrics as tmetrics
from apex_tpu_torch.prof import slo as tslo
from apex_tpu_torch.prof.spans import SpanTracer
from apex_tpu_torch.serve import (AdmissionController,
                                  ContinuousBatchingEngine, EngineReplica,
                                  OccupancyScaler, Request, RequestResult,
                                  Router,
                                  merge_router_run, poisson_requests,
                                  request_phases_from_spans,
                                  serving_percentiles_from_spans,
                                  summarize_serving, tail_attribution)
from apex_tpu_torch.serve import programs
from apex_tpu_torch.serve import router as trouter

ROOT = Path(__file__).resolve().parents[1]
V = 50
ENGINE = dict(slots=3, max_len=32, prefill_chunk=4)
PKGS = {"jax": jrouter, "torch": trouter}
RESULTS = {"jax": JResult, "torch": RequestResult}


class Recorder:
    """A replica handle that records what it is sent."""

    def __init__(self, index, occ=None):
        self.index = index
        self.submitted = []
        self.occ = occ

    def submit(self, req):
        self.submitted.append(req)

    def close(self):
        pass

    def occupancy(self):
        return self.occ


def _wire(pkg, n=24, **kw):
    return PKGS[pkg].synthetic_requests(n, rate=0.0, vocab_size=V, seed=3,
                                        **kw)


def _untimed(summary):
    """A router summary without its clock readings."""
    out = {k: v for k, v in summary.items() if k != "duration_s"}
    out["scale_events"] = [{k: v for k, v in e.items() if k != "t_s"}
                           for e in summary["scale_events"]]
    return out


def _route_all(pkg, policy, reqs, *, n=3, churn=3, **kw):
    """Route ``reqs`` one by one over ``n`` recorders, completing every
    outstanding request of replica ``i % n`` after each ``churn``-th one.
    Returns (the replica of each request, the summary, the router)."""
    mod = PKGS[pkg]
    reps = [Recorder(i) for i in range(n)]
    router = mod.Router(reps, policy=policy, seed=7, **kw)
    where, rows = [], []
    for i, req in enumerate(reqs):
        rows.extend(router._route_one(req))
        where.append(next((r.index for r in reps if r.submitted
                           and r.submitted[-1] is req), None))
        if i % churn == churn - 1:
            rep = reps[i % n]
            for q in rep.submitted:
                if int(q.id) in router._inflight[rep.index]:
                    router.on_complete(rep.index, q.id)
    return where, rows, router


def _prefixed(pkg, n=24):
    """Requests whose prompts start with one of three 4-token prefixes
    (so prefix-affinity pins) or are shorter than a page (fallback)."""
    heads = ([1, 2, 3, 4], [5, 6, 7, 8], [9, 9, 9, 9])
    out = []
    for r in _wire(pkg, n):
        if r.id % 5 == 4:
            prompt = r.prompt[:2]
        else:
            prompt = heads[r.id % 3] + r.prompt
        out.append(dataclasses.replace(r, prompt=prompt))
    return out


def test_synthetic_requests_are_the_jax_requests():
    a = _wire("torch", 16, sessions=4)
    b = _wire("jax", 16, sessions=4)
    assert [dataclasses.astuple(x) for x in a] == \
        [dataclasses.astuple(y) for y in b]
    c = trouter.synthetic_requests(8, rate=20.0, seed=1)
    d = jrouter.synthetic_requests(8, rate=20.0, seed=1)
    assert [x.arrival_s for x in c] == [y.arrival_s for y in d]


@pytest.mark.parametrize("policy", trouter.POLICIES)
def test_policies_route_as_the_jax_router(policy):
    make = _prefixed if policy == "prefix-affinity" else (
        lambda pkg: _wire(pkg, sessions=5))
    kw = {"prefix_page": 4} if policy == "prefix-affinity" else {}
    got = _route_all("torch", policy, make("torch"), **kw)
    want = _route_all("jax", policy, make("jax"), **kw)
    assert got[0] == want[0] and None not in got[0]
    assert _untimed(got[2].summary()) == _untimed(want[2].summary())
    assert len(set(got[0])) == 3


def test_router_validation_is_the_jax_routers():
    with pytest.raises(ValueError, match="policy"):
        Router([Recorder(0)], policy="round-robin")
    with pytest.raises(ValueError, match="replica"):
        Router([])
    with pytest.raises(ValueError, match="prefix_page"):
        Router([Recorder(0)], prefix_page=0)
    with pytest.raises(ValueError, match="low < high"):
        OccupancyScaler(low=0.9, high=0.3)


@pytest.mark.parametrize("shed", [True, False])
def test_admission_window_as_the_jax_router(shed):
    runs = []
    for pkg, mod in PKGS.items():
        adm = mod.AdmissionController(shed=shed, window_s=60.0)
        reqs = _wire(pkg, 12)
        where, rows, router = _route_all(pkg, "least-queue", reqs[:4],
                                         admission=adm)
        adm.trip("ttft_p95_ms", replica=1)
        w2, rows2 = [], []
        for req in reqs[4:]:
            rows2.extend(router._route_one(req))
            w2.append(next((r.index for r in router.replicas
                            if r.submitted and r.submitted[-1] is req),
                           None))
        runs.append((where + w2, [{k: v for k, v in r.items() if k != "t_s"}
                                  for r in rows + rows2],
                     _untimed(router.summary())))
    assert runs[0] == runs[1]
    where, rows, summary = runs[0]
    if shed:
        assert len(rows) == 8 and summary["shed_by_rule"] == \
            {"ttft_p95_ms": 8} and all(r["replica"] == 1 for r in rows)
    else:
        assert rows == [] and 1 not in where[4:]
    assert summary["alerts_consumed"] == 1


def test_scaler_as_the_jax_router():
    occ = [0.95, 0.95, 0.9, 0.01, 0.01, 0.5, 0.99, 0.99]
    runs = []
    for pkg, mod in PKGS.items():
        reps = [Recorder(i, occ=occ[0]) for i in range(3)]
        sc = mod.OccupancyScaler(low=0.1, high=0.8, cooldown_s=0.0)
        router = mod.Router(reps, scaler=sc, initial_active=1)
        router._t0 = time.perf_counter()
        actives = []
        for i, o in enumerate(occ):
            for r in reps:
                r.occ = o
            router._scale_tick(queued=2 if o > 0.5 else 0)
            actives.append(sorted(router.active))
            router._route_one(_wire(pkg, 8)[i])
        events = [{k: v for k, v in e.items() if k != "t_s"}
                  for e in router.scale_events]
        runs.append((actives, events, _untimed(router.summary())))
    assert runs[0] == runs[1]
    actions = [e["action"] for e in runs[0][1]]
    assert "up" in actions and "down" in actions
    decide = [mod.OccupancyScaler(low=0.2, high=0.8, cooldown_s=1.0)
              for mod in PKGS.values()]
    for args in (({0: 0.95}, 3, 3, 10.0), ({0: 0.95, 1: 0.9}, 3, 3, 10.5),
                 ({0: 0.05, 1: 0.1}, 0, 3, 12.0), ({0: 0.05}, 0, 3, 14.0),
                 ({0: None}, 1, 3, 20.0)):
        assert decide[0].decide(*args) == decide[1].decide(*args)


def test_failover_as_the_jax_router():
    runs = []
    for pkg, mod in PKGS.items():
        reqs = _wire(pkg, 6)
        reps = [Recorder(i) for i in range(3)]
        router = mod.Router(reps)
        for r in reqs:
            router._route_one(r)
        victims = [int(q.id) for q in reps[1].submitted]
        partials = {victims[0]: [7, 8],
                    victims[1]: [3] * reqs[victims[1]].max_new}
        orphans = router.on_replica_down(1, partials=partials)
        assert router.on_replica_down(1) == []
        replays = [(int(q.id), list(q.prompt), q.max_new) for q in orphans]
        rows = router.reroute(orphans, 1)
        res = [RESULTS[pkg](id=q.id, prompt_len=len(q.prompt),
                                 arrival_s=0.0, first_token_s=0.1,
                                 finish_s=0.2, tokens=[1] * q.max_new,
                                 token_times=[0.1] * q.max_new)
               for q in orphans]
        stitched = [(r.id, r.prompt_len, r.tokens, len(r.token_times))
                    for r in router.stitch_results(res)]
        runs.append((victims, replays, rows, stitched,
                     [len(r.submitted) for r in reps],
                     _untimed(router.summary())))
    assert runs[0] == runs[1]
    summary = runs[0][-1]
    assert summary["redirected"] == 1 and summary["completed"] == 1


def test_feed_contract_and_the_engines_feed(models):
    feed = trouter.RouterFeed()
    feed.push(1)
    feed.close()
    assert not feed.closed              # closed but not drained
    assert feed.poll() == [1]
    assert feed.closed
    with pytest.raises(RuntimeError, match="closed"):
        feed.push(2)
    tm, tp = models[2:]
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", **ENGINE)
    reqs = _requests(4)
    feed = trouter.RouterFeed()
    for r in reversed(reqs):
        feed.push(r)
    feed.close()
    got, stats = eng.run(feed)
    assert [r.id for r in got] == [r.id for r in reversed(reqs)]
    base, _ = eng.run(reqs)
    assert sorted((r.id, r.tokens) for r in got) == \
        sorted((r.id, r.tokens) for r in base)
    feed = trouter.RouterFeed()
    feed.push(reqs[0])
    feed.push(dataclasses.replace(reqs[1], id=reqs[0].id))
    feed.close()
    with pytest.raises(ValueError, match="duplicate request id"):
        eng.run(feed)
    feed = trouter.RouterFeed()
    feed.push(dataclasses.replace(reqs[0], max_new=0))
    feed.close()
    with pytest.raises(ValueError, match="max_new"):
        eng.run(feed)


# -- engine-backed (the tiny model of tests/test_router.py) ------------------

@pytest.fixture(scope="module")
def models():
    jm = JLM(vocab_size=V, max_seq_len=64, embed_dim=32, num_heads=4,
             num_layers=2)
    jp = jm.init(jax.random.key(0))
    tm = TLM(vocab_size=V, max_seq_len=64, embed_dim=32, num_heads=4,
             num_layers=2, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _requests(n, seed=1, rate=0.0):
    return poisson_requests(n, rate=rate, prompt_dist="uniform:3,10",
                            new_dist="uniform:2,8", vocab_size=V,
                            seed=seed, max_len=32, prefill_chunk=4)


def _drive(router, replicas, reqs):
    t0 = time.perf_counter()
    for rep in replicas:
        rep.start(t0, on_retire=lambda res, i=rep.index:
                  router.on_complete(i, res.id))
    shed = router.run(reqs, t0=t0)
    router.close()
    for rep in replicas:
        rep.join(120.0)
        assert not rep._thread.is_alive()
    return shed


def test_one_replica_equals_the_plain_engine(models):
    tm, tp = models[2:]
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", **ENGINE)
    reqs = _requests(8, seed=4)
    base, _ = eng.run(reqs)
    rep = EngineReplica(eng, 0)
    router = Router([rep], policy="least-queue")
    assert _drive(router, [rep], reqs) == []
    got = sorted(rep.results, key=lambda r: r.id)
    assert [r.tokens for r in got] == [r.tokens for r in base]
    assert router.summary()["completed"] == 8
    assert rep.stream is None and programs.fleet_running() == 0


def test_two_replicas_equal_the_jax_router_run(models):
    jm, jp, tm, tp = models
    reqs = _requests(10, seed=5, rate=200.0)
    jreqs = [JRequest(id=r.id, prompt=r.prompt, max_new=r.max_new,
                      arrival_s=r.arrival_s) for r in reqs]
    jreps = [jrouter.EngineReplica(JEngine(jm, jp, **ENGINE), i)
             for i in range(2)]
    jr = jrouter.Router(jreps, policy="least-queue")
    assert _drive(jr, jreps, jreqs) == []
    want, _ = jrouter.merge_router_run(jreps, [])
    reps = [EngineReplica(ContinuousBatchingEngine(
        tm, tp, device="cpu", **ENGINE), i) for i in range(2)]
    router = Router(reps, policy="least-queue")
    assert _drive(router, reps, reqs) == []
    got, merged = merge_router_run(reps, [], duration_s=router.duration_s)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(r.results for r in reps)
    assert router.summary()["completed"] == 10
    summary = summarize_serving(got, merged, offered_rps=200.0)
    assert summary["completed"] == 10 and summary["dropped"] == 0
    assert merged["occupancy_denom"] == sum(
        r.stats["decode_steps"] * r.stats["slots"] for r in reps)


def test_replica_error_ends_the_run_with_it(models):
    tm, tp = models[2:]
    bad = dataclasses.replace(_requests(1)[0], max_new=0)
    rep = EngineReplica(ContinuousBatchingEngine(tm, tp, device="cpu",
                                                 **ENGINE), 0)
    router = Router([rep])
    _drive(router, [rep], [bad])
    assert isinstance(rep.error, ValueError) and not rep.alive
    with pytest.raises(ValueError, match="max_new"):
        merge_router_run([rep], [])


def test_dead_replica_replays_committed_prefix(models):
    tm, tp = models[2:]
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                   prefill_chunk=4, device="cpu")
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    full, _ = eng.run([Request(id=7, prompt=prompt, max_new=6)])
    want = list(full[0].tokens)
    assert len(want) == 6
    reps = [Recorder(i) for i in range(2)]
    router = Router(reps, policy="least-queue")
    router._route_one(Request(id=7, prompt=prompt, max_new=6))
    committed = want[:3]
    (replay,) = router.on_replica_down(0, partials={7: committed})
    assert list(replay.prompt) == list(prompt) + committed
    assert replay.max_new == 3 and replay.prompt.dtype == np.int32
    assert router.reroute([replay], 0) == []
    (resub,) = reps[1].submitted
    assert resub.hop == 1
    cont, _ = eng.run([resub])
    (res,) = router.stitch_results(cont)
    assert res.id == 7 and res.prompt_len == len(prompt)
    assert list(res.tokens) == want
    assert len(res.token_times) == len(res.tokens)
    assert router.summary()["redirected"] == 1


def test_shed_arm_summary_equals_the_jax_one(models):
    jm, jp, tm, tp = models
    reqs = _requests(8, seed=5)
    out = []
    for mod, make in ((jrouter, lambda: JEngine(jm, jp, **ENGINE)),
                      (trouter, lambda: ContinuousBatchingEngine(
                          tm, tp, device="cpu", **ENGINE))):
        adm = mod.AdmissionController(shed=True, window_s=60.0)
        adm.trip("ttft_p95_ms", replica=1)
        reps = [mod.EngineReplica(make(), i) for i in range(2)]
        router = mod.Router(reps, policy="least-queue", admission=adm)
        shed = _drive(router, reps, reqs)
        results, merged = mod.merge_router_run(reps, shed, duration_s=1.0)
        summ = (j_summarize if mod is jrouter else summarize_serving)(
            results, merged, offered_rps=0.0, shed=shed)
        out.append((summ, [{k: v for k, v in r.items() if k != "t_s"}
                           for r in shed], _untimed(router.summary())))
    (js, jrows, jsum), (ts, trows, tsum) = out
    assert ts["shed"] == 8 and ts["completed"] == 0 and ts["dropped"] == 0
    assert ts["shed_by_rule"] == {"ttft_p95_ms": 8}
    assert trows == jrows and tsum == jsum
    nan = {k for k, v in ts.items() if isinstance(v, dict) and any(
        isinstance(x, float) and x != x for x in v.values())}
    assert {k: v for k, v in ts.items() if k not in nan} == \
        {k: v for k, v in js.items() if k not in nan}
    assert nan == {k for k, v in js.items() if isinstance(v, dict) and any(
        isinstance(x, float) and x != x for x in v.values())}


# -- SLOMonitor --------------------------------------------------------------

def test_slo_rules_and_alerts_equal_the_jax_monitors(monkeypatch):
    # logger-less alerts wait in each package's pending notes for the next
    # logger: keep this test's out of every other test's
    for mod in (tmetrics, jmetrics):
        monkeypatch.setattr(mod, "_PENDING_NOTES", deque(maxlen=256))
    spec = ("ttft_p95_ms<=50@8, token_lat_p99_ms<=9; skip_rate<=0.1,"
            "step_ms_max<=20@4,occupancy_min>=0.3@6,queue_depth>=1")
    assert [dataclasses.astuple(r) for r in tslo.parse_rules(spec)] == \
        [dataclasses.astuple(r) for r in jslo.parse_rules(spec)]
    for name in ("ttft_p95_ms", "skip_rate", "x_mean", "step_ms_max",
                 "plain", "occupancy_min"):
        assert tslo.resolve_rule_name(name) == jslo.resolve_rule_name(name)
    for bad in ("ttft<50", "x<=1@0", "a<=1,a<=2", ""):
        if bad:
            with pytest.raises(ValueError):
                tslo.parse_rules(bad)
            with pytest.raises(ValueError):
                jslo.parse_rules(bad)
    rng = np.random.RandomState(0)
    obs = [("ttft_ms", float(v)) for v in rng.gamma(2.0, 20.0, 64)] + \
        [("step_ms", float(v)) for v in rng.gamma(2.0, 6.0, 64)] + \
        [("occupancy", float(v)) for v in rng.rand(64)] + \
        [("token_lat_ms", float(v)) for v in rng.gamma(2.0, 4.0, 64)]
    rng.shuffle(obs)
    mons = [mod.SLOMonitor(spec, min_samples=4) for mod in (tslo, jslo)]
    seen = [[], []]
    for m, s in zip(mons, seen):
        m.on_alert(s.append)
        m.on_alert(lambda a: 1 / 0)   # a broken consumer is swallowed
    for i, (metric, v) in enumerate(obs):
        got = mons[0].observe(metric, v, context={"i": i})
        want = mons[1].observe(metric, v, context={"i": i})
        assert got == want
    assert mons[0].alerts == mons[1].alerts and mons[0].alerts
    assert seen[0] == seen[1] == mons[0].alerts
    assert mons[0].summary() == mons[1].summary()
    assert mons[0].check() == mons[1].check()
    for r in mons[0].rules:
        assert mons[0].measured(r.name) == mons[1].measured(r.name)
    # with no logger, alerts ride the port's pending-notes channel
    notes = list(tmetrics._PENDING_NOTES)
    assert [n[1] for n in notes] == ["alert"] * len(mons[0].alerts)
    assert [n[3] for n in notes] == mons[0].alerts
    mons[0].reset()
    assert mons[0].measured(mons[0].rules[0].name) is None


def test_the_engines_slo_and_live_hooks(models):
    tm, tp = models[2:]
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", **ENGINE)
    reqs = _requests(6)
    seen = []

    class Monitor:
        def observe(self, metric, value, *, context=None):
            seen.append(("slo", metric, dict(context or {})))

    class Live:
        def observe(self, metric, value, **tags):
            seen.append(("live", metric))

        def observe_many(self, **metrics):
            seen.append(("many", tuple(sorted(metrics))))

    retired = []
    res, stats = eng.run(reqs, slo=Monitor(), live=Live(),
                         on_retire=retired.append)
    count = {}
    for e in seen:
        key = e[:2] if e[0] != "many" else e
        count[key] = count.get(key, 0) + 1
    n, steps = len(reqs), stats["decode_steps"]
    assert count[("slo", "ttft_ms")] == count[("live", "ttft_ms")] == n
    assert count[("slo", "token_lat_ms")] == count[
        ("live", "token_lat_ms")] == n
    assert count[("slo", "step_ms")] == steps
    assert count[("many", ("occupancy", "queue_depth", "step_ms"))] == steps
    assert sorted(r.id for r in retired) == [r.id for r in res]
    assert all(r.finish_s is not None for r in retired)
    assert [e[2] for e in seen if e[:2] == ("slo", "step_ms")] == \
        [{"step": i} for i in range(1, steps + 1)]
    # one-token requests retire at their first token, and say so
    one = [dataclasses.replace(r, max_new=1) for r in reqs[:2]]
    retired.clear()
    eng.run(one, on_retire=retired.append)
    assert sorted(r.id for r in retired) == [r.id for r in one]


def test_idle_feed_polls_report_zero_occupancy(models):
    tm, tp = models[2:]
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", **ENGINE)
    feed = trouter.RouterFeed()
    probe = trouter.ReplicaProbe(window=8)
    t = threading.Thread(target=lambda: eng.run(feed, live=probe))
    t.start()
    deadline = time.monotonic() + 10.0
    while probe.occupancy_mean() is None and time.monotonic() < deadline:
        time.sleep(0.01)
    feed.close()
    t.join(30.0)
    assert not t.is_alive() and probe.occupancy_mean() == 0.0


# -- spans -------------------------------------------------------------------

def test_spans_give_summarize_servings_percentiles(models):
    tm, tp = models[2:]
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", **ENGINE)
    tr = SpanTracer()
    results, stats = eng.run(_requests(6, rate=100.0), tracer=tr)
    summary = summarize_serving(results, stats, offered_rps=100.0)
    sp = serving_percentiles_from_spans(tr.records())
    assert sp["requests"] == 6
    for key in ("ttft_ms", "token_lat_ms"):
        for q in ("p50", "p95", "p99", "max"):
            assert summary[key][q] == pytest.approx(sp[key][q], abs=0.01)
    phases = request_phases_from_spans(tr.records())
    for p in phases.values():
        parts = p["queue_wait"] + p["prefill"] + p["decode"] + p["retire"]
        assert parts == pytest.approx(p["total_ms"], abs=0.01)
    ta = tail_attribution(tr.records())
    assert ta["requests"] == 6 and sum(ta["shares"].values()) == \
        pytest.approx(1.0, abs=0.01)
    assert tr.open_count == 0


@pytest.mark.parametrize("fused", [True, False])
def test_spans_have_the_jax_engines_shape(models, fused):
    """The same requests at rate 0 through both engines, traced: the same
    spans by name and request, the same parent links by name, and the
    same prefill_batch and decode_step attributes."""
    jm, jp, tm, tp = models
    reqs = _requests(5)
    jt, tt = JTracer(), SpanTracer()
    JEngine(jm, jp, fused=fused, **ENGINE).run(reqs, tracer=jt)
    ContinuousBatchingEngine(tm, tp, device="cpu", fused=fused,
                             **ENGINE).run(reqs, tracer=tt)

    def shape(tracer):
        spans = tracer.spans()
        by = {s.sid: s for s in spans}
        rows = []
        for s in spans:
            a = {k: v for k, v in s.attrs.items()}
            parent = by[s.parent].name if s.parent in by else None
            rows.append((s.name, a.get("request"), parent,
                         a.get("batch"), a.get("chunks"), a.get("step"),
                         a.get("active"), a.get("slot"), a.get("tokens"),
                         a.get("chunk")))
        return sorted(rows, key=repr)

    assert shape(tt) == shape(jt)
    names = {r[0] for r in shape(tt)}
    want = {"request", "queue", "commit", "decode", "retire", "decode_step",
            "prefill_batch" if fused else "prefill_chunk"}
    assert want <= names


def test_router_spans_and_trace_context(models):
    reps = [Recorder(i) for i in range(2)]
    tr = SpanTracer()
    adm = AdmissionController(shed=True, window_s=60.0)
    router = Router(reps, admission=adm, tracer=tr)
    reqs = _wire("torch", 4)
    router._route_one(reqs[0])
    orphans = router.on_replica_down(0, partials={0: [1]})
    router.reroute(orphans, 0)
    adm.trip("ttft_p95_ms", replica=1)
    router._route_one(reqs[1])
    router.stitch_results([])
    names = [s.name for s in tr.spans()]
    for name in ("route", "admission", "shed", "replay_hop",
                 "replay_stitch"):
        assert name in names
    assert all(s.attrs.get("trace") == f"t{s.attrs['request']}"
               for s in tr.spans() if "request" in s.attrs)
    assert reps[1].submitted[0].trace == "t0" and \
        reps[1].submitted[0].hop == 1


# -- the socket transport ----------------------------------------------------

class _Died(Exception):
    pass


def _client(endpoint, rank, eng, out, kill_after=None):
    client = trouter.ReplicaClient(endpoint, rank)
    done = []

    def on_retire(res):
        client.ack(res)
        done.append(res)
        if kill_after is not None and len(done) >= kill_after:
            time.sleep(0.2)            # the queued acks drain
            client._sock.shutdown(socket.SHUT_RDWR)
            client._sock.close()       # gone before its bye
            raise _Died()

    try:
        results, _ = eng.run(client.feed, t0=client.t0, on_retire=on_retire)
        client.close()
    except _Died:
        results = []
    out[rank] = {"results": results, "retired": done,
                 "received": client.received}


@pytest.mark.parametrize("kill", [False, True])
def test_router_server_with_two_clients(models, kill):
    tm, tp = models[2:]
    engines = [ContinuousBatchingEngine(tm, tp, device="cpu", **ENGINE)
               for _ in range(2)]
    wire = trouter.synthetic_requests(12, rate=0.0, vocab_size=V, seed=9,
                                      prompt_hi=9, new_lo=3, new_hi=8)
    reqs = [Request(id=w.id, prompt=np.asarray(w.prompt, np.int32),
                    max_new=w.max_new) for w in wire]
    base, _ = engines[0].run(reqs)
    want = {r.id: r.tokens for r in base}
    srv = trouter.RouterServer(2)
    out = {}
    threads = [threading.Thread(target=_client, args=(
        srv.endpoint, rank, engines[rank], out,
        2 if kill and rank == 1 else None)) for rank in (0, 1)]
    for t in threads:
        t.start()
    try:
        srv.wait_ready(30.0)
        router, reps = srv.make_replicas(lambda slots: Router(slots))
        assert router.run(wire) == []
        deadline = time.monotonic() + 60.0
        while True:
            s = router.summary()
            if s["completed"] + s["shed"] >= s["offered"] - s["redirected"]:
                break
            assert time.monotonic() < deadline, s
            time.sleep(0.01)
        router.close()
        for rep in reps:
            rep.join(30.0)
        for t in threads:
            t.join(60.0)
            assert not t.is_alive()
    finally:
        srv.close()
    s = router.summary()
    assert s["completed"] == len(wire) and s["shed"] == 0
    assert s["completed"] == s["offered"] - s["redirected"]
    streams = {}
    for rank in (0, 1):
        for r in out[rank]["results"] or out[rank]["retired"]:
            streams[r.id] = r.tokens
    assert streams == want
    if kill:
        assert s["redirected"] >= 1 and s["per_replica"][1]["dead"]
        assert len(out[1]["retired"]) == 2
    else:
        assert out[0]["received"] + out[1]["received"] == len(wire)


# -- the locks, and what loads torch -----------------------------------------

def test_launch_accounting_is_exact_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    counts = [(wrapper, 3)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            programs.add_launches(counts) for _ in range(20000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert wrapper.launches == 8 * 20000 * 3


def test_the_kernel_library_loads_once_under_threads(monkeypatch):
    from apex_tpu_torch.ops import cuda as kcuda
    calls = []

    def build():
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return "lib.so"

    class FakeCDLL:
        def __init__(self, path):
            self.path = path

    monkeypatch.setattr(kcuda, "_lib", None)
    monkeypatch.setattr(kcuda, "build", build)
    monkeypatch.setattr(kcuda, "_declare", lambda so: None)
    monkeypatch.setattr(kcuda.ctypes, "CDLL", FakeCDLL)
    got = []
    threads = [threading.Thread(target=lambda: got.append(kcuda.lib()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert len(calls) == 1 and len(got) == 8
    assert all(x is got[0] for x in got)


def test_a_cpu_fleet_is_counted_while_it_runs(models):
    tm, tp = models[2:]
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", **ENGINE)
    rep = EngineReplica(eng, 0)
    rep.start(time.perf_counter(), on_retire=lambda res: None)
    try:
        assert programs.fleet_running() == 1
    finally:
        rep.close()
        rep.join(30.0)
    assert programs.fleet_running() == 0 and rep.results == []


def test_router_and_prof_modules_load_no_torch():
    code = ("import sys\n"
            "import apex_tpu_torch.serve.router as r, "
            "apex_tpu_torch.prof.slo, apex_tpu_torch.prof.live, "
            "apex_tpu_torch.prof.spans, apex_tpu_torch.serve.prefix\n"
            "from apex_tpu_torch.serve import Router, RouterFeed, "
            "AdmissionController, OccupancyScaler\n"
            "from apex_tpu_torch.prof import SpanTracer, SLOMonitor, "
            "LiveCollector\n"
            "reqs = r.synthetic_requests(4, rate=0.0)\n"
            "print(','.join(sorted(m for m in sys.modules if m in "
            "('torch', 'numpy', 'jax') or m.startswith('apex_tpu.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
