"""Port parity: the live fleet plane (``apex_tpu_torch/prof/live.py``).

The contracts of tests/test_live.py, held on the port's copy: emitting is
non-blocking (a full queue or a dead collector costs a counted drop, never
a stall); fleet-scope rules catch what every per-process monitor misses
(one replica's occupancy collapse behind healthy latencies), and the
occupancy-collapse alert trips an attached ``AdmissionController`` into
shedding with the culprit named; the Prometheus ``/metrics`` text and the
snapshot. The port has no ``MetricsLogger`` yet (ROADMAP.md Queue 1,
slice 8): where a logger is needed these tests pass the JAX package's,
which the port's plane drives through the same methods, and
``tools/telemetry_report.py`` renders what it wrote. The wire is shared:
the port's emitters feed the JAX collector and the JAX emitters the
port's, with equal expositions. Sockets and synthetic samples only; the
whole file takes seconds.
"""

import json
import os
import sys
import time
import urllib.request

import pytest

from apex_tpu.prof import live as jlive
from apex_tpu.prof import metrics as M
from apex_tpu_torch.prof import live as tlive
from apex_tpu_torch.prof.live import (LiveCollector, LiveEmitter,
                                      parse_endpoint, prometheus_name)
from apex_tpu_torch.prof.slo import SLOMonitor
from apex_tpu_torch.serve.router import (AdmissionController, ReplicaProbe,
                                         Router)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def wait_for(cond, timeout=10.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError("condition not met within timeout")


def _logger(tmp_path, name="live.jsonl", run="collector"):
    return M.MetricsLogger(str(tmp_path / name), run=run,
                           track_compiles=False, process_index=0,
                           process_count=1)


@pytest.fixture()
def collector():
    col = LiveCollector(http_port=None).start()
    yield col
    col.close()


def test_endpoints_parse_as_the_jax_plane():
    for spec in ("tcp:127.0.0.1:9444", "127.0.0.1:9444", "unix:/tmp/x.sock",
                 "tcp:host.example:80"):
        assert parse_endpoint(spec) == jlive.parse_endpoint(spec)
    for bad in ("nonsense", "tcp:host:port"):
        with pytest.raises(ValueError):
            parse_endpoint(bad)
    assert tlive.MERGED_METRICS == jlive.MERGED_METRICS
    assert tlive.DERIVED_METRICS == jlive.DERIVED_METRICS
    assert prometheus_name("ttft_ms") == "apex_live_ttft_ms"


def test_unix_socket_transport(tmp_path):
    col = LiveCollector(address=str(tmp_path / "live.sock"),
                        http_port=None).start()
    assert col.endpoint.startswith("unix:")
    em = LiveEmitter(col.endpoint, process_index=3)
    em.observe("step_ms", 1.5)
    wait_for(lambda: col.snapshot()["replicas"])
    assert col.snapshot()["replicas"][0]["process"] == 3
    assert em.close()["drops"] == 0
    col.close()
    assert not os.path.exists(tmp_path / "live.sock")


def test_occupancy_collapse_trips_the_fleet_rule_and_admission(tmp_path):
    """The acceptance scenario of tests/test_live.py:76 on the port:
    replica 1 starves (its few requests are fast, so per-process monitors
    stay silent), the fleet-scope occupancy_min rule trips naming it, and
    an AdmissionController attached to the collector sheds the next
    arrivals with the rule and replica attributed."""
    log = _logger(tmp_path)
    col = LiveCollector(rules="occupancy_min>=0.2@4", logger=log,
                        min_samples=4).start()
    adm = AdmissionController(shed=True, window_s=60.0).attach(col)
    mons = [SLOMonitor("ttft_p95_ms<=100,token_lat_p95_ms<=50",
                       min_samples=4) for _ in range(2)]
    ems = [LiveEmitter(col.endpoint, process_index=i, process_count=2)
           for i in range(2)]
    for _ in range(32):
        for mon, em, occ, ttft in ((mons[0], ems[0], 0.7, 40.0),
                                   (mons[1], ems[1], 0.0, 8.0)):
            mon.observe("ttft_ms", ttft)
            mon.observe("token_lat_ms", ttft / 4)
            em.observe("occupancy", occ)
            em.observe("ttft_ms", ttft)
    alert = wait_for(lambda: col.alerts and col.alerts[0])
    assert alert["rule"] == "occupancy_min" and alert["scope"] == "fleet"
    assert alert["process"] == 1 and alert["measured"] < 0.2
    assert mons[0].alerts == [] and mons[1].alerts == []
    assert adm.decide() == ("shed", "occupancy_min", 1)
    router = Router([_Recorder(0), _Recorder(1)], admission=adm)
    rows = router._route_one(_Req(0))
    assert rows[0]["rule"] == "occupancy_min" and rows[0]["replica"] == 1
    assert router.summary()["alerts_consumed"] >= 1
    assert all(em.close()["drops"] == 0 for em in ems)
    col.close()
    log.close()
    recs = M.read_sidecar(str(tmp_path / "live.jsonl"))
    (arec,) = [r for r in recs if r["kind"] == "alert"
               and r.get("scope") == "fleet"]
    assert arec["rule"] == "occupancy_min" and arec["process"] == 1


class _Recorder:
    def __init__(self, index):
        self.index = index
        self.submitted = []

    def submit(self, req):
        self.submitted.append(req)

    def close(self):
        pass


class _Req:
    def __init__(self, i):
        self.id = i
        self.prompt = [1, 2, 3]
        self.max_new = 2
        self.arrival_s = 0.0


@pytest.mark.parametrize("rule,feed,culprit", [
    ("ttft_p95_ms<=50@64", [(0, "ttft_ms", 10.0), (1, "ttft_ms", 80.0)],
     None),
    ("queue_depth_max<=6@4", [(0, "queue_depth", 30.0)], None),
    ("step_skew_frac<=0.5@4", [(0, "step_ms", 1.0), (1, "step_ms", 10.0)],
     1)])
def test_fleet_rules_trip_as_the_jax_collectors(rule, feed, culprit):
    """Each fleet rule fed the same samples in the port's collector and
    the JAX one: both alert, on the same rule and culprit."""
    got = []
    for mod in (tlive, jlive):
        col = mod.LiveCollector(rules=rule, min_samples=2,
                                http_port=None).start()
        ems = {p: mod.LiveEmitter(col.endpoint, process_index=p)
               for p, _, _ in feed}
        for _ in range(40):
            for p, metric, v in feed:
                ems[p].observe(metric, v)
        alert = wait_for(lambda: col.alerts and col.alerts[0])
        got.append((alert["rule"], alert["scope"], alert.get("process")))
        for em in ems.values():
            em.close()
        col.close()
    assert got[0] == got[1]
    assert got[0][:2] == (rule.split("<=")[0], "fleet")
    if culprit is not None:
        assert got[0][2] == culprit


def test_steady_state_zero_drops_with_record(tmp_path, collector):
    log = _logger(tmp_path, "t.jsonl", "x")
    em = LiveEmitter(collector.endpoint, run="x").attach(log)
    for _ in range(200):
        em.observe("step_ms", 1.0)
    s = em.close()
    assert s["drops"] == 0 and s["sent"] >= 200
    log.close()
    (ld,) = [r for r in M.read_sidecar(str(tmp_path / "t.jsonl"))
             if r["kind"] == "live_drop"]
    assert ld["drops"] == 0 and ld["sent"] >= 200


def test_throttled_sender_drops_counted_everywhere(tmp_path, collector):
    log = _logger(tmp_path, "t.jsonl", "x")
    em = LiveEmitter(collector.endpoint, queue_size=8, throttle_ms=20,
                     run="x").attach(log)
    for _ in range(300):
        em.observe("step_ms", 1.0)
    s = em.close(timeout=15)
    assert s["drops"] > 0
    log.close()
    (ld,) = [r for r in M.read_sidecar(str(tmp_path / "t.jsonl"))
             if r["kind"] == "live_drop"]
    assert ld["drops"] == s["drops"]
    wait_for(lambda: collector.snapshot()["replicas"][0]["closed"])
    assert collector.snapshot()["replicas"][0]["drops"] == s["drops"]


def test_dead_collector_never_blocks_the_producer():
    em = LiveEmitter("tcp:127.0.0.1:1", queue_size=16)
    t0 = time.perf_counter()
    for _ in range(1000):
        em.observe("step_ms", 1.0)
    assert time.perf_counter() - t0 < 0.5
    assert em.close(timeout=5)["drops"] > 0


def test_logger_tee_streams_step_records(collector, tmp_path):
    log = _logger(tmp_path, "t.jsonl", "x")
    em = LiveEmitter(collector.endpoint).attach(log)
    for i in range(10):
        log.log_step(i, step_ms=2.0, queue_depth=3)
    wait_for(lambda: collector.snapshot()["replicas"]
             and collector.snapshot()["replicas"][0]["samples"] >= 20)
    row = collector.snapshot()["replicas"][0]
    assert row["step_p50_ms"] == 2.0 and row["queue_depth"] == 3
    em.close()
    log.close()


def _feed(col, emitter_mod):
    ems = [emitter_mod.LiveEmitter(col.endpoint, process_index=i,
                                   run="serve") for i in range(2)]
    for _ in range(24):
        for em, occ, ttft, step in ((ems[0], 0.6, 12.0, 0.8),
                                    (ems[1], 0.1, 6.0, 0.9)):
            em.observe_many(occupancy=occ, step_ms=step)
            em.observe("ttft_ms", ttft)
    wait_for(lambda: len(col.snapshot()["replicas"]) == 2 and all(
        r["samples"] >= 72 for r in col.snapshot()["replicas"]))
    for em in ems:
        em.close()
    wait_for(lambda: all(r["closed"] for r in col.snapshot()["replicas"]))


def test_exposition_and_wire_equal_the_jax_planes():
    """The port's emitters into the JAX collector and the JAX emitters
    into the port's: the same samples give the same /metrics text, and
    the port's HTTP endpoint serves it with the snapshot."""
    texts = []
    for col_mod, em_mod in ((tlive, jlive), (jlive, tlive)):
        col = col_mod.LiveCollector(min_samples=4).start()
        _feed(col, em_mod)
        texts.append(col.prometheus())
        if col_mod is tlive:
            scraped = urllib.request.urlopen(col.metrics_url,
                                             timeout=5).read().decode()
            snap = json.loads(urllib.request.urlopen(
                col.metrics_url.replace("/metrics", "/snapshot"),
                timeout=5).read().decode())
            assert scraped == texts[-1]
            assert len(snap["replicas"]) == 2
            assert snap["fleet"]["occupancy"]["min"] == 0.1
        col.close()
    assert texts[0] == texts[1]
    assert f'{prometheus_name("occupancy")}{{process="0"}} 0.6' in texts[0]
    assert f'{prometheus_name("ttft_ms")}{{quantile="0.95"}}' in texts[0]


def test_collector_flush_renders_the_live_table(tmp_path):
    sys.path.insert(0, TOOLS)
    try:
        import telemetry_report as TR
    finally:
        sys.path.remove(TOOLS)
    path = str(tmp_path / "live.jsonl")
    log = M.MetricsLogger(path, run="collector", track_compiles=False,
                          process_index=0, process_count=1)
    col = LiveCollector(rules="occupancy_min>=0.2@4", logger=log,
                        min_samples=4).start()
    _feed(col, tlive)
    wait_for(lambda: col.alerts)
    col.close()
    log.close()
    recs = M.read_sidecar(path)
    assert {"live_drop", "alert"} <= {r["kind"] for r in recs}
    s = TR.summarize(recs)
    assert len(s["live"]["replicas"]) == 2
    assert s["live"]["fleet"]["alerts"] == 1
    out = TR.render(s)
    assert "LIVE plane" in out and "| p0 |" in out


def test_replica_probe_keeps_occupancy_and_forwards(collector):
    em = LiveEmitter(collector.endpoint, process_index=5)
    probe = ReplicaProbe(window=4, forward=em)
    assert probe.occupancy_mean() is None
    for occ in (1.0, 0.5, 0.0, 0.5, 0.25):
        probe.observe_many(occupancy=occ, step_ms=1.0)
    probe.observe("ttft_ms", 3.0)
    probe.observe("occupancy", 0.25)
    assert probe.occupancy_mean() == pytest.approx(0.25)
    wait_for(lambda: collector.snapshot()["replicas"]
             and collector.snapshot()["replicas"][0]["samples"] >= 12)
    row = collector.snapshot()["replicas"][0]
    assert row["process"] == 5 and row["ttft_p95_ms"] == 3.0
    em.close()
