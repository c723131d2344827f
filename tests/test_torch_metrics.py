"""Port parity: the telemetry sidecar (``apex_tpu_torch/prof/metrics.py``)
against the JAX package's ``MetricsLogger``.

The same calls go to both loggers, fed from one numpy seed — the JAX one
gets jax arrays, the port's torch tensors: steps with device scalars and
an interval, ``log_amp`` from each package's ``ScalerState`` after the
same updates, ``log_overflow`` and ``log_numerics`` from each package's
census of the same gradients, a recompile, state bytes, spans, an alert,
the router's record (each package's ``Router`` over the same requests), a
pending note and ``close``. Both sidecars must hold the same record kinds
in the same order, the same keys per record and equal values, apart from
``t``, ``pid``, the spans' clock readings and what each package counts of
its own machine: the header's ``backend``/``devices`` and the memory
record's ``devices`` (the port writes them only once CUDA is
initialized), the per-device memory samples (one a device of each
package's machine), the JAX logger's collective tally (whatever the
process traced before; the port's tally, per step, is empty here) and the
compile counts (XLA's compiles against the port's CUDA-graph captures
and nvcc builds). The global gradient norm is a
float32 sum whose order differs, so it is held to float32's rounding.
Every port record passes the JAX ``validate_record``, and
``tools/telemetry_report.py``, unedited, renders the port's sidecar.

Also: a tensor changed in place after ``log_step`` flushes the value it
had when logged (the logger keeps its own copy), the schema helpers equal
the JAX ones, compile events reach the ``compile`` record, and a logger
shared by threads keeps every record. Host-side only; seconds.
"""

import json
import os
import subprocess
import sys
import threading
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.prof import metrics as JM
from apex_tpu.prof import numerics as JNU
from apex_tpu.prof.spans import SpanTracer as JTracer
from apex_tpu.serve import router as jrouter
from apex_tpu_torch import amp as tamp
from apex_tpu_torch.prof import metrics as M
from apex_tpu_torch.prof import numerics as NU
from apex_tpu_torch.prof.spans import SpanTracer
from apex_tpu_torch.serve import router as trouter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")

# what each package counts of its own machine, or reads off a clock
MACHINE_KEYS = {"header": {"backend", "devices", "pid"},
                "memory": {"devices"}}
CLOCK_KEYS = {"t"}
SPAN_CLOCK_KEYS = {"t", "t0_s", "dur_ms"}


@pytest.fixture(autouse=True)
def _own_pending_notes(monkeypatch):
    """Each test's loggers drain only the notes it made."""
    monkeypatch.setattr(M, "_PENDING_NOTES", deque(maxlen=256))
    monkeypatch.setattr(JM, "_PENDING_NOTES", deque(maxlen=256))


class Recorder:
    def __init__(self, index):
        self.index = index
        self.submitted = []

    def submit(self, req):
        self.submitted.append(req)

    def close(self):
        pass

    def occupancy(self):
        return None


def _grads(rs, faults=True):
    g = {"dense": {"w": rs.randn(6, 4).astype(np.float32),
                   "b": rs.randn(4).astype(np.float32)},
         "head": {"w": (rs.randn(3, 5) * 1e-6).astype(np.float32)}}
    g["head"]["w"][2, 1] = 0.0
    if faults:
        g["dense"]["w"][1, 2] = np.inf
        g["head"]["w"][0, 0] = np.nan
    return g


def _drive(pkg, path):
    """The scripted run through one package's logger."""
    JM._PENDING_NOTES.clear()       # notes other tests left behind
    M._PENDING_NOTES.clear()
    rs = np.random.RandomState(0)
    if pkg == "jax":
        mod, arr = JM, (lambda x: jnp.asarray(x))
        tree = lambda g: jax.tree.map(jnp.asarray, g)      # noqa: E731
        nu, amp, tracer_cls = JNU, jamp, JTracer
        routers = jrouter
    else:
        mod = M
        arr = lambda x: torch.as_tensor(np.asarray(x))      # noqa: E731
        tree = lambda g: {k: {n: torch.from_numpy(v.copy())  # noqa: E731
                              for n, v in d.items()} for k, d in g.items()}
        nu, amp, tracer_cls = NU, tamp, SpanTracer
        routers = trouter
    log = mod.MetricsLogger(path, run="parity", meta={"batch": 4},
                            flush_every=3, process_index=0,
                            process_count=1)
    # steps with device scalars, one an interval
    for i in range(5):
        log.log_step(i, step_ms=1.25 * (i + 1), throughput=100.0 + i,
                     unit="img/s", loss=arr(np.float32(rs.randn())),
                     loss_scale=arr(np.float32(2.0 ** (10 + i))),
                     input_wait_ms=0.5, active=arr(np.int32(i)))
    log.log_step(10, steps=5, step_ms=2.0, loss=arr(np.float32(0.5)),
                 loss_g=arr(np.float32(0.25)))
    log.event("phase", what="warm", n=3)
    # a scaler after three updates, one of them an overflow
    kw = {} if pkg == "jax" else {"device": "cpu"}
    _, handle = amp.initialize(opt_level="O2", num_losses=2, verbosity=0,
                               **({"half_dtype": jnp.float16}
                                  if pkg == "jax" else
                                  {"half_dtype": torch.float16}))
    st = handle.init_state(**kw)
    for flag in (False, True, False):
        st = handle.update(st, arr(np.bool_(flag)), loss_id=1)
    for i in range(2):
        log.log_amp(handle.scalers[i], st[i], loss_id=i)
    # the overflow and underflow censuses of the same gradients
    g = _grads(rs)
    meta = nu.tree_meta(tree(g))
    census = nu.grad_census(tree(g), step=7)
    log.log_overflow(meta, census, loss_id=1, loss_scale=st[1].scale)
    log.log_numerics(meta, nu.underflow_census(tree(_grads(rs, False))),
                     step=7, loss_id=2)
    # a recompile: the second shape of a wrapped step
    if pkg == "jax":
        f = log.track_recompiles(jax.jit(lambda x, y: x * 2), "f")
    else:
        f = log.track_recompiles(lambda x, y: x * 2, "f")
    f(arr(np.ones(4, np.float32)), {"k": arr(np.zeros(2, np.int32))})
    f(arr(np.ones(4, np.float32)), {"k": arr(np.zeros(2, np.int32))})
    f(arr(np.ones((2, 2), np.float32)), {"k": arr(np.zeros(2, np.int32))})
    log.log_state_bytes(params=tree(g), label="grads")
    # spans on explicit times, an alert, the router's record
    tr = tracer_cls()
    sid = tr.begin("request", t0=0.5, request=3)
    tr.end(tr.begin("decode", t0=0.6, parent=sid), t1=0.9)
    tr.end(sid, t1=1.0)
    log.log_spans(tr)
    log.log_alert(rule="ttft_p95_ms", source="slo", measured=12.5,
                  threshold=10.0, window=8)
    reps = [Recorder(i) for i in range(2)]
    router = routers.Router(reps, policy="least-queue", seed=7)
    for req in routers.synthetic_requests(6, rate=0.0, vocab_size=50,
                                          seed=3):
        router._route_one(req)
    router.log_router(log)
    log.log_serving(mode="continuous", completed=6, dropped=0,
                    token_lat_ms={"p50": 1.0, "p95": 2.0})
    mod.note("mesh_created", devices=1)
    log.close()
    return mod.read_sidecar(path)


def _strip(rec):
    kind = rec["kind"]
    drop = CLOCK_KEYS | MACHINE_KEYS.get(kind, set())
    if kind == "span":
        drop = drop | SPAN_CLOCK_KEYS
    if kind == "router":
        drop = drop | {"duration_s"}
    if kind == "compile":
        return {}
    return {k: v for k, v in rec.items() if k not in drop}


def _devices_records(recs):
    """Without the per-device ``memory`` samples (one a device of each
    package's own machine: the JAX tests run on several CPU devices) and
    the JAX logger's ``collectives`` record (the collective tally of
    whatever this process traced before; the port's logger writes one
    only after a collective ran in the process, none here)."""
    return [r for r in recs if not (r["kind"] == "memory"
                                    and "available" in r)
            and r["kind"] != "collectives"]


@pytest.fixture(scope="module")
def sidecars(tmp_path_factory):
    d = tmp_path_factory.mktemp("telem")
    return (_drive("jax", str(d / "jax.jsonl")),
            _drive("torch", str(d / "torch.jsonl")), str(d / "torch.jsonl"))


def test_kinds_order_and_keys_equal_the_jax_loggers(sidecars):
    jrecs, trecs = map(_devices_records, sidecars[:2])
    assert [r["kind"] for r in trecs] == [r["kind"] for r in jrecs]
    for j, t in zip(jrecs, trecs):
        drop = MACHINE_KEYS.get(j["kind"], set()) - {"pid"}
        assert set(t) - drop == set(j) - drop, j["kind"]


def test_values_equal_the_jax_loggers(sidecars):
    jrecs, trecs = map(_devices_records, sidecars[:2])
    for j, t in zip(jrecs, trecs):
        js, ts = _strip(j), _strip(t)
        if j["kind"] == "numerics":
            assert ts.pop("grad_norm") == pytest.approx(
                js.pop("grad_norm"), rel=2 ** -22)
        assert ts == js, j["kind"]


def test_every_record_passes_the_jax_validator(sidecars):
    _, trecs, path = sidecars
    for r in trecs:
        JM.validate_record(r)
    assert JM.read_sidecar(path) == trecs
    amp = [r for r in trecs if r["kind"] == "amp"]
    assert amp[1]["overflow_count"] == 1 and amp[1]["step_count"] == 3
    assert isinstance(amp[1]["overflow_count"], int)


def test_telemetry_report_renders_the_ports_sidecar(sidecars):
    _, trecs, path = sidecars
    sys.path.insert(0, TOOLS)
    try:
        import telemetry_report as TR
    finally:
        sys.path.remove(TOOLS)
    s = TR.summarize(trecs)
    out = TR.render(s)
    assert "ALERTS" in out and "ROUTER" in out
    r = subprocess.run([sys.executable, os.path.join(TOOLS,
                                                     "telemetry_report.py"),
                        path], capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-1000:]
    assert "apex_tpu.telemetry/11" in r.stdout


def test_a_tensor_changed_after_logging_keeps_its_logged_value(tmp_path):
    log = M.MetricsLogger(str(tmp_path / "t.jsonl"), run="x",
                          track_compiles=False)
    x = torch.tensor(1.5)
    scale = torch.tensor(8.0)
    log.log_step(0, loss=x, loss_scale=scale, extra=[x, {"y": x}])
    x.add_(10.0)                 # an optimizer writing in place
    scale.mul_(2.0)
    log.log_step(1, loss=x, loss_scale=scale)
    log.close()
    steps = [r for r in M.read_sidecar(log.path) if r["kind"] == "step"]
    assert steps[0]["loss"] == 1.5 and steps[0]["loss_scale"] == 8.0
    assert steps[0]["extra"] == [1.5, {"y": 1.5}]
    assert steps[1]["loss"] == 11.5 and steps[1]["loss_scale"] == 16.0
    assert log.fetches == 0      # nothing came from a card


def test_schema_helpers_equal_the_jax_ones(tmp_path):
    assert (M.SCHEMA_VERSION, M.SUPPORTED_VERSIONS, M.SCHEMA_NAME) == \
        (JM.SCHEMA_VERSION, JM.SUPPORTED_VERSIONS, JM.SCHEMA_NAME)
    assert M._KINDS == JM._KINDS
    for p in ("TELEM_run.jsonl", "a/b/TELEM_run.p3.jsonl", "x"):
        for i in (0, 3):
            assert M.per_process_path(p, i) == JM.per_process_path(p, i)
    base = os.path.basename(M.default_sidecar_path("tag", str(tmp_path)))
    assert base.startswith("TELEM_tag_") and base.endswith("Z.jsonl")
    assert M.process_identity(2, 4) == JM.process_identity(2, 4)
    for bad, match in (({"v": 99, "kind": "step", "t": 1.0}, "version"),
                       ({"v": 1, "kind": "nope", "t": 1.0}, "kind"),
                       ({"v": 1, "kind": "step"}, "'t'")):
        for mod in (M, JM):
            with pytest.raises(ValueError, match=match):
                mod.validate_record(bad)
    p = tmp_path / "headless.jsonl"
    p.write_text('{"v": 1, "kind": "step", "t": 1.0}\n')
    with pytest.raises(ValueError, match="header"):
        M.read_sidecar(str(p))
    with pytest.raises(ValueError, match="unknown record kind"):
        M.note_kind("nope")


def test_process_identity_reads_the_launcher_environment(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert M.process_identity() == (2, 4)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert M.process_identity() == (0, 1)


def test_multiprocess_paths_are_suffixed(tmp_path):
    log = M.MetricsLogger(str(tmp_path / "TELEM_f.jsonl"), run="f",
                          process_index=1, process_count=2,
                          track_compiles=False)
    log.close()
    assert log.path.endswith("TELEM_f.p1.jsonl")
    (h,) = [r for r in M.read_sidecar(log.path) if r["kind"] == "header"]
    assert (h["process_index"], h["process_count"]) == (1, 2)


def test_compile_events_reach_the_compile_record(tmp_path):
    log = M.MetricsLogger(str(tmp_path / "c.jsonl"), run="c")
    M.record_compile(M.CAPTURE_EVENT, 0.25)
    M.record_compile(M.CAPTURE_EVENT, 0.5)
    M.record_compile(M.BUILD_EVENT, 2.0)
    log.log_compiles()
    M.record_compile(M.CAPTURE_EVENT, 0.25)
    log.close()
    M.record_compile(M.CAPTURE_EVENT, 1.0)   # no tracker: ignored
    comps = [r for r in M.read_sidecar(log.path) if r["kind"] == "compile"]
    assert [c["backend_compiles"] for c in comps] == [3, 4]
    assert [c["jaxpr_traces"] for c in comps] == [2, 3]
    assert [c["backend_compiles_delta"] for c in comps] == [3, 1]
    assert comps[-1]["durations_s"][M.BUILD_EVENT] == 2.0
    assert M.CompileTracker._installed is None


def test_a_new_logger_takes_over_compile_tracking(tmp_path):
    a = M.MetricsLogger(str(tmp_path / "a.jsonl"), run="a")
    b = M.MetricsLogger(str(tmp_path / "b.jsonl"), run="b")
    M.record_compile(M.BUILD_EVENT, 1.0)
    a.close()
    M.record_compile(M.BUILD_EVENT, 1.0)     # b still tracks
    b.close()
    ca = [r for r in M.read_sidecar(a.path) if r["kind"] == "compile"]
    cb = [r for r in M.read_sidecar(b.path) if r["kind"] == "compile"]
    assert ca[0]["backend_compiles"] == 0
    assert cb[0]["backend_compiles"] == 2


def test_pending_notes_drain_into_the_next_flush(tmp_path):
    M.note("mesh_created", devices=8)
    M.note_kind("amp_overflow", source="fp16_optimizer", loss_id=0)
    log = M.MetricsLogger(str(tmp_path / "n.jsonl"), run="n",
                          track_compiles=False)
    log.close()
    recs = M.read_sidecar(log.path)
    (ev,) = [r for r in recs if r["kind"] == "event"]
    assert ev["name"] == "mesh_created" and ev["devices"] == 8
    (ov,) = [r for r in recs if r["kind"] == "amp_overflow"]
    assert ov["source"] == "fp16_optimizer"


def test_tees_see_the_logged_copies_and_a_raising_tee_is_dropped(tmp_path):
    log = M.MetricsLogger(str(tmp_path / "tee.jsonl"), run="tee",
                          track_compiles=False)
    seen = []

    def bad(rec):
        raise RuntimeError("tee")

    log.add_tee(seen.append)
    log.add_tee(bad)
    x = torch.tensor(2.0)
    log.log_step(0, loss=x)
    log.log_step(1, loss=x)
    assert len(log._tees) == 1
    assert seen[0]["loss"] is not x and float(seen[0]["loss"]) == 2.0
    log.close()


def test_tracked_bytes_count_every_leaf():
    tree = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
            "b": [torch.zeros(5, dtype=torch.int32), None],
            "c": np.zeros((2, 2), np.float64), "d": 3}
    assert M.tracked_bytes_per_device(tree) == 3 * 4 * 2 + 5 * 4 + 4 * 8
    assert M.tracked_bytes_per_device(tree) == JM.tracked_bytes_per_device(
        {"a": jnp.zeros((3, 4), jnp.bfloat16),
         "b": [jnp.zeros(5, jnp.int32), None],
         "c": np.zeros((2, 2), np.float64), "d": 3})


def test_a_logger_shared_by_threads_keeps_every_record(tmp_path):
    """Replica threads may share one logger: logging, tees and flushes
    from 16 threads lose no record and keep each tensor's value."""
    log = M.MetricsLogger(str(tmp_path / "mt.jsonl"), run="mt",
                          flush_every=7, track_compiles=False)
    seen = []
    log.add_tee(seen.append)
    n_threads, n = 16, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n):
                log.log_step(k * n + i, loss=torch.tensor(float(k * n + i)),
                             thread=k)
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    log.close()
    steps = [r for r in M.read_sidecar(log.path) if r["kind"] == "step"]
    assert sorted(r["step"] for r in steps) == list(range(n_threads * n))
    assert all(r["loss"] == float(r["step"]) for r in steps)
    assert len(seen) == n_threads * n + 2      # + header, close


def test_memory_record_on_the_cpu_says_unavailable(tmp_path):
    log = M.MetricsLogger(str(tmp_path / "m.jsonl"), run="m",
                          track_compiles=False)
    log.log_memory()
    log.close()
    mem = [r for r in M.read_sidecar(log.path) if r["kind"] == "memory"]
    assert mem and all(r == {**r, "device": "0", "available": False}
                       for r in mem)
    assert "backend" not in M.read_sidecar(log.path)[0]


def test_sidecar_line_is_json_per_record(sidecars):
    _, trecs, path = sidecars
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    # the pending note drains at close's flush, after the close record,
    # as in the JAX logger
    assert lines == trecs
    assert [r["kind"] for r in lines[-2:]] == ["close", "event"]
