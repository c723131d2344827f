"""The router's in-process replicas on an NVIDIA card (marker ``cuda``).

A small LM (2 layers, width 256, 2 heads of 128: the decode kernel's head
dim) in fp32, served by two ``EngineReplica`` threads behind a ``Router``:
each replica runs on a CUDA stream of its own and their greedy streams
equal one plain engine's; ``start`` on an engine that was not warmed up
raises naming ``warmup()``; a program that would capture, or run eagerly,
while a replica runs raises; the kernel wrappers' launch counts stay
exact while two threads replay. Without a card every test here skips. On
a machine with one::

    python -m pytest --noconftest -m cuda tests/test_torch_router_cuda.py -q
"""

import sys
import threading
import time

import pytest
import torch

from apex_tpu_torch.models import TransformerLM
from apex_tpu_torch.serve import (ContinuousBatchingEngine, EngineReplica,
                                  Router, merge_router_run,
                                  poisson_requests)
from apex_tpu_torch.serve import programs
from apex_tpu_torch.serve.programs import counted_wrappers

pytestmark = pytest.mark.cuda

V = 512
ENGINE = dict(slots=4, max_len=128, prefill_chunk=16)


@pytest.fixture(scope="module")
def lm():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TransformerLM(vocab_size=V, max_seq_len=128, embed_dim=256,
                          num_heads=2, num_layers=2)
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def warm_pair(lm):
    engines = [ContinuousBatchingEngine(*lm, **ENGINE) for _ in range(2)]
    for e in engines:
        e.warmup()
    return engines


def _requests(n=16, rate=0.0):
    return poisson_requests(n, rate=rate, prompt_dist="uniform:4,40",
                            new_dist="uniform:2,24", vocab_size=V, seed=0,
                            max_len=128, prefill_chunk=16)


def _counts():
    return {fn.__name__: fn.launches for fn in counted_wrappers()}


def _serve(engines, reqs):
    replicas = [EngineReplica(e, i) for i, e in enumerate(engines)]
    router = Router(replicas, policy="least-queue")
    t0 = time.perf_counter()
    for rep in replicas:
        rep.start(t0, on_retire=lambda res, i=rep.index:
                  router.on_complete(i, res.id))
    shed = router.run(reqs, t0=t0)
    router.close()
    for rep in replicas:
        rep.join(120.0)
    assert not any(rep._thread.is_alive() for rep in replicas)
    results, _ = merge_router_run(replicas, shed)
    return replicas, router, results


@pytest.mark.parametrize("rate", [0.0, 40.0])
def test_two_replicas_on_their_own_streams_equal_one_engine(warm_pair,
                                                            rate):
    reqs = _requests(rate=rate)
    base, _ = warm_pair[0].run(reqs)
    caps = [sum(p.captures for p in e.programs.values()) for e in warm_pair]
    replicas, router, got = _serve(warm_pair, reqs)
    assert [r.tokens for r in got] == [r.tokens for r in base]
    assert router.summary()["completed"] == len(reqs)
    assert all(router.summary()["per_replica"][i]["routed"] for i in (0, 1))
    streams = [rep.stream for rep in replicas]
    default = torch.cuda.default_stream()
    assert all(s is not None and s != default for s in streams)
    assert streams[0] != streams[1]
    assert [sum(p.captures for p in e.programs.values())
            for e in warm_pair] == caps
    assert programs.fleet_running() == 0


def test_start_refuses_an_engine_not_warmed_up(lm):
    eng = ContinuousBatchingEngine(*lm, **ENGINE)
    rep = EngineReplica(eng, 0)
    with pytest.raises(RuntimeError, match=r"warmup\(\)"):
        rep.start(time.perf_counter(), on_retire=lambda res: None)
    assert rep._thread is None and programs.fleet_running() == 0


def test_no_capture_or_eager_call_while_a_replica_runs(lm, warm_pair):
    rep = EngineReplica(warm_pair[0], 0)
    rep.start(time.perf_counter(), on_retire=lambda res: None)
    try:
        assert programs.fleet_running() == 1
        cold = ContinuousBatchingEngine(*lm, **ENGINE)
        with pytest.raises(RuntimeError, match="capture while 1 replica"):
            cold.run(_requests(2))
        assert all(p.captures == 0 for p in cold.programs.values())
        with programs.eager():
            with pytest.raises(RuntimeError, match="eager call while"):
                warm_pair[1].run(_requests(2))
            with pytest.raises(RuntimeError, match="eager"):
                EngineReplica(warm_pair[1], 1).start(
                    time.perf_counter(), on_retire=lambda res: None)
    finally:
        rep.close()
        rep.join(60.0)
    assert rep.error is None and not rep._thread.is_alive()
    assert programs.fleet_running() == 0
    cold.warmup()       # after the fleet: captures again
    assert all(p.captures == 1 for p in cold.programs.values())


def test_launch_counts_stay_exact_under_two_replaying_threads(warm_pair):
    reqs = _requests(24)
    replays = [{n: p.replays for n, p in e.programs.items()}
               for e in warm_pair]
    before = _counts()
    _serve(warm_pair, reqs)
    torch.cuda.synchronize()
    got = {k: n - before[k] for k, n in _counts().items()}
    want = {k: sum((p.replays - replays[i][n]) * p.launches.get(k, 0)
                   for i, e in enumerate(warm_pair)
                   for n, p in e.programs.items()) for k in got}
    assert got == want and got["ln_fwd"] > 0 and got["decode_attention"] > 0
    # the replays alone, hammered from two threads on their own streams
    decode = [e.programs["decode"] for e in warm_pair]
    before = _counts()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer(prog, stream):
            with torch.cuda.stream(stream):
                for _ in range(400):
                    prog()
                stream.synchronize()

        threads = [threading.Thread(target=hammer, args=(
            p, torch.cuda.Stream())) for p in decode]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    got = {k: n - before[k] for k, n in _counts().items()}
    want = {k: 400 * sum(p.launches.get(k, 0) for p in decode) for k in got}
    assert got == want
