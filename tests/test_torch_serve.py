"""Port parity: the continuous-batching engine.

One JAX ``ContinuousBatchingEngine(slots=3, max_len=32, prefill_chunk=4)``
and the port's engine on the same weights (the tiny model of
tests/test_serve.py, converted with ``params_from_jax``) and the same
``poisson_requests``: greedy token streams must be equal per request.
Inside the port: paged (page 8, fewer pages than the dense arena holds)
equals dense token for token, the static policy drains between batches,
EOS retires a slot early, validation raises what the JAX engine raises,
and temperature sampling replays under a seed and does not depend on the
slot count. Engines are module-scoped: the JAX one compiles programs.
"""

import jax
import numpy as np
import pytest
import torch

from apex_tpu.models import TransformerLM as JLM
from apex_tpu.serve import ContinuousBatchingEngine as JEngine
from apex_tpu.serve import poisson_requests as j_requests
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM
from apex_tpu_torch.serve import (ContinuousBatchingEngine, Request,
                                  init_paged_state, init_slot_state,
                                  poisson_requests, summarize_serving)

V = 50
ENGINE = dict(slots=3, max_len=32, prefill_chunk=4)


@pytest.fixture(scope="module")
def models():
    jm = JLM(vocab_size=V, max_seq_len=64, embed_dim=32, num_heads=4,
             num_layers=2)
    jp = jm.init(jax.random.key(0))
    tm = TLM(vocab_size=V, max_seq_len=64, embed_dim=32, num_heads=4,
             num_layers=2, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def engine(models):
    _, _, tm, tp = models
    return ContinuousBatchingEngine(tm, tp, device="cpu", **ENGINE)


@pytest.fixture(scope="module")
def paged_engine(models):
    """8 pages of 8 where the dense arena reserves 12: 3-deep concurrency
    is admissible only because reservations follow each request's need."""
    _, _, tm, tp = models
    return ContinuousBatchingEngine(tm, tp, device="cpu", paged=True,
                                    page_size=8, kv_pages=8, **ENGINE)


def _requests(n, seed=1, rate=0.0, dist="uniform:3,10",
              new="uniform:2,8"):
    return poisson_requests(n, rate=rate, prompt_dist=dist, new_dist=new,
                            vocab_size=V, seed=seed, max_len=32,
                            prefill_chunk=4)


def _tokens(results):
    return [r.tokens for r in results]


def test_traffic_is_the_jax_traffic():
    a = _requests(6, seed=5, rate=8.0)
    b = j_requests(6, rate=8.0, prompt_dist="uniform:3,10",
                   new_dist="uniform:2,8", vocab_size=V, seed=5,
                   max_len=32, prefill_chunk=4)
    for x, y in zip(a, b):
        assert (x.id, x.max_new, x.arrival_s) == (y.id, y.max_new,
                                                  y.arrival_s)
        np.testing.assert_array_equal(x.prompt, y.prompt)


def test_greedy_streams_equal_the_jax_engine(models, engine):
    jm, jp, _, _ = models
    reqs = _requests(8)
    want, jstats = JEngine(jm, jp, **ENGINE).run(reqs)
    got, stats = engine.run(reqs)
    assert _tokens(got) == _tokens(want)
    assert all(r.finish_s is not None for r in got)
    # the same admission batching (a full 3-slot batch first)
    assert stats["prefill_batch_sizes"][0] == 3 == \
        jstats["prefill_batch_sizes"][0]
    summary = summarize_serving(got, stats, offered_rps=0.0)
    assert summary["completed"] == 8 and summary["dropped"] == 0
    assert summary["tokens_out"] == sum(len(t) for t in _tokens(want))
    assert 0.0 < summary["slot_occupancy"] <= 1.0


def test_paged_equals_dense_at_reduced_reservation(engine, paged_engine):
    reqs = _requests(10, seed=13, dist="geometric:6", new="geometric:5")
    rd, sd = engine.run(reqs)
    rp, sp = paged_engine.run(reqs)
    assert _tokens(rp) == _tokens(rd)
    assert sp["kv_reserved_bytes"] < sd["kv_reserved_bytes"]
    depth = cur = 0
    for ev in paged_engine.events:
        cur += 1 if ev[0] == "admit" else -1
        depth = max(depth, cur)
    assert depth == 3
    # every page came back and the table rows point at the null page
    assert sp["kv_pages_free"] == 8 and sp["kv_pages_free_min"] < 8
    assert (paged_engine._page_table == 0).all()
    assert all(paged_engine._page_pool.ref(p) == 0 for p in range(1, 9))


def test_page_reuse_never_leaks_stale_kv(engine, paged_engine):
    reqs = _requests(9, seed=14)
    rd, _ = engine.run(reqs)
    rp, _ = paged_engine.run(reqs)
    assert _tokens(rp) == _tokens(rd)


def test_slot_reuse_and_generations(engine):
    results, stats = engine.run(_requests(8))
    admits = [e for e in engine.events if e[0] == "admit"]
    retires = [e for e in engine.events if e[0] == "retire"]
    assert sorted(e[1] for e in admits) == list(range(8))
    assert sorted(e[1] for e in retires) == list(range(8))
    by_slot = {}
    for _, _, slot, gen in admits:
        assert gen == len(by_slot.setdefault(slot, [])) + 1
        by_slot[slot].append(gen)
    assert max(len(v) for v in by_slot.values()) >= 3
    assert stats["decode_steps"] > 0
    for r in results:
        assert r.generation >= 1 and r.slot in by_slot


def test_static_policy_drains_between_batches(models):
    _, _, tm, tp = models
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                   prefill_chunk=4, policy="static",
                                   device="cpu")
    results, _ = eng.run(_requests(6, seed=3))
    assert all(r.finish_s is not None for r in results)
    in_flight, draining = 0, False
    for ev in eng.events:
        if ev[0] == "admit":
            assert not draining, eng.events
            in_flight += 1
        else:
            in_flight -= 1
            draining = in_flight > 0
    kinds = [e[0] for e in eng.events]
    assert kinds[0] == "admit" and kinds[1] == "admit"


def test_eos_retires_slot_early_like_jax(models):
    jm, jp, tm, tp = models
    prompt = np.random.RandomState(9).randint(0, V, 5).astype(np.int32)
    full = tm.generate(tp, torch.from_numpy(prompt)[None],
                       max_new_tokens=10)[0, 5:].tolist()
    eos = int(full[3])                  # a token greedy decode emits
    req = [Request(id=0, prompt=prompt, max_new=10)]
    kw = dict(slots=2, max_len=32, prefill_chunk=4, eos_id=eos)
    got, _ = ContinuousBatchingEngine(tm, tp, device="cpu", **kw).run(req)
    want, _ = JEngine(jm, jp, **kw).run(req)
    toks = got[0].tokens
    assert toks[-1] == eos and eos not in toks[:-1] and len(toks) < 10
    assert toks == want[0].tokens


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


_BAD_ENGINES = [
    dict(policy="sorta"),
    dict(eos_id=V),
    dict(temperature=-1.0),
    dict(prefill_chunk=0),
    dict(prefix_share=True),
    dict(paged=True, page_size=6),
    dict(paged=True, page_size=12),
    dict(paged=True, page_size=8, kv_pages=3),
    dict(kv_pages=8),
    dict(paged=True, fused=False),
    dict(spec_k=2),
    dict(spec_k=-1),
]


@pytest.mark.parametrize("kw", _BAD_ENGINES,
                         ids=[",".join(k) for k in _BAD_ENGINES])
def test_engine_validation_matches_jax(models, kw):
    jm, jp, tm, tp = models
    base = dict(slots=2, max_len=32, prefill_chunk=4)
    want = _raises(lambda: JEngine(jm, jp, **{**base, **kw}))
    got = _raises(lambda: ContinuousBatchingEngine(
        tm, tp, device="cpu", **{**base, **kw}))
    assert got == want


_BAD_RUNS = [
    [Request(id=0, prompt=np.zeros(4, np.int32), max_new=40)],
    [Request(id=0, prompt=np.zeros(0, np.int32), max_new=2)],
    [Request(id=0, prompt=np.zeros(4, np.int32), max_new=0)],
    [Request(id=1, prompt=np.zeros(4, np.int32), max_new=2),
     Request(id=1, prompt=np.zeros(4, np.int32), max_new=2)],
]


@pytest.mark.parametrize("reqs", _BAD_RUNS,
                         ids=["budget", "empty", "max_new", "dup"])
def test_request_validation_matches_jax(models, engine, reqs):
    jm, jp, _, _ = models
    want = _raises(lambda: JEngine(jm, jp, **ENGINE).run(reqs))
    got = _raises(lambda: engine.run(reqs))
    assert got == want


def test_pool_validation_matches_jax(models):
    from apex_tpu.serve import init_paged_state as j_paged
    from apex_tpu.serve import init_slot_state as j_slot
    jm, jp, tm, tp = models
    for j_call, t_call in [
            (lambda: j_slot(jm, jp, 2, 65), lambda: init_slot_state(
                tm, tp, 2, 65, device="cpu")),
            (lambda: j_slot(jm, jp, 0, 16), lambda: init_slot_state(
                tm, tp, 0, 16, device="cpu")),
            (lambda: j_paged(jm, jp, 2, 32, 12, 8), lambda:
             init_paged_state(tm, tp, 2, 32, 12, 8, device="cpu")),
            (lambda: j_paged(jm, jp, 2, 32, 8, 3), lambda:
             init_paged_state(tm, tp, 2, 32, 8, 3, device="cpu"))]:
        assert _raises(t_call) == _raises(j_call)


def test_temperature_replays_and_is_slot_independent(models, engine):
    _, _, tm, tp = models
    reqs = _requests(6, seed=2)
    greedy, _ = engine.run(reqs)
    hot = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                   prefill_chunk=4, temperature=0.9,
                                   seed=11, device="cpu")
    a, _ = hot.run(reqs)
    b, _ = hot.run(reqs)
    assert _tokens(a) == _tokens(b)
    assert _tokens(a) != _tokens(greedy)       # it really samples
    wide = ContinuousBatchingEngine(tm, tp, slots=3, max_len=32,
                                    prefill_chunk=4, temperature=0.9,
                                    seed=11, device="cpu", paged=True,
                                    page_size=8)
    c, _ = wide.run(reqs)
    assert _tokens(c) == _tokens(a)
    other = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                     prefill_chunk=4, temperature=0.9,
                                     seed=12, device="cpu")
    d, _ = other.run(reqs)
    assert _tokens(d) != _tokens(a)


def test_unported_options_name_their_roadmap_row(models, engine):
    _, _, tm, tp = models
    # fused=False and warmup() are ported: they construct and run
    ser = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                   prefill_chunk=4, device="cpu",
                                   fused=False)
    ser.warmup()
    got, stats = ser.run(_requests(2))
    assert not stats["fused"] and stats["prefill_batch_sizes"] == [1, 1]
    engine.warmup()
    # speculative decoding and prefix sharing are ported: they construct,
    # and refuse what the JAX engine refuses
    from apex_tpu_torch.serve import draft_from_prefix
    for kw in (dict(spec_k=2, draft=draft_from_prefix(tm, tp, 1)),
               dict(paged=True, page_size=8, prefix_share=True)):
        ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                 prefill_chunk=4, device="cpu", **kw)
    with pytest.raises(ValueError, match="spec_k needs draft"):
        ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                 prefill_chunk=4, device="cpu", spec_k=2)
    # the telemetry and flight-recorder hooks and the program lint keep
    # raising, each naming its ROADMAP row (the tracer, slo and live
    # hooks and the router feed are ported)
    for hook in ("telemetry", "flightrec"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md Queue 1, slice 8"):
            engine.run(_requests(2), **{hook: object()})
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 24"):
        engine.lint_programs()
