"""Port parity: the serving engine's device programs, ``warmup`` and the
serialized ``fused=False`` engine.

The tiny model of tests/test_serve.py, converted with ``params_from_jax``.
``program_lineages()`` and ``warmup_coverage()`` equal each other and the
JAX engine's in every configuration; after ``warmup()`` a run calls no
program with a new signature (its input shapes and the addresses of every
buffer it reads: the CPU counterpart of "no capture after warmup", as
tests/test_serve.py:196-239 pins JAX's jit caches); greedy streams after
``warmup()`` equal the JAX engine's, dense, paged and speculative; the
serialized engine's streams equal the JAX serialized engine's and the
port's fused engine's, with EOS and the static policy as JAX's;
``_cached_blocks`` at a device start (one, or one a lane) is bit-equal to
the int path; two runs back to back give equal streams on the same
tensors.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from apex_tpu.models import TransformerLM as JLM
from apex_tpu.serve import ContinuousBatchingEngine as JEngine
from apex_tpu.serve import draft_from_prefix as j_draft
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM
from apex_tpu_torch.serve import (ContinuousBatchingEngine, Request,
                                  draft_from_prefix, poisson_requests)
from apex_tpu_torch.serve.programs import DeviceProgram

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


def _requests(n, seed=1, rate=0.0):
    return poisson_requests(n, rate=rate, prompt_dist="uniform:3,10",
                            new_dist="uniform:2,8", vocab_size=V,
                            seed=seed, max_len=32, prefill_chunk=4)


def _tokens(results):
    return [r.tokens for r in results]


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engines' greedy streams, fused and serialized, per request
    set (each JAX engine compiles its programs once)."""
    jm, jp, _, _ = models
    engines = {"fused": JEngine(jm, jp, **ENGINE),
               "serial": JEngine(jm, jp, fused=False, **ENGINE)}
    cache = {}

    def get(kind, seed, n=8):
        if (kind, seed, n) not in cache:
            res, stats = engines[kind].run(_requests(n, seed))
            cache[kind, seed, n] = (_tokens(res), stats)
        return cache[kind, seed, n]
    return get


_CONFIGS = {
    "dense": dict(**ENGINE),
    "paged": dict(paged=True, page_size=8, kv_pages=8, **ENGINE),
    "spec_dense": dict(spec_k=2, **ENGINE),
    "spec_paged": dict(spec_k=2, paged=True, page_size=8, **ENGINE),
    "one_chunk": dict(slots=3, max_len=32, prefill_chunk=20),
    "spec_one_chunk": dict(spec_k=2, slots=2, max_len=32, prefill_chunk=20),
    "serial": dict(fused=False, **ENGINE),
    "serial_one_chunk": dict(fused=False, slots=2, max_len=32,
                             prefill_chunk=20),
}


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_lineages_and_coverage_equal_the_jax_engine(models, name):
    jm, jp, tm, tp = models
    kw = dict(_CONFIGS[name])
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("spec_k"):
        jkw["draft"] = j_draft(jm, jp, 1)
        tkw["draft"] = draft_from_prefix(tm, tp, 1)
    je = JEngine(jm, jp, **jkw)
    te = ContinuousBatchingEngine(tm, tp, device="cpu", **tkw)
    assert te.program_lineages() == te.warmup_coverage()
    assert te.program_lineages() == je.program_lineages()
    assert te.warmup_coverage() == je.warmup_coverage()
    assert set(te.programs) == set(te.program_lineages())


def _signatures(eng, log):
    """Record, for every program call of ``eng``, its name, the shapes of
    the host arrays it was fed and the address and shape of every tensor
    its body can read: the input block, the pool, the draft arena and the
    carried buffers."""
    st = eng._state
    bufs = [t for kv in st.caches.values() for t in kv]
    bufs += [st.pos, st.active, st.last_tok, st.remaining, st.tok_idx,
             st.key, st.generation, eng._fh]
    if eng._dcaches:
        bufs += [t for kv in eng._dcaches.values() for t in kv]
    if eng._dprev is not None:
        bufs.append(eng._dprev)
    bufs += [ins._buf for ins in (eng._pin, eng._cin, eng._din)
             if ins is not None]
    orig = DeviceProgram.__call__

    def call(prog, **arrays):
        if any(prog is p for p in eng.programs.values()):
            log.add((prog.name,
                     tuple(sorted((k, np.asarray(v).shape)
                                  for k, v in arrays.items())),
                     tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                           for t in bufs)))
        return orig(prog, **arrays)
    return call


_SIG_CONFIGS = {
    "dense": dict(**ENGINE),
    "paged_prefix": dict(paged=True, page_size=8, prefix_share=True,
                         **ENGINE),
    "spec_paged": dict(spec_k=2, paged=True, page_size=8, **ENGINE),
    "serial": dict(fused=False, **ENGINE),
}


@pytest.mark.parametrize("name", list(_SIG_CONFIGS))
def test_warmup_covers_every_program_signature(models, monkeypatch, name):
    _, _, tm, tp = models
    common = (np.arange(8) % V + 1).astype(np.int32)
    full = tm.generate(tp, torch.from_numpy(common)[None],
                       max_new_tokens=6)[0, 8:].tolist()
    eos = int(full[2])                  # request 0 below stops early
    kw = dict(_SIG_CONFIGS[name], eos_id=eos)
    if kw.get("spec_k"):
        kw["draft"] = draft_from_prefix(tm, tp, 1)
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", **kw)
    log = set()
    monkeypatch.setattr(DeviceProgram, "__call__", _signatures(eng, log))
    eng.warmup()
    warm = set(log)
    assert {s[0] for s in warm} == set(eng.programs)
    rs = np.random.RandomState(3)

    def reqs(n):
        # prompts of 10-13 tokens span 3-4 chunks behind one shared
        # 8-token page; request 0's prompt is that page alone
        return [Request(id=i, prompt=common if i == 0 else np.concatenate(
                    [common, rs.randint(0, V, 2 + i % 4).astype(np.int32)]),
                    max_new=8 if i == 0 else 2 + i) for i in range(n)]
    sizes = []
    for k in (3, 2, 1):
        # rate 0: all k arrive at once and seat in one poll
        sizes.append(max(eng.run(reqs(k))[1]["prefill_batch_sizes"]))
    res, stats = eng.run(reqs(6))
    eng.run(_requests(8, seed=5, rate=200.0))
    assert log == warm, sorted(log - warm)
    assert sizes == ([3, 2, 1] if eng.fused else [1, 1, 1])
    assert res[0].tokens[-1] == eos and len(res[0].tokens) < 8
    if eng.prefix_share:
        assert stats["prefix_hits"] > 0


@pytest.mark.parametrize("name", ["dense", "paged", "spec_dense",
                                  "spec_paged"])
def test_greedy_streams_after_warmup_equal_the_jax_engine(models, jax_runs,
                                                          name):
    _, _, tm, tp = models
    kw = dict(_CONFIGS[name])
    if kw.get("spec_k"):
        kw["draft"] = draft_from_prefix(tm, tp, 1)
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", **kw)
    eng.warmup()
    got, _ = eng.run(_requests(8, seed=11))
    assert _tokens(got) == jax_runs("fused", 11)[0]


def test_serial_streams_equal_jax_serial_and_port_fused(models, jax_runs):
    _, _, tm, tp = models
    ser = ContinuousBatchingEngine(tm, tp, device="cpu", fused=False,
                                   **ENGINE)
    fused = ContinuousBatchingEngine(tm, tp, device="cpu", **ENGINE)
    got, stats = ser.run(_requests(8, seed=11))
    want, jstats = jax_runs("serial", 11)
    assert _tokens(got) == want
    assert _tokens(got) == _tokens(fused.run(_requests(8, seed=11))[0])
    assert not stats["fused"] and not jstats["fused"]
    assert stats["prefill_batch_sizes"] == [1] * 8 \
        == jstats["prefill_batch_sizes"]
    assert stats["prefill_chunks"] == jstats["prefill_chunks"]
    assert stats["decode_steps"] == jstats["decode_steps"]


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_serial_eos_and_policy_behave_as_jax(models, policy):
    jm, jp, tm, tp = models
    prompt = np.random.RandomState(9).randint(0, V, 5).astype(np.int32)
    full = tm.generate(tp, torch.from_numpy(prompt)[None],
                       max_new_tokens=10)[0, 5:].tolist()
    eos = int(full[3])                  # a token greedy decode emits
    reqs = [dataclasses.replace(r, prompt=prompt, max_new=10) if r.id == 0
            else r for r in _requests(5, seed=3)]
    kw = dict(slots=2, max_len=32, prefill_chunk=4, eos_id=eos,
              policy=policy, fused=False)
    got, stats = ContinuousBatchingEngine(tm, tp, device="cpu",
                                          **kw).run(reqs)
    jeng = JEngine(jm, jp, **kw)
    want, jstats = jeng.run(reqs)
    assert _tokens(got) == _tokens(want)
    toks = got[0].tokens
    assert toks[-1] == eos and eos not in toks[:-1] and len(toks) < 10
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert stats["prefill_chunks"] == jstats["prefill_chunks"]


@pytest.mark.parametrize("form", ["one_start", "per_lane"])
def test_cached_blocks_device_start_is_bit_equal(models, form):
    _, _, tm, tp = models
    b, t, pos0 = 3, 4, 8
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, t, tm.embed_dim, generator=g)
    hd = tm.embed_dim // tm.num_heads

    def caches():
        g2 = torch.Generator().manual_seed(1)
        return {f"layer_{i}": tuple(
                    torch.randn(b, tm.num_heads, 32, hd, generator=g2)
                    for _ in range(2))
                for i in range(tm.num_layers)}
    want_hid, want = tm._cached_blocks(tp, x, pos0, caches())
    if form == "one_start":
        got_hid, got = tm._cached_blocks(tp, x, torch.tensor([pos0]),
                                         caches())
        assert torch.equal(got_hid, want_hid)
    else:
        # a start a lane: each lane against the int path at its own start
        starts = [pos0, 3, 17]
        got_hid, got = tm._cached_blocks(tp, x, torch.tensor(starts),
                                         caches())
        for lane, p in enumerate(starts):
            ref = {n: (k[lane:lane + 1].clone(), v[lane:lane + 1].clone())
                   for n, (k, v) in caches().items()}
            h1, c1 = tm._cached_blocks(tp, x[lane:lane + 1], p, ref)
            assert torch.equal(got_hid[lane:lane + 1], h1)
            for n in c1:
                for a, r in zip(got[n], c1[n]):
                    assert torch.equal(a[lane:lane + 1], r)
        return
    for n in want:
        for a, r in zip(got[n], want[n]):
            assert torch.equal(a, r)


def test_back_to_back_runs_reuse_the_pool(models):
    _, _, tm, tp = models
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", paged=True,
                                   page_size=8, spec_k=2,
                                   draft=draft_from_prefix(tm, tp, 1),
                                   **ENGINE)

    def ptrs():
        st = eng._state
        return [t.data_ptr() for kv in list(st.caches.values())
                + list(eng._dcaches.values()) for t in kv] + [
            t.data_ptr() for t in (st.pos, st.active, st.last_tok,
                                   st.remaining, st.tok_idx, st.key,
                                   st.generation, eng._fh, eng._dprev)]
    before = ptrs()
    reqs = _requests(8, seed=4)
    a, _ = eng.run(reqs)
    b, _ = eng.run(reqs)
    assert _tokens(a) == _tokens(b)
    assert ptrs() == before
    assert all(p.captures == 0 for p in eng.programs.values())
