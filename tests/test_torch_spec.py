"""Port parity: speculative decoding and the shared-prefix page cache in
the continuous-batching engine.

The tiny model of tests/test_serve.py, converted with ``params_from_jax``.
Greedy speculative streams (a 1-layer ``draft_from_prefix`` draft, k 2
and 3, dense and paged) must equal the JAX engine's NON-speculative greedy
streams token for token, with the acceptance ledger consistent; with the
target as its own draft every step accepts all k (the catch-up row's pin,
tests/test_serve.py:813-829); a paged spec run releases every page; a
temperature run replays its tokens and its histogram; a request whose
prompt and budget fill the arena (positions clamped to its end) keeps the
streams equal. Prefix sharing mirrors tests/test_serve.py:469-503: streams
equal the JAX dense engine's, fewer prefill chunks, at least 4 hits of 2
pages, and at the end only the cache's own holds on pages.
"""

import jax
import numpy as np
import pytest

from apex_tpu.models import TransformerLM as JLM
from apex_tpu.serve import ContinuousBatchingEngine as JEngine
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM
from apex_tpu_torch.serve import (ContinuousBatchingEngine, Request,
                                  draft_from_prefix, poisson_requests,
                                  summarize_serving)

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


def _requests(n, seed, new="uniform:2,8"):
    return poisson_requests(n, rate=0.0, prompt_dist="uniform:3,10",
                            new_dist=new, vocab_size=V, seed=seed,
                            max_len=32, prefill_chunk=4)


def _tokens(results):
    return [r.tokens for r in results]


@pytest.fixture(scope="module")
def jax_greedy(models):
    """The JAX engine's plain greedy streams, the parity basis."""
    jm, jp, _, _ = models
    eng = JEngine(jm, jp, **ENGINE)
    cache = {}

    def run(seed, n=8, new="uniform:2,8"):
        if (seed, n, new) not in cache:
            cache[(seed, n, new)] = _tokens(
                eng.run(_requests(n, seed, new))[0])
        return cache[(seed, n, new)]
    return run


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("k", [2, 3])
def test_spec_greedy_equals_jax_plain_greedy(models, jax_greedy, paged, k):
    _, _, tm, tp = models
    kw = dict(paged=True, page_size=8) if paged else {}
    eng = ContinuousBatchingEngine(tm, tp, device="cpu",
                                   draft=draft_from_prefix(tm, tp, 1),
                                   spec_k=k, **ENGINE, **kw)
    got, stats = eng.run(_requests(8, 31))
    assert _tokens(got) == jax_greedy(31)
    hist = stats["spec_accept_hist"]
    assert stats["spec_k"] == k and len(hist) == k + 1
    assert stats["spec_draft_tokens"] == sum(hist) * k
    assert stats["spec_accepted_tokens"] == sum(i * c for i, c in
                                                enumerate(hist))
    assert stats["spec_accept_mean"] == pytest.approx(
        stats["spec_accepted_tokens"] / sum(hist))
    # every emitted token after the first came from a spec step
    assert sum(len(t) - 1 for t in _tokens(got)) <= \
        stats["spec_accepted_tokens"] + sum(hist)
    summary = summarize_serving(got, stats, offered_rps=0.0)
    assert summary["spec_accept_hist"] == hist
    assert summary["spec_k"] == k


def test_spec_self_draft_accepts_everything(models):
    _, _, tm, tp = models
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                   prefill_chunk=4, device="cpu",
                                   draft=(tm, tp), spec_k=3)
    _, stats = eng.run(_requests(6, 34))
    hist = stats["spec_accept_hist"]
    assert stats["spec_accept_mean"] == 3.0, hist
    assert hist[:3] == [0, 0, 0] and hist[3] == sum(hist)


def test_spec_paged_releases_every_page(models):
    _, _, tm, tp = models
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", paged=True,
                                   page_size=8, kv_pages=8,
                                   draft=draft_from_prefix(tm, tp, 1),
                                   spec_k=3, **ENGINE)
    _, stats = eng.run(_requests(8, 32))
    assert stats["kv_pages_free"] == 8 and stats["kv_pages_free_min"] < 8
    assert int(np.count_nonzero(eng._page_table)) == 0
    assert all(eng._page_pool.ref(p) == 0 for p in range(1, 9))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_replays_at_temperature(models, paged):
    """Draws keyed (seed, request, token index, role, row): a rerun
    replays the tokens and the accepted-length histogram, and the slot
    count does not change them."""
    _, _, tm, tp = models
    kw = dict(paged=True, page_size=8) if paged else {}
    draft = draft_from_prefix(tm, tp, 1)
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                   prefill_chunk=4, temperature=0.9,
                                   seed=11, device="cpu", draft=draft,
                                   spec_k=2, **kw)
    reqs = _requests(6, 33)
    a, sa = eng.run(reqs)
    b, sb = eng.run(reqs)
    assert _tokens(a) == _tokens(b)
    assert sa["spec_accept_hist"] == sb["spec_accept_hist"]
    wide = ContinuousBatchingEngine(tm, tp, slots=3, max_len=32,
                                    prefill_chunk=4, temperature=0.9,
                                    seed=11, device="cpu", draft=draft,
                                    spec_k=2, **kw)
    assert _tokens(wide.run(reqs)[0]) == _tokens(a)
    plain = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                     prefill_chunk=4, device="cpu")
    assert _tokens(a) != _tokens(plain.run(reqs)[0])    # it samples


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_at_the_arena_end(models, paged):
    """Prompt + budget == max_len: the last steps' rows clamp to the
    arena's last position (several rows of a slot at one position, the
    duplicate writes of one value); the streams still equal the plain
    engine's, and an EOS cut holds."""
    jm, jp, tm, tp = models
    rng = np.random.RandomState(40)
    reqs = [Request(id=i, prompt=rng.randint(0, V, p).astype(np.int32),
                    max_new=32 - p, arrival_s=0.0)
            for i, p in enumerate((20, 25, 29, 31))]
    want = _tokens(JEngine(jm, jp, **ENGINE).run(reqs)[0])
    kw = dict(paged=True, page_size=8) if paged else {}
    eng = ContinuousBatchingEngine(tm, tp, device="cpu",
                                   draft=draft_from_prefix(tm, tp, 1),
                                   spec_k=3, **ENGINE, **kw)
    got, _ = eng.run(reqs)
    assert _tokens(got) == want
    assert [len(t) for t in want] == [12, 7, 3, 1]
    # a token whose first emission is the 5th or later
    cut = next(j for j in range(4, 12) if want[0][j] not in want[0][:j])
    eos = want[0][cut]
    jeos = _tokens(JEngine(jm, jp, eos_id=eos, **ENGINE).run(reqs)[0])
    eng_eos = ContinuousBatchingEngine(tm, tp, device="cpu", eos_id=eos,
                                       draft=draft_from_prefix(tm, tp, 1),
                                       spec_k=3, **ENGINE, **kw)
    assert _tokens(eng_eos.run(reqs)[0]) == jeos
    assert len(jeos[0]) == cut + 1


def _share_requests():
    rng = np.random.RandomState(16)
    sys_prompt = rng.randint(0, V, 16).astype(np.int32)
    return [Request(id=i,
                    prompt=np.concatenate(
                        [sys_prompt,
                         rng.randint(0, V, 2 + i % 4).astype(np.int32)]),
                    max_new=3, arrival_s=0.03 * i)
            for i in range(6)]


def test_prefix_share_hits_collapse_prefill_and_keep_parity(models):
    jm, jp, tm, tp = models
    reqs = _share_requests()
    jd, jsd = JEngine(jm, jp, slots=2, max_len=32, prefill_chunk=4).run(reqs)
    share = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                     prefill_chunk=4, paged=True,
                                     page_size=8, kv_pages=8,
                                     prefix_share=True, device="cpu")
    rs, ss = share.run(reqs)
    assert _tokens(rs) == _tokens(jd)
    assert ss["prefix_hits"] > 0
    assert ss["prefill_chunks"] < jsd["prefill_chunks"]
    assert rs[0].prefix_tokens == 0
    assert sum(1 for r in rs if r.prefix_tokens == 16) >= 4
    summary = summarize_serving(rs, ss, offered_rps=0.0)
    assert summary["prefix_hits"] == ss["prefix_hits"]
    assert summary["prefix_hit_requests"] >= 4
    assert summary["prefix_hit_ttft_p95"] is not None
    assert summary["kv_resident_peak_bytes"] > 0
    # at the end only the cache holds pages, one reference each
    cached = share._prefix_cache.pages
    assert ss["prefix_entries"] == len(cached) > 0
    assert ss["kv_pages_free"] == 8 - len(cached)
    assert all(share._page_pool.ref(p) == 1 for p in cached)
    assert (share._page_table == 0).all()


def test_prefix_share_equals_no_share_and_evicts_under_pressure(models):
    """A pool that cannot hold the cache and every request at once: the
    cache gives pages back (evictions), streams stay those of a no-share
    paged run."""
    _, _, tm, tp = models
    reqs = _share_requests() + [
        Request(id=10 + i, prompt=np.random.RandomState(50 + i).randint(
            0, V, 9).astype(np.int32), max_new=20, arrival_s=0.2)
        for i in range(3)]
    base = dict(slots=3, max_len=32, prefill_chunk=4, paged=True,
                page_size=8, kv_pages=6, device="cpu")
    ns, _ = ContinuousBatchingEngine(tm, tp, **base).run(reqs)
    share = ContinuousBatchingEngine(tm, tp, prefix_share=True, **base)
    rs, ss = share.run(reqs)
    assert _tokens(rs) == _tokens(ns)
    assert ss["prefix_evictions"] > 0
    assert ss["kv_pages_free"] + ss["prefix_entries"] == 6


def test_prefix_share_with_spec(models):
    """The draft's pool follows the same page ids: a hit maps pages whose
    draft lanes the first request prefilled; streams equal the plain
    dense engine's."""
    _, _, tm, tp = models
    reqs = _share_requests()
    want, _ = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                       prefill_chunk=4,
                                       device="cpu").run(reqs)
    share = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                     prefill_chunk=4, paged=True,
                                     page_size=8, kv_pages=8,
                                     prefix_share=True, device="cpu",
                                     draft=draft_from_prefix(tm, tp, 1),
                                     spec_k=2)
    got, stats = share.run(reqs)
    assert _tokens(got) == _tokens(want)
    assert stats["prefix_hits"] > 0
    self_draft = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32,
                                          prefill_chunk=4, paged=True,
                                          page_size=8, kv_pages=8,
                                          prefix_share=True, device="cpu",
                                          draft=(tm, tp), spec_k=2)
    _, st = self_draft.run(reqs)
    assert st["spec_accept_mean"] == 2.0, st["spec_accept_hist"]


def test_draft_from_prefix_aliases_and_validates(models):
    _, _, tm, tp = models
    dm, dp = draft_from_prefix(tm, tp, 1)
    assert dm.num_layers == 1 and dp["layer_0"] is tp["layer_0"]
    assert dp["tok_emb"] is tp["tok_emb"] and "layer_1" not in dp
    with pytest.raises(ValueError, match="num_layers"):
        draft_from_prefix(tm, tp, 3)
    with pytest.raises(ValueError, match="draft needs spec_k"):
        ContinuousBatchingEngine(tm, tp, device="cpu", draft=(dm, dp),
                                 **ENGINE)
    with pytest.raises(ValueError, match="query rows"):
        ContinuousBatchingEngine(tm, tp, device="cpu", draft=(dm, dp),
                                 spec_k=8, **ENGINE)
