"""Port parity: the decode kernel's split keys, head dim 64, and the
module's routing rule.

The decode kernel (ops/cuda/csrc/decode_attn.cu) cuts each (slot, head)
row's keys into chunks of ``DECODE_CHUNK`` positions, one block a chunk,
and a merge kernel adds the chunks' fp32 (m, l, acc) partials in chunk
order. The chunk layout is Python (``decode_chunks``, ``chunk_spans``),
checked here; the merge's plain version (``decode_merge_plain``) over
partials made chunk by chunk from the plain math must give the plain
decode (1e-6: the same softmax, summed in chunks). Head dim 64, which the
kernel takes and the JAX package sends to its reference, and a head dim
the kernel does not take (routed to the plain version on the card too)
are held against the JAX package's ``slot_decode_attention`` on the same
numpy inputs (1e-5 in f32); a tiny head-dim-64 LM served by the JAX
engine and by the port's dense and paged engines gives equal greedy
streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import decode_attention as JDA
from apex_tpu.models import TransformerLM as JLM
from apex_tpu.serve import ContinuousBatchingEngine as JEngine
from apex_tpu_torch.contrib.multihead_attn import decode_attention as TDA
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM
from apex_tpu_torch.ops import decode_attn as OPS
from apex_tpu_torch.serve import ContinuousBatchingEngine, poisson_requests

C = OPS.DECODE_CHUNK
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cap,n", [(1, 1), (63, 1), (64, 1), (65, 2),
                                   (1000, 16), (1024, 16), (1025, 17)])
def test_decode_chunks_cover_the_arena(cap, n):
    assert OPS.decode_chunks(cap) == n
    assert (n - 1) * C < cap <= n * C


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 127, 128, 129, 1024])
def test_chunk_spans_are_fixed_multiples(length):
    spans = OPS.chunk_spans(length)
    assert spans[0][0] == 0 and spans[-1][1] == length
    assert len(spans) == max(1, -(-length // C))
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert b == c and a % C == 0 and b - a == C
    assert all(a % C == 0 and 0 <= b - a <= C for a, b in spans)


def _dense(hd, seed=0, s=4, h=2, cap=200):
    rng = np.random.RandomState(seed)
    q = rng.randn(s, h, hd).astype(np.float32)
    k = rng.randn(s, h, cap, hd).astype(np.float32)
    v = rng.randn(s, h, cap, hd).astype(np.float32)
    lengths = np.asarray([0, 64, 65, cap][:s], np.int32)
    return q, k, v, lengths


def _partials(q, k, v, lengths, cap):
    """Each (row, chunk)'s (m, l, acc) by the plain math: scores of the
    chunk's live keys, their max, sum of exp and exp-weighted values."""
    s_dim, h, hd = q.shape
    part = torch.zeros(s_dim, h, OPS.decode_chunks(cap), hd + 2)
    scale = hd ** -0.5
    for s in range(s_dim):
        for c, (a, b) in enumerate(OPS.chunk_spans(int(lengths[s]))):
            if b == a:
                continue
            sc = torch.einsum("hd,hld->hl", q[s], k[s, :, a:b]) * scale
            m = sc.amax(-1)
            p = torch.exp(sc - m[:, None])
            part[s, :, c, 0] = m
            part[s, :, c, 1] = p.sum(-1)
            part[s, :, c, 2:] = torch.einsum("hl,hld->hd", p, v[s, :, a:b])
    return part


@pytest.mark.parametrize("hd", [64, 128])
def test_merge_of_chunk_partials_is_the_plain_decode(hd):
    q, k, v, lengths = (_t(a) for a in _dense(hd))
    want = OPS.decode_attention_plain(q, k, v, lengths)
    part = _partials(q, k, v, lengths, k.shape[2])
    # the rows of one chunk keep what the chunk kernel wrote (here the
    # plain output); the others are the merge's
    out = want.clone()
    out[lengths > C] = 0.0
    got = OPS.decode_merge(part, lengths, out, k.shape[2])
    assert got is out
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_head_dim_64_matches_jax_dense_and_paged(impl):
    q, k, v, lengths = _dense(64, seed=1)
    want = JDA.slot_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     impl=impl)
    got = TDA.slot_decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same keys behind a page table of page 8 (any page size: the
    # kernel follows the table per key)
    page, cap = 8, k.shape[2]
    mp = cap // page
    table = np.arange(1, 1 + 4 * mp, dtype=np.int32).reshape(4, mp)
    kp = np.zeros((1 + 4 * mp, 2, page, 64), np.float32)
    vp = np.zeros_like(kp)
    for s in range(4):
        for lp in range(mp):
            kp[table[s, lp]] = k[s, :, lp * page:(lp + 1) * page]
            vp[table[s, lp]] = v[s, :, lp * page:(lp + 1) * page]
    want_p = JDA.slot_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), impl=impl, page_table=jnp.asarray(table))
    got_p = TDA.slot_decode_attention(_t(q), _t(kp), _t(vp), _t(lengths),
                                      page_table=_t(table))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_array_equal(got_p.numpy(), got.numpy())


@pytest.mark.parametrize("hd", [32, 96])
def test_a_head_dim_the_kernel_does_not_take_is_routed_plain(hd,
                                                             monkeypatch):
    """The module sends it to the plain version before any wrapper is
    reached (on the card too: no wrapper is called), as JAX's rule does."""
    q, k, v, lengths = _dense(hd, seed=2)
    want = JDA.slot_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths))

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called")
    monkeypatch.setattr(TDA, "decode_attention", refuse)
    monkeypatch.setattr(TDA, "paged_decode_attention", refuse)
    got = TDA.slot_decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_the_module_takes_the_kernels_head_dims(monkeypatch):
    q, k, v, lengths = (_t(a) for a in _dense(64, seed=3))
    calls = []
    monkeypatch.setattr(TDA, "decode_attention",
                        lambda *a, **kw: calls.append("dense"))
    TDA.slot_decode_attention(q, k, v, lengths)
    assert calls == ["dense"]


V, ENGINE = 50, dict(slots=3, max_len=32, prefill_chunk=4)


@pytest.fixture(scope="module")
def hd64_models():
    jm = JLM(vocab_size=V, max_seq_len=64, embed_dim=128, num_heads=2,
             num_layers=2)
    jp = jm.init(jax.random.key(3))
    tm = TLM(vocab_size=V, max_seq_len=64, embed_dim=128, num_heads=2,
             num_layers=2, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_head_dim_64_lm_served_by_both_engines(hd64_models):
    jm, jp, tm, tp = hd64_models
    assert tm.embed_dim // tm.num_heads == 64
    reqs = poisson_requests(6, rate=0.0, prompt_dist="uniform:3,10",
                            new_dist="uniform:2,8", vocab_size=V, seed=4,
                            max_len=32, prefill_chunk=4)
    want, _ = JEngine(jm, jp, **ENGINE).run(reqs)
    dense, _ = ContinuousBatchingEngine(tm, tp, device="cpu",
                                        **ENGINE).run(reqs)
    paged, _ = ContinuousBatchingEngine(tm, tp, device="cpu", paged=True,
                                        page_size=8, kv_pages=8,
                                        **ENGINE).run(reqs)
    streams = [r.tokens for r in want]
    assert [r.tokens for r in dense] == streams
    assert [r.tokens for r in paged] == streams
