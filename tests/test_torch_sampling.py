"""Port parity: the sampling filters, sampled ``generate`` and the
speculative rejection sampler.

``TransformerLM._filter_logits`` against the JAX package's on the same
numpy logits, bit for bit (kept values and the -inf pattern), ties at the
k-th value and at the nucleus cutoff included, and ``top_p=1.0``; where
the nucleus at 1.0 is decided by the last bits of the cumulative sum
(probabilities below its rounding), every token of probability >= 1e-6
is kept by both.
Sampled ``generate`` draws from the port's counter stream keyed (seed,
row, position), where JAX draws from threefry: the streams cannot match
across packages, so inside the port a key replays bit for bit, ``top_k=1``
and a tiny ``top_p`` equal greedy, and ``top_p=1.0`` equals no filter;
greedy equals the JAX package's. The rejection sampler
(``serve.engine.spec_accept``): over 20,000 counter-stream draws at V 8,
the first emitted token is distributed as the TARGET, not the draft,
within a total variation of 0.02 (the expected sampling noise is about
0.008; the draft sits 0.3 away).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import TransformerLM as JLM
from apex_tpu_torch._stream import fold_key, gumbel_argmax, stream_uniforms
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM
from apex_tpu_torch.serve.engine import spec_accept

V = 50


@pytest.fixture(scope="module")
def models():
    jm = JLM(vocab_size=V, max_seq_len=64, embed_dim=32, num_heads=4,
             num_layers=2)
    jp = jm.init(jax.random.key(0))
    tm = TLM(vocab_size=V, max_seq_len=64, embed_dim=32, num_heads=4,
             num_layers=2, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _logits(kind: str) -> np.ndarray:
    rng = np.random.RandomState({"randn": 0, "ties": 1, "peaked": 2}[kind])
    if kind == "ties":
        # small integers: many exact ties, at the k-th value and across
        # the nucleus cutoff
        return rng.randint(-3, 4, (6, 40)).astype(np.float32)
    x = rng.randn(6, 40).astype(np.float32)
    return x * 4.0 if kind == "peaked" else x


_FILTERS = [(5, None), (None, 0.9), (5, 0.5), (1, None), (None, 1.0),
            (40, 1.0), (None, 0.3), (12, 0.97), (None, 1e-6)]
# a nucleus of 1.0 over peaked rows is decided by the last bits of the
# cumulative sum (its tail holds probabilities below fp32's rounding of
# 1.0): test_top_p_one_on_peaked_rows holds those
_CASES = [(kind, k, p) for kind in ("randn", "ties", "peaked")
          for k, p in _FILTERS if not (kind == "peaked" and p == 1.0)]


@pytest.mark.parametrize("kind,top_k,top_p", _CASES,
                         ids=[f"{c[0]}-k{c[1]}-p{c[2]}" for c in _CASES])
def test_filter_logits_bit_equal_to_jax(kind, top_k, top_p):
    x = _logits(kind)
    want = np.asarray(JLM._filter_logits(jnp.asarray(x), top_k, top_p))
    got = TLM._filter_logits(torch.from_numpy(x), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)
    if top_p == 1.0 and top_k is None:
        np.testing.assert_array_equal(got, x)        # nothing filtered


@pytest.mark.parametrize("top_k", [None, 40])
def test_top_p_one_on_peaked_rows(top_k):
    """top_p = 1.0 over rows whose smallest probabilities lie below the
    rounding of a cumulative sum near 1: which of those the nucleus keeps
    is decided by the last bits of exp, the row sum and the cumulative
    sum, which XLA's CPU code and torch compute in other orders (XLA's exp
    is its own polynomial; its sums are rewritten into blocks). Both
    packages keep every token of probability >= 1e-6 and the kept values
    unchanged, and neither returns a NaN (the clamp of the count)."""
    x = _logits("peaked")
    want = np.asarray(JLM._filter_logits(jnp.asarray(x), top_k, 1.0))
    got = TLM._filter_logits(torch.from_numpy(x), top_k, 1.0).numpy()
    probs = torch.softmax(torch.from_numpy(x), dim=-1).numpy()
    big = probs >= 1e-6
    for out in (got, want):
        assert not np.isnan(out).any()
        np.testing.assert_array_equal(out[big], x[big])
        kept = np.isfinite(out)
        np.testing.assert_array_equal(out[kept], x[kept])


def test_greedy_generate_equals_jax_and_sampling_replays(models):
    jm, jp, tm, tp = models
    prompt = np.random.RandomState(4).randint(0, V, (3, 6)).astype(np.int32)
    greedy = tm.generate(tp, torch.from_numpy(prompt), max_new_tokens=12)
    np.testing.assert_array_equal(
        greedy.numpy(),
        np.asarray(jm.generate(jp, jnp.asarray(prompt), max_new_tokens=12)))
    kw = dict(max_new_tokens=12, temperature=0.8, top_k=20, top_p=0.9)
    a = tm.generate(tp, torch.from_numpy(prompt), key=7, **kw)
    b = tm.generate(tp, torch.from_numpy(prompt), key=7, **kw)
    c = tm.generate(tp, torch.from_numpy(prompt), key=8, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    np.testing.assert_array_equal(a[:, :6].numpy(), prompt)


@pytest.mark.parametrize("filt", [dict(top_k=1), dict(top_p=1e-6),
                                  dict(top_k=1, top_p=0.5)])
def test_sampled_generate_with_one_token_left_is_greedy(models, filt):
    _, _, tm, tp = models
    prompt = torch.from_numpy(
        np.random.RandomState(5).randint(0, V, (2, 5)).astype(np.int32))
    greedy = tm.generate(tp, prompt, max_new_tokens=10)
    got = tm.generate(tp, prompt, max_new_tokens=10, temperature=1.5,
                      key=3, **filt)
    torch.testing.assert_close(got, greedy, rtol=0, atol=0)


def test_top_p_one_is_no_filter(models):
    _, _, tm, tp = models
    prompt = torch.from_numpy(
        np.random.RandomState(6).randint(0, V, (2, 5)).astype(np.int32))
    kw = dict(max_new_tokens=10, temperature=1.2, key=9)
    torch.testing.assert_close(tm.generate(tp, prompt, top_p=1.0, **kw),
                               tm.generate(tp, prompt, **kw), rtol=0,
                               atol=0)
    assert not torch.equal(tm.generate(tp, prompt, **kw),
                           tm.generate(tp, prompt, max_new_tokens=10))


def test_sampled_eos_latches(models):
    _, _, tm, tp = models
    prompt = torch.from_numpy(
        np.random.RandomState(8).randint(0, V, (4, 4)).astype(np.int32))
    free = tm.generate(tp, prompt, max_new_tokens=12, temperature=1.0,
                       key=5)
    eos = int(free[0, 6])
    got = tm.generate(tp, prompt, max_new_tokens=12, temperature=1.0, key=5,
                      eos_id=eos)
    for row_f, row_g in zip(free.tolist(), got.tolist()):
        new = row_f[4:]
        if eos in new:
            i = new.index(eos)
            assert row_g[4:4 + i + 1] == new[:i + 1]
            assert all(t == eos for t in row_g[4 + i:])
        else:
            assert row_g == row_f


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


_BAD = [dict(temperature=-0.5), dict(temperature=0.5),
        dict(temperature=0.5, key=1, top_k=0),
        dict(temperature=0.5, key=1, top_k=V + 1),
        dict(temperature=0.5, key=1, top_p=0.0),
        dict(temperature=0.5, key=1, top_p=1.5),
        dict(max_new_tokens=0)]


@pytest.mark.parametrize("kw", _BAD, ids=[",".join(f"{k}={v}" for k, v in
                                                   d.items()) for d in _BAD])
def test_generate_validation_matches_jax(models, kw):
    jm, jp, tm, tp = models
    kw = {"max_new_tokens": 3, **kw}
    prompt = np.zeros((1, 3), np.int32)
    jkw = dict(kw)
    if "key" in jkw:
        jkw["key"] = jax.random.key(jkw["key"])
    want = _raises(lambda: jm.generate(jp, jnp.asarray(prompt), **jkw))
    got = _raises(lambda: tm.generate(tp, torch.from_numpy(prompt), **kw))
    assert got == want


def test_counter_stream_is_a_pure_function():
    key = torch.arange(5, dtype=torch.int64)
    a = stream_uniforms(3, key, torch.full_like(key, 2), 16)
    assert a.shape == (5, 16) and bool(((a > 0) & (a < 1)).all())
    torch.testing.assert_close(a, stream_uniforms(3, key,
                                                  torch.full_like(key, 2),
                                                  16), rtol=0, atol=0)
    assert not torch.equal(a, stream_uniforms(4, key,
                                              torch.full_like(key, 2), 16))
    assert not torch.equal(fold_key(key, 1, 0), fold_key(key, 1, 1))
    assert not torch.equal(fold_key(key, 2), key)


def _tv(a, b):
    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


@pytest.mark.parametrize("k", [1, 2, 3])
def test_rejection_sampler_emits_the_target_distribution(k):
    """Draft rows q_j, target rows p_j (V 8), N draws a row of the
    counter stream: d_j ~ q_j by Gumbel argmax, then ``spec_accept``. The
    first emitted token must follow p_0 whatever q_0 is."""
    n, v, temp = 20000, 8, 1.0
    rng = np.random.RandomState(k)
    p_logits = torch.from_numpy(rng.randn(k + 1, v).astype(np.float32) * 1.5)
    q_logits = torch.from_numpy(rng.randn(k, v).astype(np.float32) * 1.5)
    keys = torch.arange(n, dtype=torch.int64)
    idx = torch.zeros_like(keys)
    drafts, qsel, qdists = [], [], []
    for j in range(k):
        lg = q_logits[j].expand(n, v)
        d = gumbel_argmax(lg / temp, stream_uniforms(0, fold_key(keys, 1, j),
                                                     idx, v))
        qj = torch.softmax(lg / temp, dim=-1)
        drafts.append(d)
        qsel.append(qj.gather(1, d[:, None].long())[:, 0])
        qdists.append(qj)
    toks = torch.stack([torch.zeros(n, dtype=torch.int32)] + drafts, dim=1)
    out, n_acc = spec_accept(
        toks, p_logits.expand(n, k + 1, v), temp,
        qsel=torch.stack(qsel, dim=1), qdists=torch.stack(qdists, dim=1),
        u=stream_uniforms(0, fold_key(keys, 2), idx, k),
        u_extra=stream_uniforms(0, fold_key(keys, 3), idx, v))
    assert out.shape == (n, k + 1) and int(n_acc.min()) >= 0
    assert int(n_acc.max()) <= k
    p0 = torch.softmax(p_logits[0], dim=-1).numpy()
    q0 = torch.softmax(q_logits[0], dim=-1).numpy()
    hist = np.bincount(out[:, 0].numpy(), minlength=v) / n
    assert _tv(hist, p0) < 0.02, (hist, p0)
    assert _tv(q0, p0) > 0.1          # the test can tell draft from target
    # accepted drafts are emitted as proposed
    for j in range(k):
        kept = n_acc > j
        assert torch.equal(out[kept, j], toks[kept, j + 1])


def test_rejection_sampler_greedy_takes_the_matching_prefix():
    logits = torch.full((3, 4, 6), -5.0)
    chain = torch.tensor([[1, 2, 3, 4], [1, 2, 3, 4], [5, 5, 5, 5]])
    logits.scatter_(2, chain[..., None], 5.0)
    toks = torch.tensor([[0, 1, 2, 3], [0, 1, 0, 3], [0, 4, 4, 4]],
                        dtype=torch.int32)
    out, n_acc = spec_accept(toks, logits, 0.0)
    assert n_acc.tolist() == [3, 1, 0]
    assert torch.equal(out, chain.to(torch.int32))
