"""Port parity: flash attention (forward, lse and the backward).

The port's ``flash_attention`` on CPU tensors runs the kernels' plain
versions (``reference_attention`` with its lse for the forward, the
chunked ``flash_bwd_plain`` for dq/dk/dv); the JAX package's
``flash_attention`` runs its Pallas kernels in interpret mode off the TPU
(flash_attention.py:76-77), forward and backward. Both get the same numpy
inputs in f32: o and lse, then dq/dk/dv through ``jax.vjp`` against torch
autograd with cotangents for both outputs (a nonzero dlse, which folds
into the backward's per-row delta). Causal and not, ragged lengths, head
dims 64 and 128, query offsets that leave rows with nothing to see; and
a per-key ``kv_bias`` (key-padding masks of -1e30 plus small finite
values), shared [1, Sk] or per bh [BH, Sk], causal and not, Sq != Sk, with
one bh whose every key is masked (JAX gives o = 0, lse = NEG_INF and no
gradient through it). Tolerance: atol 1e-5 (plus rtol 1e-5 for the
larger gradients): the two sum the keys in other blocks and orders.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.contrib.multihead_attn import (SelfMultiheadAttn,
                                                   flash_attention)
from apex_tpu_torch.ops import flash_attn as FA

# the modules (the packages export the functions under the same names)
JFA = importlib.import_module(
    "apex_tpu.contrib.multihead_attn.flash_attention")
TFA = importlib.import_module(
    "apex_tpu_torch.contrib.multihead_attn.flash_attention")
MODULES = importlib.import_module(
    "apex_tpu_torch.contrib.multihead_attn.modules")

TOL = dict(atol=1e-5, rtol=1e-5)

# (bh, sq, sk, d, causal, q_start)
CASES = [
    (3, 40, 40, 64, True, 0),
    (2, 257, 257, 128, True, 0),
    (2, 257, 257, 64, False, 0),
    (2, 40, 40, 128, False, 0),
    (2, 33, 100, 64, True, 67),      # a chunk at the end of a longer cache
    (2, 40, 40, 64, True, -5),       # the first five rows see nothing
]


def _case(bh, sq, sk, d, seed):
    rs = np.random.RandomState(seed)
    q, do = (rs.randn(bh, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(bh, sk, d).astype(np.float32) for _ in range(2))
    dlse = rs.randn(bh, sq).astype(np.float32)
    return q, k, v, do, dlse


@pytest.mark.parametrize("bh,sq,sk,d,causal,q_start", CASES)
def test_forward_and_backward_match_jax(bh, sq, sk, d, causal, q_start):
    q, k, v, do, dlse = _case(bh, sq, sk, d, seed=sq + d)
    scale = 1.0 / np.sqrt(d)

    def jfn(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, causal=causal, scale=scale,
                                   q_start=q_start, return_lse=True)

    (o_j, lse_j), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    dq_j, dk_j, dv_j = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o, lse = flash_attention(qt, kt, vt, causal=causal, scale=scale,
                             q_start=q_start, return_lse=True)
    dq, dk, dv = torch.autograd.grad(
        (o, lse), (qt, kt, vt),
        (torch.from_numpy(do), torch.from_numpy(dlse)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_j),
                               **TOL)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if q_start < 0:
        dead = slice(0, -q_start)
        assert not o[:, dead].any()
        assert bool((lse[:, dead] == FA.NEG_INF).all())
        assert not dq[:, dead].any()


# (bh, sq, sk, d, causal, shared kv_bias)
KVB_CASES = [
    (3, 40, 40, 64, True, False),
    (4, 33, 70, 64, False, False),     # cross-attention: Sq != Sk
    (2, 65, 65, 128, False, True),     # one bias row for every bh
    (4, 29, 28, 64, False, False),     # the seq2seq shape, cut down
]


def _kv_bias(bh, sk, shared, seed):
    """Key-padding masks (-1e30 past each row's length) plus small finite
    biases on the kept keys; bh 0 masks every key (a source that is all
    padding) unless the row is shared."""
    rs = np.random.RandomState(seed)
    rows = 1 if shared else bh
    lengths = rs.randint(sk // 2, sk + 1, rows)
    if not shared:
        lengths[0] = 0
    keep = np.arange(sk)[None, :] < lengths[:, None]
    return np.where(keep, rs.randn(rows, sk) * 0.5, -1.0e30).astype(
        np.float32)


@pytest.mark.parametrize("bh,sq,sk,d,causal,shared", KVB_CASES)
def test_kv_bias_forward_and_backward_match_jax(bh, sq, sk, d, causal,
                                                 shared):
    q, k, v, do, dlse = _case(bh, sq, sk, d, seed=sq + sk)
    kvb = _kv_bias(bh, sk, shared, seed=bh + sk)
    scale = 1.0 / np.sqrt(d)

    def jfn(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, kv_bias=jnp.asarray(kvb),
                                   causal=causal, scale=scale,
                                   return_lse=True)

    (o_j, lse_j), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    dq_j, dk_j, dv_j = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    kvt = torch.from_numpy(kvb).requires_grad_(True)
    o, lse = flash_attention(qt, kt, vt, kv_bias=kvt, causal=causal,
                             scale=scale, return_lse=True)
    dq, dk, dv, dkvb = torch.autograd.grad(
        (o, lse), (qt, kt, vt, kvt),
        (torch.from_numpy(do), torch.from_numpy(dlse)), allow_unused=True)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_j),
                               **TOL)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert dkvb is None                  # mask data: no gradient
    if not shared:       # bh 0 sees nothing and passes nothing back
        assert not o[0].any() and bool((lse[0] == FA.NEG_INF).all())
        assert not (dq[0].any() or dk[0].any() or dv[0].any())


def test_kv_bias_plain_backward_equals_autograd_of_the_unfused_path():
    """``flash_bwd_plain`` with a per-bh kv_bias (k chunks of 16 over a
    ragged 37) against torch autograd through ``reference_attention`` in
    float64, bh 0 fully masked; masked keys get no gradient."""
    q, k, v, do, dlse = (torch.from_numpy(a).double()
                         for a in _case(3, 30, 37, 64, seed=5))
    kvb = torch.from_numpy(_kv_bias(3, 37, False, seed=6)).double()
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = FA.reference_attention(*ts, kv_bias=kvb, scale=0.125,
                                    return_lse=True)
    want = torch.autograd.grad((o, lse), ts, (do, dlse))
    delta = FA.flash_delta(o.detach(), do, dlse)
    got = FA.flash_bwd_plain(q, k, v, do, lse.detach().float(), delta,
                             causal=False, scale=0.125, kv_bias=kvb,
                             block_k=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.nan_to_num(w.numpy()),
                                   atol=1e-5, rtol=1e-5)
    masked = kvb < -1e29
    assert not got[1][masked].any() and not got[2][masked].any()


def test_reference_attention_broadcasts_biases_as_jax():
    """``reference_attention`` with a full additive ``bias`` and with a
    ``kv_bias`` [B, 1, Sk] against q [B, H, 1, hd], the greedy decode's
    broadcast (seq2seq.py:303-308): ``kv_bias[..., None, :]``."""
    rs = np.random.RandomState(8)
    q = rs.randn(2, 3, 1, 64).astype(np.float32)
    k, v = (rs.randn(2, 3, 9, 64).astype(np.float32) for _ in range(2))
    kvb = np.where(rs.rand(2, 1, 9) < 0.3, -1.0e30, 0.0).astype(np.float32)
    bias = rs.randn(1, 1, 9).astype(np.float32)
    for kw in ({"kv_bias": kvb}, {"bias": bias, "kv_bias": kvb}):
        want = JFA.reference_attention(
            *(jnp.asarray(a) for a in (q, k, v)),
            **{n: jnp.asarray(a) for n, a in kw.items()})
        got = FA.reference_attention(
            *(torch.from_numpy(a) for a in (q, k, v)),
            **{n: torch.from_numpy(a) for n, a in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_four_dim_inputs_and_output_only_gradient():
    """[B, H, S, D] in, [B, H, S, D] out; a loss on o alone leaves dlse
    unset, as JAX's vjp with a zero lse cotangent."""
    q, k, v, do, _ = _case(4, 40, 40, 64, seed=7)
    q4, k4, v4, do4 = (a.reshape(2, 2, *a.shape[1:]) for a in (q, k, v, do))
    o_j, vjp = jax.vjp(lambda *a: JFA.flash_attention(*a, causal=True),
                       *(jnp.asarray(a) for a in (q4, k4, v4)))
    grads_j = vjp(jnp.asarray(do4))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q4, k4, v4)]
    o = flash_attention(*ts, causal=True)
    assert o.shape == (2, 2, 40, 64)
    grads = torch.autograd.grad(o, ts, torch.from_numpy(do4))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), **TOL)
    for got, want in zip(grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_equals_autograd_of_the_unfused_path(causal):
    """``flash_bwd_plain`` (k chunks of 16 over a ragged 37) against torch
    autograd through ``reference_attention`` in float64."""
    q, k, v, do, dlse = (torch.from_numpy(a).double()
                         for a in _case(2, 37, 37, 64, seed=3))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = FA.reference_attention(*ts, causal=causal, scale=0.125,
                                    return_lse=True)
    want = torch.autograd.grad((o, lse), ts, (do, dlse))
    delta = FA.flash_delta(o.detach(), do, dlse)
    got = FA.flash_bwd_plain(q, k, v, do, lse.detach().float(), delta,
                             causal=causal, scale=0.125, block_k=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_cpu_wrappers_launch_nothing():
    q, k, v, do, _ = (torch.from_numpy(a) for a in _case(2, 40, 40, 64, 1))
    fns = (FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv)
    before = [f.launches for f in fns]
    o, lse = FA.flash_fwd(q, k, v, causal=True)
    delta = FA.flash_delta(o, do)
    FA.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=0.125)
    FA.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=0.125)
    assert [f.launches for f in fns] == before


def test_unported_options_raise():
    q = torch.zeros(2, 8, 64)
    for kw in ({"dropout_rate": 0.1},
               {"kv_bias": torch.zeros(2, 8), "dropout_rate": 0.1}):
        with pytest.raises(NotImplementedError, match="item 15"):
            flash_attention(q, q, q, **kw)
    with pytest.raises(NotImplementedError, match="item 15"):
        flash_attention(q, q, q, torch.zeros(2, 8, 8))
    mha = SelfMultiheadAttn(64, 2, causal=True, dropout=0.1)
    with pytest.raises(NotImplementedError, match="dropout"):
        mha.apply(mha.init(torch.Generator().manual_seed(0)),
                  torch.zeros(4, 1, 64))
    with pytest.raises(ValueError, match="impl"):
        SelfMultiheadAttn(64, 2, impl="flash")


def _bf16(*shape):
    """A bf16 tensor of ``shape`` holding one row (the rule reads shapes)."""
    return torch.zeros(1, *shape[1:], dtype=torch.bfloat16).expand(*shape)


def test_auto_rule_is_the_constant_not_the_environment(monkeypatch):
    """impl="auto": the threshold is the port's own constant, the H100's
    crossover (128, PERF.md), not the JAX package's TPU one (4096); the
    TPU's environment override and crossover file are not read. On the
    card, flash from max(Sq, Sk) >= flash_min_s or once the unfused
    path's ~6 fp32 score buffers pass 2 GiB."""
    monkeypatch.setenv("APEX_FLASH_MIN_S", "8")
    monkeypatch.setenv("APEX_FLASH_COMPOSED_BYTES", "1")
    assert TFA.DEFAULT_FLASH_MIN_S == 128
    assert JFA.DEFAULT_FLASH_MIN_S == 4096
    src = Path(TFA.__file__).read_text() + Path(
        importlib.import_module("apex_tpu_torch.contrib.multihead_attn."
                                "modules").__file__).read_text()
    for word in ("import os", "getenv", "open(", ".json"):
        assert word not in src
    monkeypatch.setattr(MODULES, "_on_card", lambda t: True)
    mha = SelfMultiheadAttn(128, 2, causal=True, impl="auto")
    small = _bf16(2, 64, 64)
    assert not mha._flash_wins(small, small)
    at = _bf16(2, 128, 64)
    assert mha._flash_wins(at, at)
    wide = _bf16(20000, 127, 64)       # 6 * 20000 * 127^2 * 4 B > 2 GiB
    assert mha._flash_wins(wide, wide)
    assert SelfMultiheadAttn(128, 2, impl="auto",
                             flash_min_s=64)._flash_wins(small, small)


def test_auto_takes_the_kernel_only_where_it_takes_the_call(monkeypatch):
    """The kernels take bf16 on the card with head dim 64 or 128 and no
    full bias or dropout; "auto" sends everything else to the plain path
    (a routing rule: "fast" still raises on those, test_torch_cuda.py)."""
    mha = SelfMultiheadAttn(128, 2, impl="auto")
    long = _bf16(2, 4096, 64)
    assert not mha._flash_wins(long, long)            # a CPU tensor
    monkeypatch.setattr(MODULES, "_on_card", lambda t: True)
    assert mha._flash_wins(long, long)
    f32 = torch.zeros(2, 4096, 64)
    assert not mha._flash_wins(f32, f32)
    for d in (32, 96, 256):
        t = _bf16(2, 4096, d)
        assert not mha._flash_wins(t, t)
    assert mha._flash_wins(_bf16(2, 4096, 128), _bf16(2, 4096, 128))
    assert not mha._flash_wins(long, long, bias=torch.zeros(1, 4096, 4096))
    assert not mha._flash_wins(long, long, dropout_rate=0.1)
    assert not mha._flash_wins(_bf16(65536, 128, 64), _bf16(65536, 128, 64))


@pytest.mark.parametrize("impl", ["fast", "default", "auto"])
def test_module_impls_agree_with_grad(impl):
    """The three impls give the same output and input-projection grad
    (flash is exact attention, not an approximation)."""
    mha = SelfMultiheadAttn(64, 2, bias=True, causal=True, impl=impl)
    p = mha.init(torch.Generator().manual_seed(0))
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x = torch.from_numpy(np.random.RandomState(2).randn(33, 2, 64)
                         .astype(np.float32))
    out, _ = mha.apply(p, x)
    (g,) = torch.autograd.grad(out.square().sum(), p["in_proj"])
    ref = SelfMultiheadAttn(64, 2, bias=True, causal=True, impl="default")
    out0, _ = ref.apply(p, x)
    (g0,) = torch.autograd.grad(out0.square().sum(), p["in_proj"])
    torch.testing.assert_close(out, out0, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(g, g0, atol=1e-4, rtol=1e-5)
