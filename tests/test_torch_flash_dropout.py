"""Port parity: the rest of the flash attention — dropout, the full
additive bias and its gradient — and the attention modules' dropout.

``dropout_bits`` against the JAX package's bit for bit. The port's
``flash_attention`` on CPU tensors runs the kernels' plain versions
(``reference_attention`` with its lse, ``flash_bwd_plain`` with dS, and
its sum over bh for a shared bias); the JAX package's ``flash_attention``
runs its Pallas kernels in interpret mode off the TPU, forward and
backward, with the bias gradient from its dq kernel (a per-bh bias) or its
dbias kernel (a shared one). Both get the same numpy inputs in f32 and the
same dropout seed: o and lse, then dq, dk, dv and dbias through
``jax.vjp`` against torch autograd, with cotangents for both outputs.
Tolerance: atol 1e-5 plus rtol 1e-5, the two summing the keys (and dbias
the heads) in other orders; the masks are the same bits.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JSelf
from apex_tpu_torch.contrib.multihead_attn import (SelfMultiheadAttn,
                                                   flash_attention)
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.ops import flash_attn as FA

JFA = importlib.import_module(
    "apex_tpu.contrib.multihead_attn.flash_attention")
JMOD = importlib.import_module("apex_tpu.contrib.multihead_attn.modules")

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, -1, 2 ** 31 - 1, 0xFFFFFFFF])
def test_dropout_bits_equal_jax(seed):
    """Seeds at both ends of int32 and of uint32 (JAX's modules pass a
    signed int32 and the hash casts it to uint32), positions up to 2^16,
    bh up to 65535."""
    rs = np.random.RandomState(seed % 1000)
    n = 4096
    q = np.concatenate([[0, 65536], rs.randint(0, 65537, n)])
    k = np.concatenate([[65536, 0], rs.randint(0, 65537, n)])
    bh = np.concatenate([[65535, 0], rs.randint(0, 65536, n)])
    jseed = jnp.asarray(seed, jnp.uint32) if seed > 2 ** 31 - 1 \
        else jnp.asarray(seed, jnp.int32)
    want = np.asarray(JFA.dropout_bits(jseed, jnp.asarray(bh, jnp.int32),
                                       jnp.asarray(q, jnp.int32),
                                       jnp.asarray(k, jnp.int32)))
    got = FA.dropout_bits(seed, torch.from_numpy(bh), torch.from_numpy(q),
                          torch.from_numpy(k))
    assert got.dtype == torch.int64
    assert bool(((got >= 0) & (got < 2 ** 32)).all())
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert FA.drop_threshold(0.1) == JFA._drop_threshold(0.1) == 429496729


def test_dropout_arguments_are_checked():
    q = torch.zeros(1, 4, 64)
    for kw in ({"dropout_rate": 1.0}, {"dropout_rate": -0.1},
               {"dropout_rate": 0.1, "dropout_seed": 2 ** 32},
               {"dropout_rate": 0.1, "dropout_seed": -2 ** 31 - 1}):
        with pytest.raises(ValueError, match="dropout"):
            flash_attention(q, q, q, **kw)
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, q, q, torch.zeros(1, 4, 5))


# name -> (bh or (b, h), sq, sk, causal, q_start, k_start, bias rows: None,
# 1, "bh" or "4d", kv_bias, dropout rate, seed, bias_grad)
CASES = {
    "dropout": (4, 40, 40, False, 0, 0, None, False, 0.1, -5, True),
    "dropout_causal_offsets_kv_bias": (3, 33, 40, True, 5, 2, None, True,
                                       0.2, 12345, True),
    "bias_shared_dropout": (4, 40, 37, False, 0, 0, 1, False, 0.1, 7, True),
    "bias_per_bh_causal": (3, 40, 40, True, 0, 0, "bh", False, 0.0, 0,
                           True),
    "bias_4d_dropout": ((2, 2), 24, 24, True, 0, 0, "4d", False, 0.1, 9,
                        True),
    "ragged_bias_kv_bias_dropout": (2, 33, 45, False, 0, 0, 1, True, 0.1,
                                    -2 ** 31, True),
    "bias_grad_false": (2, 24, 24, False, 0, 0, 1, False, 0.1, 3, False),
}


def _inputs(case, seed):
    lead, sq, sk, _, _, _, rows, kvb, *_ = case
    lead = lead if isinstance(lead, tuple) else (lead,)
    bh = int(np.prod(lead))
    rs = np.random.RandomState(seed)
    q, do = (rs.randn(*lead, sq, 64).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(*lead, sk, 64).astype(np.float32) for _ in range(2))
    dlse = rs.randn(*lead, sq).astype(np.float32)
    bias = None
    if rows is not None:
        shape = {1: (1, sq, sk), "bh": (bh, sq, sk), "4d": (*lead, sq, sk)}
        bias = rs.randn(*shape[rows]).astype(np.float32)
        bias.reshape(-1, sq, sk)[0, :, ::5] = -1.0e30     # masked keys
    kv = None
    if kvb:
        kv = np.where(rs.rand(bh, sk) < 0.25, -1.0e30, 0.0).astype(
            np.float32)
    return q, k, v, do, dlse, bias, kv


@pytest.mark.parametrize("name", list(CASES))
def test_bias_and_dropout_match_jax(name):
    case = CASES[name]
    _, sq, sk, causal, q_start, k_start, _, _, rate, seed, bias_grad = case
    q, k, v, do, dlse, bias, kv = _inputs(case, seed=sq + sk)
    kw = dict(causal=causal, q_start=q_start, k_start=k_start,
              dropout_rate=rate, dropout_seed=seed, bias_grad=bias_grad,
              return_lse=True)
    has_bias = bias is not None
    ins = (q, k, v) + ((bias,) if has_bias else ())

    def jfn(*a):
        return JFA.flash_attention(
            *a[:3], a[3] if has_bias else None,
            kv_bias=None if kv is None else jnp.asarray(kv), **kw)

    (o_j, lse_j), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in ins))
    grads_j = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    o, lse = flash_attention(
        *ts[:3], ts[3] if has_bias else None,
        kv_bias=None if kv is None else torch.from_numpy(kv), **kw)
    grads = torch.autograd.grad((o, lse), ts, (torch.from_numpy(do),
                                               torch.from_numpy(dlse)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_j),
                               **TOL)
    for got, want in zip(grads, grads_j):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if has_bias and not bias_grad:
        assert not grads[3].any()            # a mask: zeros, as JAX's
    if has_bias and bias_grad:
        assert grads[3].any()


def test_dropout_changes_o_and_not_lse():
    """lse is dropout-free; o under dropout is the kept probabilities
    rescaled, so it differs from o without; the same seed gives the same
    bits, another seed another mask."""
    q, k, v, *_ = _inputs(CASES["dropout"], seed=1)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    o0, lse0 = flash_attention(q, k, v, return_lse=True)
    o1, lse1 = flash_attention(q, k, v, return_lse=True, dropout_rate=0.1,
                               dropout_seed=4)
    o2, _ = flash_attention(q, k, v, return_lse=True, dropout_rate=0.1,
                            dropout_seed=4)
    o3, _ = flash_attention(q, k, v, return_lse=True, dropout_rate=0.1,
                            dropout_seed=5)
    assert torch.equal(lse0, lse1) and torch.equal(o1, o2)
    assert not torch.allclose(o0, o1) and not torch.allclose(o1, o3)


def test_dbias_plain_equals_autograd_of_the_unfused_path():
    """``flash_bwd_plain``'s dS (k chunks of 16 over a ragged 37), per bh
    and summed for a shared bias, against torch autograd through
    ``reference_attention`` with dropout, in float64."""
    rs = np.random.RandomState(21)
    q, k, v, do = (torch.from_numpy(rs.randn(3, n, 64)).double()
                   for n in (30, 37, 37, 30))
    dlse = torch.from_numpy(rs.randn(3, 30)).double()
    for rows in (1, 3):
        bias = torch.from_numpy(rs.randn(rows, 30, 37)).double()
        ts = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        kw = dict(scale=0.125, dropout_rate=0.3, dropout_seed=99)
        o, lse = FA.reference_attention(*ts[:3], ts[3], return_lse=True,
                                        **kw)
        want = torch.autograd.grad((o, lse), ts, (do, dlse))
        delta = FA.flash_delta(o.detach(), do, dlse)
        got = FA.flash_bwd_plain(q, k, v, do, lse.detach().float(), delta,
                                 causal=False, bias=bias, return_ds=True,
                                 block_k=16, **kw)
        ds = got[3] if rows == 3 else got[3].sum(0, keepdim=True)
        for g, w in zip(got[:3] + (ds,), want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                       rtol=1e-5)
        if rows == 1:
            db = FA.flash_bwd_dbias(q, k, v, do, lse.detach().float(), delta,
                                    causal=False, bias=bias, **kw)
            np.testing.assert_allclose(db.numpy(), want[3].numpy(),
                                       atol=1e-5, rtol=1e-5)


def test_cpu_wrappers_with_extras_launch_nothing():
    q, k, v, do, _, bias, _ = _inputs(CASES["bias_shared_dropout"], 2)
    q, k, v, do, bias = (torch.from_numpy(a) for a in (q, k, v, do, bias))
    kw = dict(causal=False, scale=0.125, bias=bias, dropout_rate=0.1,
              dropout_seed=1)
    fns = (FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv,
           FA.flash_bwd_dbias)
    before = [f.launches for f in fns]
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw)
    assert [f.launches for f in fns] == before
    with pytest.raises(ValueError, match="return_ds"):
        FA.flash_bwd_dq(q, k, v, do, lse, delta, causal=False, scale=0.125,
                        return_ds=True)


def test_dbias_runs_fill_the_card_and_cover_bh():
    """The shared-bias kernel's split of bh: enough blocks for 4 a SM on
    132 SMs, every run nonempty, one run when the tiles alone fill it."""
    assert FA.dbias_runs(1536, 197, 197, 132) == 33      # 16 tiles
    assert FA.dbias_runs(128, 1024, 1024, 132) == 3      # 256 tiles
    assert FA.dbias_runs(3, 197, 197, 132) == 3
    assert FA.dbias_runs(1536, 4096, 4096, 132) == 1
    for bh in (1, 7, 100, 1536):
        runs = FA.dbias_runs(bh, 197, 197, 132)
        per = -(-bh // runs)
        assert (runs - 1) * per < bh <= runs * per


# -- the attention modules ----------------------------------------------------

def _module_case(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(24, 2, 64).astype(np.float32)       # [T, B, E]
    mask = np.where(rs.rand(24, 24) < 0.2, -1.0e4, 0.0).astype(np.float32)
    return x, mask


def test_module_dropout_in_training_against_eval():
    """Eval and training without a seed run no dropout; training with a
    seed drops (the same seed the same output, another another)."""
    x, _ = _module_case()
    mha = SelfMultiheadAttn(64, 2, bias=True, dropout=0.1)
    p = mha.init(torch.Generator().manual_seed(0))
    xt = torch.from_numpy(x)
    ev, _ = mha.apply(p, xt, is_training=False, dropout_seed=3)
    no_seed, _ = mha.apply(p, xt)
    tr, _ = mha.apply(p, xt, dropout_seed=3)
    tr2, _ = mha.apply(p, xt, dropout_seed=3)
    other, _ = mha.apply(p, xt, dropout_seed=4)
    assert torch.equal(ev, no_seed) and torch.equal(tr, tr2)
    assert not torch.allclose(tr, ev) and not torch.allclose(tr, other)


def test_attn_mask_under_fast_equals_default():
    """``attn_mask`` reaches the flash path as a bias with no gradient: the
    output and the projections' grads equal the unfused path's."""
    x, mask = _module_case(1)
    pad = np.zeros((2, 24), bool)
    pad[1, 17:] = True
    outs = []
    for impl in ("fast", "default"):
        mha = SelfMultiheadAttn(64, 2, bias=True, causal=True, dropout=0.1,
                                impl=impl)
        p = mha.init(torch.Generator().manual_seed(0))
        p = {k: v.requires_grad_(True) for k, v in p.items()}
        out, _ = mha.apply(p, torch.from_numpy(x),
                           attn_mask=torch.from_numpy(mask),
                           key_padding_mask=torch.from_numpy(pad),
                           dropout_seed=-8)
        g = torch.autograd.grad(out.square().sum(),
                                (p["in_proj"], p["out_proj"]))
        outs.append((out, g))
    (o1, g1), (o0, g0) = outs
    torch.testing.assert_close(o1, o0, atol=1e-5, rtol=1e-5)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("impl", ["fast", "default"])
def test_module_dropout_matches_jax_with_its_seed(impl):
    """JAX's module draws its seed from the key (``_dropout_seed``); the
    port takes that int: the same output and input-projection grad, with
    an attn_mask and a key_padding_mask."""
    x, mask = _module_case(2)
    pad = np.zeros((2, 24), bool)
    pad[0, 20:] = True
    jmod = JSelf(64, 2, dropout=0.1, bias=True, impl=impl)
    jp = jmod.init(jax.random.key(3))
    key = jax.random.key(17)
    seed = int(JMOD._dropout_seed(key))

    def jloss(p):
        out, _ = jmod.apply(p, jnp.asarray(x), attn_mask=jnp.asarray(mask),
                            key_padding_mask=jnp.asarray(pad),
                            is_training=True, dropout_key=key)
        return jnp.sum(out ** 2), out

    (_, want), gj = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    out, _ = SelfMultiheadAttn(64, 2, dropout=0.1, bias=True,
                               impl=impl).apply(
        tp, torch.from_numpy(x), attn_mask=torch.from_numpy(mask),
        key_padding_mask=torch.from_numpy(pad), dropout_seed=seed)
    (g,) = torch.autograd.grad(out.square().sum(), tp["in_proj"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj["in_proj"]),
                               atol=1e-4, rtol=1e-5)
