"""Port parity: the decoder-LM training step of ``tools/lm_bench.py``.

A tiny LM (2 layers, embed 64, 4 heads, vocab 256, S 33, batch 2, f32,
``attn_impl="fast"``, ``head_chunk=64``), initialised by the JAX package
and carried across with ``params_from_jax``; the optimizer state with
``opt_state_from_jax``, so both packages start from the same flat
masters. Compared: the loss and the gradient with respect to the flat
master (JAX: ``value_and_grad(lm.loss ∘ unflatten)``, its flash kernels in
interpret mode; the port: ``LMTrainer.loss_and_grad``, the plain versions
of its kernels on the CPU), then the masters after three ``FusedAdam``
steps, and ``linear_cross_entropy`` with label smoothing and a padding
index; and the full-logits loss (``head_chunk=0``), which goes through
the softmax cross-entropy op in both packages. Tolerance 1e-5 (f32; the
frameworks sum in other orders).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.xentropy import linear_cross_entropy as j_lxe
from apex_tpu.models import TransformerLM as JLM
from apex_tpu.ops import flat as JF
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu_torch.contrib.xentropy import linear_cross_entropy
from apex_tpu_torch.convert import opt_state_from_jax, params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM
from apex_tpu_torch.train import LMTrainer

CFG = dict(vocab_size=256, max_seq_len=64, embed_dim=64, num_heads=4,
           num_layers=2, attn_impl="fast", head_chunk=64)
B, S = 2, 33
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jm = JLM(**CFG)
    jp = jm.init(jax.random.key(0))
    jopt = JAdam(jp, lr=1e-3)
    tm = TLM(**CFG, device="cpu")
    tr = LMTrainer(tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu"),
                   lr=1e-3, dtype=None, device="cpu")
    tr.opt.state = opt_state_from_jax(jopt.init_state(), device="cpu")
    toks = np.random.RandomState(1).randint(0, 256, (B, S)).astype(np.int32)
    return jm, jopt, tr, toks


def test_flat_layouts_and_masters_agree(setup):
    _, jopt, tr, _ = setup
    jt = jopt._tables[0]
    assert jt.total == tr.table.total and jt.offsets == tr.table.offsets
    fresh = LMTrainer(tr.model, tr.opt.params_tree(), dtype=None,
                      device="cpu")
    assert torch.equal(fresh.opt.state[0].master, tr.opt.state[0].master)


def test_loss_and_flat_grad_match_jax(setup):
    jm, jopt, tr, toks = setup
    table = jopt._tables[0]
    master = jopt.init_state()[0].master
    loss_j, g_j = jax.value_and_grad(
        lambda m: jm.loss(JF.unflatten(m, table), jnp.asarray(toks)))(master)
    g, loss = tr.loss_and_grad(torch.from_numpy(toks))
    assert g.dtype == torch.float32 and g.shape == (table.total,)
    np.testing.assert_allclose(float(loss), float(loss_j), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **TOL)
    # the padding of the flat store gets no gradient
    assert not g[~tr.table.valid_mask()].any()


def _key_bias_mask(tr):
    """The flat positions of every layer's key bias (in_proj_bias[E:2E]):
    its gradient is zero analytically (softmax is shift-invariant along a
    row), so both packages hold rounding noise there, which Adam's first
    steps scale up to about lr each."""
    from apex_tpu_torch.ops import flat
    tree = flat.tree_map(torch.zeros_like, tr.opt.params_tree())
    e = CFG["embed_dim"]
    for i in range(CFG["num_layers"]):
        tree[f"layer_{i}"]["attn"]["in_proj_bias"][e:2 * e] = 1.0
    return flat.flatten(tree, table=tr.table)[0] > 0


def test_three_fused_adam_steps_match_jax(setup):
    jm, jopt, tr, toks = setup
    table = jopt._tables[0]
    state = jopt.init_state()
    tr = LMTrainer(tr.model, tr.opt.params_tree(), lr=1e-3, dtype=None,
                   device="cpu")
    tr.opt.state = opt_state_from_jax(state, device="cpu")
    losses_j, losses = [], []
    for _ in range(3):
        loss_j, g_j = jax.value_and_grad(
            lambda m: jm.loss(JF.unflatten(m, table), jnp.asarray(toks)))(
                state[0].master)
        state = jopt.apply_update(state, [g_j])
        losses_j.append(float(loss_j))
        losses.append(float(tr.step(torch.from_numpy(toks))))
    np.testing.assert_allclose(losses, losses_j, **TOL)
    assert losses[-1] < losses[0]
    gs = tr.opt.state[0]
    assert int(gs.step) == 3
    kb = _key_bias_mask(tr).numpy()
    got, want = gs.master.numpy(), np.asarray(state[0].master)
    np.testing.assert_allclose(got[~kb], want[~kb], **TOL)
    assert np.abs(got[kb] - want[kb]).max() <= 2 * 3 * 1e-3


def test_bf16_master_step_stays_fp32_and_close_to_f32(setup):
    """The O2 pattern: one cast of the fp32 master to bf16 inside the
    loss, the gradient back in fp32; the loss within bf16's reach of the
    f32 loss."""
    _, _, tr, toks = setup
    o2 = LMTrainer(tr.model, tr.opt.params_tree(), dtype=torch.bfloat16,
                   device="cpu")
    g, loss = o2.loss_and_grad(torch.from_numpy(toks))
    g32, loss32 = tr.loss_and_grad(torch.from_numpy(toks))
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert abs(float(loss) - float(loss32)) < 2e-2
    cos = torch.nn.functional.cosine_similarity(g, g32, dim=0)
    assert float(cos) > 0.99


@pytest.mark.parametrize("smoothing,padding_idx", [(0.0, None), (0.1, 3)])
def test_linear_cross_entropy_matches_jax(smoothing, padding_idx):
    rs = np.random.RandomState(4)
    n, d, v = 37, 32, 256
    h = rs.randn(n, d).astype(np.float32)
    w = (rs.randn(v, d) * 0.3).astype(np.float32)
    lab = rs.randint(0, v, n).astype(np.int32)
    lab[::5] = 3                                 # some rows are padding
    ct = rs.randn(n).astype(np.float32)
    kw = dict(smoothing=smoothing, padding_idx=padding_idx, chunk=64)
    want, vjp = jax.vjp(lambda a, b: j_lxe(a, b, jnp.asarray(lab), **kw),
                        jnp.asarray(h), jnp.asarray(w))
    dh_j, dw_j = vjp(jnp.asarray(ct))
    ht, wt = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    got = linear_cross_entropy(ht, wt, torch.from_numpy(lab), **kw)
    dh, dw = torch.autograd.grad(got, (ht, wt), torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dh_j), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **TOL)
    if padding_idx is not None:
        pad = lab == padding_idx
        assert not got[torch.from_numpy(pad)].any()
        assert not dh[torch.from_numpy(pad)].any()


def test_full_logits_loss_and_grad_match_jax(setup):
    """``head_chunk=0``: the loss over the full fp32 logits through
    ``SoftmaxCrossEntropyLoss`` with no padding index, and its gradient
    with respect to the flat master."""
    _, jopt, tr, toks = setup
    cfg = {**CFG, "head_chunk": 0}
    jm = JLM(**cfg)
    table = jopt._tables[0]
    loss_j, g_j = jax.value_and_grad(
        lambda m: jm.loss(JF.unflatten(m, table), jnp.asarray(toks)))(
            jopt.init_state()[0].master)
    full = LMTrainer(TLM(**cfg, device="cpu"), tr.opt.params_tree(),
                     dtype=None, device="cpu")
    g, loss = full.loss_and_grad(torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(loss_j), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **TOL)


def test_unported_options_raise():
    """``head_chunk`` and the chunk still refuse bad widths, and a wrong
    count of dropout seeds raises; dropout, refused until the kernels took
    it, now runs (its parity: ``test_dropout_loss_and_grad_match_jax``)."""
    m = TLM(**{**CFG, "dropout": 0.1}, device="cpu")
    with pytest.raises(ValueError, match="dropout_seeds"):
        m.loss(m.init(0), torch.zeros(1, 5, dtype=torch.long),
               dropout_seeds=[1])
    with pytest.raises(ValueError, match="head_chunk"):
        TLM(**{**CFG, "head_chunk": 100}, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        linear_cross_entropy(torch.zeros(2, 4), torch.zeros(6, 4),
                             torch.zeros(2, dtype=torch.long), chunk=4)


@pytest.mark.parametrize("impl", ["fast", "default"])
def test_dropout_loss_and_grad_match_jax(impl):
    """Dropout 0.1 with the seeds JAX's LM derives from its key (layer i
    folds i, transformer.py:189-193; ``_dropout_seed``) passed to the
    port: the same loss and flat master gradient."""
    seed_of = importlib.import_module(
        "apex_tpu.contrib.multihead_attn.modules")._dropout_seed
    cfg = {**CFG, "dropout": 0.1, "attn_impl": impl}
    jm = JLM(**cfg)
    jp = jm.init(jax.random.key(0))
    table = JAdam(jp, lr=1e-3)._tables[0]
    master = JF.flatten(jp, dtype=jnp.float32)[0]
    toks = np.random.RandomState(2).randint(0, 256, (B, S)).astype(np.int32)
    key = jax.random.key(31)
    loss_j, g_j = jax.value_and_grad(lambda m: jm.loss(
        JF.unflatten(m, table), jnp.asarray(toks), dropout_key=key))(master)
    seeds = [int(seed_of(jax.random.fold_in(key, i)))
             for i in range(cfg["num_layers"])]
    tr = LMTrainer(TLM(**cfg, device="cpu"),
                   params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu"), dtype=None, device="cpu")
    g, loss = tr.loss_and_grad(torch.from_numpy(toks), dropout_seeds=seeds)
    np.testing.assert_allclose(float(loss), float(loss_j), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **TOL)
    _, plain = tr.loss_and_grad(torch.from_numpy(toks))
    assert float(plain) != float(loss)          # the dropout is live
