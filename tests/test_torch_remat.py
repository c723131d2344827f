"""Port parity: rematerialization (``models/_remat.py``) in the
TransformerLM, the ViT and the Seq2Seq Transformer.

Each of the four ``jax.checkpoint_policies`` names (and None) in each
model, in fp32 and under O1 (``amp.autocast``), with attention dropout
on: the loss and every gradient bit for bit those of the same port model
without remat, since the recompute runs the same ops on the same inputs
and dropout is a hash of the seeds. The forward kernels inside a block
(LayerNorm and flash forwards, counted at their wrappers) run twice a
block under every policy but ``everything_saveable``, once outside them.
Against the JAX model with the same remat policy on the same weights
(dropout off, fp32, the plain attention): the loss and the gradients
within 1e-5. And ``validate_remat_config``'s refusals: the same messages
as JAX's, from all three constructors.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import Seq2SeqTransformer as JS2S
from apex_tpu.models import TransformerLM as JLM
from apex_tpu.models import ViT as JViT
from apex_tpu.models import _remat as jremat
from apex_tpu_torch import amp
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import Seq2SeqTransformer, TransformerLM, ViT
from apex_tpu_torch.models import _remat
from apex_tpu_torch.ops import flat as TF

POLICIES = [None, *_remat.REMAT_POLICIES]
TOL = dict(rtol=1e-5, atol=1e-5)

# (port class, JAX class, config, batch of numpy ints / floats, the loss's
# dropout seeds: one a layer, the Seq2Seq's one an encoder layer and two a
# decoder layer)
LM_CFG = dict(vocab_size=64, max_seq_len=32, embed_dim=32, num_heads=2,
              num_layers=2, attn_impl="fast")
VIT_CFG = dict(num_classes=5, image_size=8, patch_size=4, embed_dim=32,
               num_heads=2, num_layers=2, attn_impl="fast")
S2S_CFG = dict(src_vocab_size=40, tgt_vocab_size=40, max_seq_len=16,
               embed_dim=32, num_heads=2, num_encoder_layers=2,
               num_decoder_layers=1, attn_impl="fast")


def _case(name):
    rs = np.random.RandomState(0)
    if name == "lm":
        return (TransformerLM, JLM, LM_CFG,
                (rs.randint(0, 64, (2, 17)),), [11, 12])
    if name == "vit":
        return (ViT, JViT, VIT_CFG,
                (rs.randn(2, 8, 8, 3).astype(np.float32),
                 rs.randint(0, 5, 2)), [21, 22])
    src = rs.randint(3, 40, (2, 9))
    src[1, 6:] = 0                                  # padded source
    tgt = rs.randint(3, 40, (2, 8))
    return Seq2SeqTransformer, JS2S, S2S_CFG, (src, tgt), [1, 2, 3, 4]


def _vit_loss(model, params, x, y, **kw):
    logits = model.apply(params, x, is_training=True, **kw)
    return -torch.mean(torch.log_softmax(logits, -1)[
        torch.arange(y.shape[0]), y.long()])


def _j_vit_loss(model, params, x, y):
    logits = model.apply(params, x, is_training=True)
    return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(y.shape[0]), y])


def _port_loss(name, model, params, batch, seeds, o1):
    batch = [torch.from_numpy(b) for b in batch]
    if name == "vit":
        fn = lambda p, x, y, **kw: _vit_loss(model, p, x, y, **kw)  # noqa
    else:
        fn = model.loss
    if o1:
        fn = amp.autocast(fn)
    return fn(params, *batch, dropout_seeds=seeds)


def _loss_and_grads(name, model, params, batch, seeds, o1):
    p = TF.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = _port_loss(name, model, p, batch, seeds, o1)
    return loss, torch.autograd.grad(loss, TF.tree_leaves(p))


@pytest.fixture(scope="module")
def inits():
    out = {}
    for name in ("lm", "vit", "s2s"):
        _, jcls, cfg, _, _ = _case(name)
        jp = jcls(**cfg).init(jax.random.key(0))
        out[name] = jax.tree.map(np.asarray, jp)
    return out


@pytest.mark.parametrize("o1", [False, True], ids=["fp32", "O1"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["lm", "vit", "s2s"])
def test_remat_leaves_loss_and_grads_unchanged(inits, name, policy, o1,
                                               monkeypatch):
    cls, _, cfg, batch, seeds = _case(name)
    cfg = dict(cfg, dropout=0.1)
    params = params_from_jax(inits[name], device="cpu")
    plain = cls(**cfg, device="cpu")
    rem = cls(**cfg, remat=True, remat_policy=policy, device="cpu")
    want = _loss_and_grads(name, plain, params, batch, seeds, o1)
    # count the forward kernels' wrappers in the remat run
    from apex_tpu_torch.ops import flash_attn as FA
    LN = sys.modules["apex_tpu_torch.normalization.fused_layer_norm"]
    calls = {"ln_fwd": 0, "flash_fwd": 0}
    for mod, fn in ((LN, "ln_fwd"), (FA, "flash_fwd")):
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _fn=fn, **k):
            calls[_fn] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, spy)
    got = _loss_and_grads(name, rem, params, batch, seeds, o1)
    assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
    # the forward kernels inside the blocks and outside them: the LM's and
    # the ViT's layers 2 LayerNorms and an attention each, then the final
    # LayerNorm; the Seq2Seq encoder's as many, its decoder layer 3 and 2
    # (self- and cross-attention), then the encoder's and decoder's final
    ln_in, fa_in, ln_out = {"lm": (4, 2, 1), "vit": (4, 2, 1),
                            "s2s": (7, 4, 2)}[name]
    twice = 1 if policy == "everything_saveable" else 2
    assert calls == {"ln_fwd": twice * ln_in + ln_out,
                     "flash_fwd": twice * fa_in}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["lm", "vit", "s2s"])
def test_remat_matches_jax(inits, name, policy):
    cls, jcls, cfg, batch, _ = _case(name)
    # the plain attention on both sides: JAX's flash kernel would run in
    # interpret mode, and remat does not depend on the attention's form
    cfg = dict(cfg, attn_impl="default")
    model = cls(**cfg, remat=True, remat_policy=policy, device="cpu")
    jmodel = jcls(**cfg, remat=True, remat_policy=policy)
    jp = jax.tree.map(jnp.asarray, inits[name])
    jb = [jnp.asarray(b) for b in batch]
    if name == "vit":
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: _j_vit_loss(jmodel, p, *jb)))(jp)
    else:
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, *jb)))(jp)
    loss, grads = _loss_and_grads(name, model, params_from_jax(
        inits[name], device="cpu"), batch, None, False)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for a, b in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("remat,policy", [(False, "dots_saveable"),
                                          (True, "save_anything"),
                                          (False, "no_such_policy")])
@pytest.mark.parametrize("name", ["lm", "vit", "s2s"])
def test_remat_config_refusals_match_jax(name, remat, policy):
    cls, jcls, cfg, _, _ = _case(name)
    with pytest.raises(ValueError) as want:
        jremat.validate_remat_config(remat, policy)
    with pytest.raises(ValueError) as got:
        _remat.validate_remat_config(remat, policy)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as jm:
        jcls(**cfg, remat=remat, remat_policy=policy)
    with pytest.raises(ValueError) as tm:
        cls(**cfg, remat=remat, remat_policy=policy, device="cpu")
    assert str(tm.value) == str(jm.value) == str(want.value)
    assert _remat.REMAT_POLICIES == jremat.REMAT_POLICIES
