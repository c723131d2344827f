"""Port parity: the Seq2Seq Transformer (encoder-decoder, padded batches,
label-smoothed loss) and the attention modules with key-padding masks.

A tiny f32 model (2 + 2 layers, embed 128, 2 heads of 64, vocab 600,
source length 24, batch 4 with sources of 24, 19, 11 and 6 tokens and the
rest padding), initialised by the JAX package and carried across with
``params_from_jax``; the batch is the translation example's
(``examples/seq2seq/train_translation.py:99-111``: targets are BOS, the
reversed source through a fixed permutation, EOS). Compared: the encoder
memory, the decoder logits, the loss at label smoothing 0.1 and its
gradient with respect to the flat master, at ``attn_impl`` "fast" (the
JAX flash kernels in interpret mode; the port's plain versions on the
CPU) and "default"; the two attention modules alone; greedy decoding,
token for token; three ``FusedAdam`` steps through ``LMTrainer``.
Tolerance: 1e-5 (atol and rtol, f32: the frameworks sum in other orders)
for values and gradients; 1e-4 for the masters after three Adam steps
(Adam divides by sqrt(v), which scales the gradients' rounding up).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import EncdecMultiheadAttn as JEnc
from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JSelf
from apex_tpu.models import Seq2SeqTransformer as JS2S
from apex_tpu.ops import flat as JF
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                   SelfMultiheadAttn)
from apex_tpu_torch.convert import opt_state_from_jax, params_from_jax
from apex_tpu_torch.models import Seq2SeqTransformer
from apex_tpu_torch.train import LMTrainer

CFG = dict(src_vocab_size=600, tgt_vocab_size=600, max_seq_len=32,
           embed_dim=128, num_heads=2, num_encoder_layers=2,
           num_decoder_layers=2)
B, S, LENGTHS = 4, 24, (24, 19, 11, 6)
PAD, BOS, EOS, RESERVED = 0, 1, 2, 3
TOL = dict(atol=1e-5, rtol=1e-5)


def _batch(seed):
    """The translation example's make_batch with fixed lengths."""
    v = CFG["src_vocab_size"]
    perm = np.arange(v)
    perm[RESERVED:] = np.random.RandomState(7).permutation(perm[RESERVED:])
    rs = np.random.RandomState(seed)
    src = np.full((B, S), PAD, np.int32)
    tgt = np.full((B, S + 2), PAD, np.int32)
    for i, n in enumerate(LENGTHS):
        s = rs.randint(RESERVED, v, n)
        src[i, :n] = s
        tgt[i, 0] = BOS
        tgt[i, 1:1 + n] = perm[s[::-1]]
        tgt[i, 1 + n] = EOS
    return src, tgt


_GRADS = {}


def _jax_value_and_grad(impl):
    """Jitted ``value_and_grad`` of the JAX loss over the flat master, one
    compile per impl for the whole module."""
    if impl not in _GRADS:
        jm = JS2S(**CFG, attn_impl=impl)
        jp = jm.init(jax.random.key(0))
        jopt = JAdam(jp, lr=1e-3, betas=(0.9, 0.98), eps=1e-9)
        table = jopt._tables[0]

        @jax.jit
        def vg(master, src, tgt):
            return jax.value_and_grad(lambda m: jm.loss(
                JF.unflatten(m, table), src, tgt, label_smoothing=0.1))(
                    master)

        _GRADS[impl] = (jm, jp, jopt, vg)
    return _GRADS[impl]


def _port(impl, jp):
    tm = Seq2SeqTransformer(**CFG, attn_impl=impl, device="cpu")
    return tm, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_params_from_jax_carries_the_seq2seq_tree():
    """``params_from_jax`` carries the JAX tree as it is (names, shapes,
    values, the ``[in, out]`` layouts), and the port's own ``init`` draws
    the same tree."""
    _, jp, _, _ = _jax_value_and_grad("default")
    tm, tp = _port("default", jp)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        node = tp
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    own = jax.tree.map(lambda t: tuple(t.shape), tm.init(0))
    assert own == jax.tree.map(lambda a: tuple(a.shape), jp)


@pytest.mark.parametrize("impl", ["fast", "default"])
def test_logits_loss_and_flat_grad_match_jax(impl):
    jm, jp, jopt, vg = _jax_value_and_grad(impl)
    tm, tp = _port(impl, jp)
    src, tgt = _batch(0)
    js, jt = jnp.asarray(src), jnp.asarray(tgt)
    mem_j = jm.encode(jp, js)
    logits_j = jm.decode(jp, jt[:, :-1], mem_j, js)
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt)
    mem = tm.encode(tp, ts)
    logits = tm.decode(tp, tt[:, :-1], mem, ts)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(mem.detach().numpy(), np.asarray(mem_j), **TOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               **TOL)
    loss_j, g_j = vg(jopt.init_state()[0].master, js, jt)
    tr = LMTrainer(tm, tp, dtype=None, device="cpu")
    g, loss = tr.loss_and_grad(ts, tt, label_smoothing=0.1)
    np.testing.assert_allclose(float(loss), float(loss_j), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **TOL)
    assert not g[~tr.table.valid_mask()].any()


@pytest.mark.parametrize("module", ["self", "encdec"])
def test_attention_modules_with_key_padding_mask_match_jax(module):
    """Each module alone, ``impl="fast"``, with a key-padding mask whose
    last batch row masks every key: output and input gradients."""
    e, h, tq, tk, b = 128, 2, 9, 13, 3
    rs = np.random.RandomState(11)
    q = rs.randn(tq, b, e).astype(np.float32)
    kv = rs.randn(tk, b, e).astype(np.float32)
    pad = np.arange(tk)[None, :] >= np.array([tk, 5, 0])[:, None]
    ct = rs.randn(tq, b, e).astype(np.float32)
    if module == "self":
        kv, tk = q, tq
        pad = pad[:, :tq]
        jmod = JSelf(e, h, bias=True, impl="fast")
        tmod = SelfMultiheadAttn(e, h, bias=True, impl="fast")
    else:
        jmod = JEnc(e, h, bias=True, impl="fast")
        tmod = EncdecMultiheadAttn(e, h, bias=True, impl="fast")
    jp = jmod.init(jax.random.key(3))
    jp = {n: (a + 0.1 if n.endswith("bias") else a) for n, a in jp.items()}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")

    def jfn(q_, kv_):
        args = (q_,) if module == "self" else (q_, kv_)
        return jmod.apply(jp, *args,
                          key_padding_mask=jnp.asarray(pad))[0]

    want, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(kv))
    dq_j, dkv_j = vjp(jnp.asarray(ct))
    qt = torch.from_numpy(q).requires_grad_(True)
    kvt = qt if module == "self" else \
        torch.from_numpy(kv).requires_grad_(True)
    args = (qt,) if module == "self" else (qt, kvt)
    got, none = tmod.apply(tp, *args, key_padding_mask=torch.from_numpy(pad))
    assert none is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if module == "self":
        (dq,) = torch.autograd.grad(got, qt, torch.from_numpy(ct))
        np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), **TOL)
    else:
        dq, dkv = torch.autograd.grad(got, (qt, kvt), torch.from_numpy(ct))
        np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), **TOL)
        np.testing.assert_allclose(dkv.numpy(), np.asarray(dkv_j), **TOL)
        # the fully padded memory row passes nothing back
        assert not dkv[:, 2].any()


def test_attn_mask_runs_on_the_default_impl_and_raises_on_flash():
    """An ``attn_mask`` (with a key-padding mask) on the default impl
    matches JAX's; the flash path, which refused it until the kernels took
    a full bias, now gives the same output as JAX's flash module."""
    e, h, t, b = 128, 2, 7, 2
    rs = np.random.RandomState(12)
    x = rs.randn(t, b, e).astype(np.float32)
    mask = np.where(rs.rand(t, t) < 0.3, -1.0e4, 0.0).astype(np.float32)
    pad = np.zeros((b, t), bool)
    pad[1, 5:] = True
    jmod = JSelf(e, h, bias=True, impl="default")
    jp = jmod.init(jax.random.key(4))
    want = jmod.apply(jp, jnp.asarray(x), attn_mask=jnp.asarray(mask),
                      key_padding_mask=jnp.asarray(pad))[0]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    got, _ = SelfMultiheadAttn(e, h, bias=True, impl="default").apply(
        tp, torch.from_numpy(x), attn_mask=torch.from_numpy(mask),
        key_padding_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_fast = JSelf(e, h, bias=True, impl="fast").apply(
        jp, jnp.asarray(x), attn_mask=jnp.asarray(mask),
        key_padding_mask=jnp.asarray(pad))[0]
    fast, _ = SelfMultiheadAttn(e, h, bias=True, impl="fast").apply(
        tp, torch.from_numpy(x), attn_mask=torch.from_numpy(mask),
        key_padding_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(fast.numpy(), np.asarray(want_fast), **TOL)
    np.testing.assert_allclose(fast.numpy(), got.numpy(), **TOL)


def test_src_pad_positions_are_inert():
    """The content of padded source positions does not reach the output:
    the key-padding mask covers the encoder's self-attention and the
    decoder's cross-attention (tests/test_seq2seq.py's test, mirrored)."""
    _, jp, _, _ = _jax_value_and_grad("fast")
    tm, tp = _port("fast", jp)
    src, tgt = _batch(1)
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt[:, :-1])
    base = tm.apply(tp, ts, tt)
    poked = dict(tp)
    poked["src_emb"] = tp["src_emb"].clone()
    poked["src_emb"][PAD] = torch.from_numpy(
        np.random.RandomState(9).randn(CFG["embed_dim"]).astype(
            np.float32) * 5)
    torch.testing.assert_close(tm.apply(poked, ts, tt), base, atol=1e-4,
                               rtol=1e-4)


def test_greedy_decode_matches_jax_token_for_token():
    jm, jp, _, _ = _jax_value_and_grad("fast")
    tm, tp = _port("fast", jp)
    src, _ = _batch(2)
    want = np.asarray(jm.greedy_decode(jp, jnp.asarray(src), bos_id=BOS,
                                       eos_id=EOS, max_len=S + 2))
    got = tm.greedy_decode(tp, torch.from_numpy(src), bos_id=BOS,
                           eos_id=EOS, max_len=S + 2)
    assert got.dtype == torch.int32 and got.shape == (B, S + 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got[:, 0] == BOS).all())


def test_three_adam_steps_through_lm_trainer_match_jax():
    """``LMTrainer`` at O0 with the translation step's Adam (betas 0.9,
    0.98; eps 1e-9) and label smoothing 0.1 against the JAX package's
    ``FusedAdam`` over the same flat masters, three steps on one batch.
    Masters whose gradient at some step lies within fp32 rounding of the
    gradient's sums (at most 1e-7 of its largest entry: the key biases,
    whose gradient is zero analytically, and some cross-attention
    projections at init) are bounded apart: Adam with eps 1e-9 turns
    either package's rounding noise there into a move of about lr."""
    jm, jp, jopt, vg = _jax_value_and_grad("fast")
    tm, tp = _port("fast", jp)
    src, tgt = _batch(0)
    state = jopt.init_state()
    tr = LMTrainer(tm, tp, lr=1e-3, betas=(0.9, 0.98), eps=1e-9, dtype=None,
                   device="cpu")
    tr.opt.state = opt_state_from_jax(state, device="cpu")
    losses_j, losses = [], []
    noise = np.zeros(tr.table.total, bool)
    for _ in range(3):
        loss_j, g_j = vg(state[0].master, jnp.asarray(src), jnp.asarray(tgt))
        g_j = np.asarray(g_j)
        noise |= np.abs(g_j) <= 1e-7 * np.abs(g_j).max()
        state = jopt.apply_update(state, [jnp.asarray(g_j)])
        losses_j.append(float(loss_j))
        losses.append(float(tr.step(torch.from_numpy(src),
                                    torch.from_numpy(tgt),
                                    label_smoothing=0.1)))
    np.testing.assert_allclose(losses, losses_j, atol=1e-4, rtol=1e-4)
    assert losses[-1] < losses[0]
    got, want = tr.opt.state[0].master.numpy(), np.asarray(state[0].master)
    np.testing.assert_allclose(got[~noise], want[~noise], atol=1e-4,
                               rtol=1e-4)
    assert np.abs(got[noise] - want[noise]).max() <= 2 * 3 * 1e-3


def test_loss_ignores_pad_targets():
    """More all-pad target columns leave the loss unchanged: the extra
    targets are skipped and the divisor counts only non-pad targets."""
    _, jp, _, _ = _jax_value_and_grad("default")
    tm, tp = _port("fast", jp)
    src, tgt = _batch(3)
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt)
    wide = torch.cat([tt, torch.zeros(B, 4, dtype=tt.dtype)], dim=1)
    torch.testing.assert_close(tm.loss(tp, ts, wide, label_smoothing=0.1),
                               tm.loss(tp, ts, tt, label_smoothing=0.1),
                               **TOL)


def test_unported_options_and_bad_lengths_raise():
    """Beam decoding still raises, as do bad lengths, a wrong count of
    dropout seeds and a remat policy without remat (remat itself runs:
    tests/test_torch_remat.py); dropout itself now runs (its parity:
    ``test_dropout_loss_and_grad_match_jax``)."""
    assert Seq2SeqTransformer(**CFG, remat=True, device="cpu").remat
    with pytest.raises(ValueError, match="remat_policy"):
        Seq2SeqTransformer(**CFG, remat_policy="dots_saveable",
                           device="cpu")
    m = Seq2SeqTransformer(**CFG, dropout=0.1, device="cpu")
    assert m.num_dropout_seeds == 2 + 2 * 2
    with pytest.raises(ValueError, match="dropout_seeds"):
        m.loss(m.init(0), torch.full((1, 4), 5), torch.full((1, 4), 5),
               dropout_seeds=[1, 2])
    m = Seq2SeqTransformer(**CFG, device="cpu")
    p = m.init(0)
    src = torch.full((1, 4), 5)
    with pytest.raises(NotImplementedError, match="item 21"):
        m.beam_decode(p, src, bos_id=BOS, eos_id=EOS)
    with pytest.raises(ValueError, match="max_len"):
        m.greedy_decode(p, src, bos_id=BOS, eos_id=EOS, max_len=33)
    with pytest.raises(ValueError, match="max_seq_len"):
        m.apply(p, torch.full((1, 33), 5), src)


def test_entry_points_default_to_the_card_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Seq2SeqTransformer(**CFG)
    m = Seq2SeqTransformer(**CFG, device="cpu")
    p = m.init(0)
    assert p["src_emb"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMTrainer(m, p)
    loss = LMTrainer(m, p, device="cpu").step(
        *(torch.from_numpy(a) for a in _batch(0)), label_smoothing=0.1)
    assert loss.device.type == "cpu" and bool(torch.isfinite(loss))


def _jax_seq2seq_seeds(key, n_enc: int, n_dec: int) -> list:
    """The seeds JAX's Seq2Seq hands its attention cores: encoder layer i
    folds i into the key; decoder layer i folds n_enc + i, then 0 (self)
    and 1 (cross) (seq2seq.py:149-185)."""
    seed = importlib.import_module(
        "apex_tpu.contrib.multihead_attn.modules")._dropout_seed
    out = [int(seed(jax.random.fold_in(key, i))) for i in range(n_enc)]
    for i in range(n_dec):
        k = jax.random.fold_in(key, n_enc + i)
        out += [int(seed(jax.random.fold_in(k, j))) for j in (0, 1)]
    return out


@pytest.mark.parametrize("impl", ["fast", "default"])
def test_dropout_loss_and_grad_match_jax(impl):
    """Dropout 0.1 in every attention, the seeds JAX derives from its key
    passed to the port: the same loss and flat master gradient."""
    cfg = dict(CFG, attn_impl=impl, dropout=0.1)
    jm = JS2S(**cfg)
    jp = jm.init(jax.random.key(0))
    table = JAdam(jp, lr=1e-3)._tables[0]
    master = JF.flatten(jp, dtype=jnp.float32)[0]
    src, tgt = _batch(5)
    key = jax.random.key(23)
    loss_j, g_j = jax.value_and_grad(lambda m: jm.loss(
        JF.unflatten(m, table), jnp.asarray(src), jnp.asarray(tgt),
        dropout_key=key, label_smoothing=0.1))(master)
    tm = Seq2SeqTransformer(**cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    seeds = _jax_seq2seq_seeds(key, 2, 2)
    tr = LMTrainer(tm, tp, dtype=None, device="cpu")
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt)
    g, loss = tr.loss_and_grad(ts, tt, label_smoothing=0.1,
                               dropout_seeds=seeds)
    np.testing.assert_allclose(float(loss), float(loss_j), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **TOL)
    _, plain = tr.loss_and_grad(ts, tt, label_smoothing=0.1)
    assert float(plain) != float(loss)          # the dropout is live
