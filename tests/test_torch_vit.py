"""Port parity: the ViT of ``examples/imagenet/main_amp.py --arch vit_*``
with attention dropout.

The JAX package's ``vit_tiny`` (2 layers of 64, 4 heads, 32² images in
patches of 4: 65 tokens) with dropout 0.1, converted by
``params_from_jax``; the per-layer dropout seeds are the ones JAX's ViT
derives from its key (``_dropout_seed(fold_in(key, i))``, vit.py:150-156
and modules.py:78-80), computed here and passed to the port. The forward
and the flat master gradient under "fast" (the JAX flash kernels in
interpret mode; the port's plain versions on the CPU) and "default", in
f32: within atol 1e-5 (logits) and 1e-5 + 1e-4 relative (grads), the two
adding in other orders. Then three main_amp ViT steps
(``Trainer(vit, params, optimizer="sgd")``, a uint8 NHWC batch normalized
in the step) against a JAX step body built from main_amp.py's calls
(:239-288, its step key folded per step, :490-497) in O0 and O2, under
tests/test_torch_imagenet.py's bars, and ``evaluate``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.contrib.xentropy import select_label_logits as j_select
from apex_tpu.data import normalize_imagenet as j_normalize
from apex_tpu.models import vit as JV
from apex_tpu.ops import flat as JF
from apex_tpu.optimizers import FusedSGD as JSGD
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import vit as TV
from apex_tpu_torch.ops import flat as TF
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.train import Trainer

JMOD = importlib.import_module("apex_tpu.contrib.multihead_attn.modules")

BATCH, EVAL_BATCH, CLASSES = 4, 8, 10
SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
BASE_KEY = jax.random.key(17)                   # main_amp.py's dropout base


def jax_seeds(key, layers: int) -> list:
    """The per-layer seeds JAX's ViT hands its attention cores."""
    return [int(JMOD._dropout_seed(jax.random.fold_in(key, i)))
            for i in range(layers)]


@pytest.fixture(scope="module")
def setup():
    jm = JV.vit_tiny(num_classes=CLASSES, dropout=0.1)
    params = jax.jit(jm.init)(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    rs = np.random.RandomState(0)
    x = rs.randint(0, 256, (BATCH + EVAL_BATCH, 32, 32, 3), dtype=np.uint8)
    y = rs.randint(0, CLASSES, BATCH + EVAL_BATCH).astype(np.int32)
    return jm, params, tp, x[:BATCH], y[:BATCH], x[BATCH:], y[BATCH:]


def test_analytic_flops_equal_jax():
    for ctor in ("vit_tiny", "vit_small", "vit_b16", "vit_l16"):
        jm, tm = getattr(JV, ctor)(), getattr(TV, ctor)(device="cpu")
        assert TV.analytic_flops(tm) == JV.analytic_flops(jm)
        assert TV.analytic_flops(tm, 384) == JV.analytic_flops(jm, 384)
    # ViT-B/16 at 224²: 197 tokens, 35.13 GFLOP of forward work an image
    b16 = TV.vit_b16(device="cpu")
    assert b16.seq_len == 197
    assert round(TV.analytic_flops(b16) / 1e9, 2) == 35.13


def test_params_and_flat_master_are_jax_bit_for_bit(setup):
    """``params_from_jax`` carries the ViT tree; the port's flat master is
    the JAX package's element for element, and the port's own init has
    the same names and shapes."""
    _, params, tp, *_ = setup
    want = JSGD(params, **SGD).init_state()[0].master
    got = FusedSGD(tp, device="cpu", **SGD).state[0].master
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    own = TV.vit_tiny(num_classes=CLASSES, device="cpu").init(0)
    shapes = jax.tree.map(lambda a: tuple(a.shape), params)
    assert TF.tree_map(lambda t: tuple(t.shape), own) == shapes


def _loss_fn(jm, table, x, y, key, half=jnp.float32):
    def loss(master):
        p = JF.unflatten(master, table, dtype=half)
        logits = jm.apply(p, j_normalize(jnp.asarray(x), dtype=half),
                          is_training=True, dropout_key=key)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(j_select(logp, jnp.asarray(y))), logits
    return loss


@pytest.mark.parametrize("impl", ["fast", "default"])
def test_forward_and_master_grad_match_jax(setup, impl):
    jm0, params, tp, x, y, _, _ = setup
    jm = JV.vit_tiny(num_classes=CLASSES, dropout=0.1, attn_impl=impl)
    key = jax.random.fold_in(BASE_KEY, 3)
    master, table = JF.flatten(params, dtype=jnp.float32)
    (jloss, jlogits), jg = jax.value_and_grad(
        _loss_fn(jm, table, x, y, key), has_aux=True)(master)
    tm = TV.vit_tiny(num_classes=CLASSES, dropout=0.1, attn_impl=impl,
                     device="cpu")
    seeds = jax_seeds(key, jm.num_layers)
    tr = Trainer(tm, tp, opt_level="O0", optimizer="sgd", device="cpu")
    logits = tm.apply(tp, tr._input(torch.from_numpy(x)), is_training=True,
                      dropout_seeds=seeds)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    g, loss, _ = tr.loss_and_grad(torch.from_numpy(x), torch.from_numpy(y),
                                  dropout_seeds=seeds)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-4)
    # dropout is live: without it the logits move
    plain = tm.apply(tp, tr._input(torch.from_numpy(x)), is_training=False)
    assert not torch.allclose(plain, logits, atol=1e-3)


def _jax_run(jm, params, x, y, opt_level, n, ex, ey):
    """main_amp.py:239-288's step (a ViT: no BN state, its key folded per
    step, :490-497) and :401-414's eval_step from the public calls."""
    _, handle = jamp.initialize(opt_level=opt_level, verbosity=0)
    amp_state = handle.init_state()
    half = handle.policy.cast_model_dtype or jnp.float32
    opt = JSGD(params, **SGD)
    table = opt._tables[0]

    @jax.jit
    def grads(master, amp_st, key):
        def loss_fn(m):
            loss, logits = _loss_fn(jm, table, x, y, key, half)(m)
            top = jnp.max(jnp.abs(logits.astype(jnp.float32)))
            return handle.scale_loss(loss, amp_st), (loss, top)
        fg, (loss, top) = jax.grad(loss_fn, has_aux=True)(master)
        fg, found_inf = handle.unscale(fg, amp_st)
        return fg, found_inf, loss, top, handle.update(amp_st, found_inf)

    out = []
    for it in range(n):
        key = jax.random.fold_in(BASE_KEY, it)
        fg, found_inf, loss, top, amp_state = grads(opt.state[0].master,
                                                    amp_state, key)
        opt.step(JF.unflatten(fg, table), found_inf=found_inf)
        out.append((float(loss), np.asarray(opt.state[0].master),
                    jax_seeds(key, jm.num_layers), float(top)))
    p = JF.unflatten(opt.state[0].master, table, dtype=half)
    logits = jm.apply(p, j_normalize(jnp.asarray(ex), dtype=half))
    _, topk = jax.lax.top_k(logits.astype(jnp.float32), 5)
    hit = topk == jnp.asarray(ey)[:, None]
    acc = (float(jnp.mean(hit[:, 0].astype(jnp.float32))),
           float(jnp.mean(jnp.any(hit, -1).astype(jnp.float32))))
    return out, acc


@pytest.fixture(scope="module")
def jax_runs(setup):
    jm, params, _, x, y, ex, ey = setup
    return {lvl: _jax_run(jm, params, x, y, lvl, 3, ex, ey)
            for lvl in ("O0", "O2")}


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_three_main_amp_vit_steps_match_jax(setup, jax_runs, opt_level):
    """The port's Trainer with JAX's per-step, per-layer seeds: O0 losses
    within 1e-5 relative and masters within 1e-4; O2 masters no farther
    from JAX's O2 masters, in mean and in max, than 1.5 times JAX's own O2
    masters are from its O0 ones, the losses within the largest of 5e-3,
    1.5 times bf16's own effect on them and 2 bf16 ulps of the largest
    logit (each step's loss is read from bf16 logits: rounding one moves
    its log-softmax by up to 2 ulps); then ``evaluate``."""
    _, _, tp, x, y, ex, ey = setup
    want, want_acc = jax_runs[opt_level]
    tm = TV.vit_tiny(num_classes=CLASSES, dropout=0.1, device="cpu")
    tr = Trainer(tm, tp, opt_level=opt_level, optimizer="sgd", device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for i, (wloss, wmaster, seeds, top) in enumerate(want):
        loss = tr.step(xt, yt, dropout_seeds=seeds)
        master = tr.opt.state[0].master.numpy()
        if opt_level == "O0":
            assert abs(float(loss) - wloss) <= 1e-5 * abs(wloss)
            np.testing.assert_allclose(master, wmaster, rtol=0, atol=1e-4)
        else:
            o0_loss, o0_master, _, _ = jax_runs["O0"][0][i]
            ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
            assert abs(float(loss) - wloss) <= max(
                5e-3, 1.5 * abs(wloss - o0_loss), 2 * ulp), (
                    i, float(loss), wloss, ulp)
            err = np.abs(master - wmaster)
            bf16 = np.abs(wmaster - o0_master)
            assert err.mean() <= 1.5 * bf16.mean(), (i, err.mean(),
                                                     bf16.mean())
            assert err.max() <= 1.5 * bf16.max(), (i, err.max(), bf16.max())
    top1, top5 = tr.evaluate(torch.from_numpy(ex), torch.from_numpy(ey))
    assert top1.dim() == top5.dim() == 0 and 0 <= top1 <= top5 <= 1
    if opt_level == "O0":                  # f32: the same top-k, image for
        assert (float(top1), float(top5)) == want_acc       # image


def test_trainer_draws_seeds_from_its_generator(setup):
    """Without given seeds each step draws one per layer from the
    Trainer's generator: two trainers with equal generators take equal
    steps, another generator another; a model without dropout draws
    none, and ``evaluate`` runs without dropout."""
    _, _, tp, x, y, _, _ = setup
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tm = TV.vit_tiny(num_classes=CLASSES, dropout=0.1, device="cpu")

    def run(seed):
        tr = Trainer(tm, tp, opt_level="O0", optimizer="sgd", device="cpu",
                     generator=torch.Generator().manual_seed(seed))
        return [float(tr.step(xt, yt)) for _ in range(2)], tr

    a, tra = run(1)
    b, _ = run(1)
    c, _ = run(2)
    assert a == b and a != c
    assert len(tra.draw_dropout_seeds()) == tm.num_layers
    quiet = Trainer(TV.vit_tiny(num_classes=CLASSES, device="cpu"), tp,
                    device="cpu")
    assert quiet.draw_dropout_seeds() is None and quiet.bn_state == {}
    e1 = tra.evaluate(xt, yt)
    assert e1 == tra.evaluate(xt, yt)


def test_vit_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="patch_size"):
        TV.ViT(num_classes=10, image_size=30, patch_size=4, device="cpu")
    with pytest.raises(ValueError, match="pool"):
        TV.vit_tiny(pool="max", device="cpu")
    assert TV.vit_tiny(remat=True, device="cpu").remat   # ported
    with pytest.raises(ValueError, match="remat_policy"):
        TV.vit_tiny(remat_policy="dots_saveable", device="cpu")
    m = TV.vit_tiny(device="cpu")
    p = m.init(0)
    with pytest.raises(ValueError, match="image_size"):
        m.apply(p, torch.zeros(1, 16, 16, 3))
    with pytest.raises(ValueError, match="dropout_seeds"):
        m.apply(p, torch.zeros(1, 32, 32, 3), dropout_seeds=[1])
    mean = TV.vit_tiny(pool="mean", device="cpu")
    assert mean.apply(p, torch.zeros(2, 32, 32, 3)).shape == (2, 10)
