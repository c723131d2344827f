"""Port parity: ``examples/imagenet/main_amp.py``'s training and validation
steps on the CI ResNet.

``bench.py:1248``'s CI model (``ResNet(block_sizes=(1, 1),
bottleneck=True, num_classes=10, width=8)``, batch 4), converted from the
JAX package's init, takes a uint8 NHWC batch center-cropped from a larger
pool (as main_amp.py:367-370 crops its hold-out) and normalized inside
the step. The port's ``Trainer(optimizer="sgd")`` — main_amp's
FusedSGD(lr 0.1, momentum 0.9, weight decay 1e-4) — and one LARC and one
FusedNovoGrad case run three steps against a JAX step built from the same
public calls as main_amp.py:239-288 (``normalize_imagenet``,
``unflatten``, ``apply``, ``log_softmax``, ``select_label_logits``, the
AMP handle, the optimizer), in O0 (f32), O1 and O2 (bf16); ``evaluate``
against main_amp.py:401-414's ``eval_step``. main_amp at ``--opt-level
O1`` casts no model and applies it without ``amp.autocast``, so its step
is fp32 with the O1 preset's loss scale, and O1 is held to O0's bars.

Bars, those of tests/test_torch_resnet.py: O0 losses within 1e-5
relative and masters within 1e-4; O2 masters no farther from JAX's O2
masters, in mean and in max, than 1.5 times JAX's own O2 masters are from
its O0 masters (bf16 convolutions round at other places in the two
frameworks); the losses within 5e-3, or within 1.5 times bf16's own
effect on the loss (JAX's O2 loss against its O0 loss) where that is
larger: at lr 0.1 a bf16 rounding moves the next loss by more than LAMB's
lr 1e-3 does in tests/test_torch_resnet.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.contrib.xentropy import select_label_logits as j_select
from apex_tpu.data import normalize_imagenet as j_normalize
from apex_tpu.models import ResNet as JResNet
from apex_tpu.ops import flat as JF
from apex_tpu.optimizers import LARC as JLARC
from apex_tpu.optimizers import FusedNovoGrad as JNovoGrad
from apex_tpu.optimizers import FusedSGD as JSGD
from apex_tpu_torch.convert import resnet_from_jax
from apex_tpu_torch.data import normalize_imagenet
from apex_tpu_torch.models import ResNet
from apex_tpu_torch.train import Trainer

CI = dict(block_sizes=(1, 1), bottleneck=True, num_classes=10, width=8)
BATCH, EVAL_BATCH, IMAGE, POOL = 4, 16, 32, 40

# (JAX optimizer, its keywords, LARC on top, the port Trainer's keywords)
CASES = {
    "sgd": (JSGD, dict(lr=0.1, momentum=0.9, weight_decay=1e-4), False,
            dict(optimizer="sgd")),
    "larc_sgd": (JSGD, dict(lr=0.1, momentum=0.9, weight_decay=1e-4), True,
                 dict(optimizer="sgd", larc=True)),
    "novograd": (JNovoGrad, dict(lr=1e-2), False,
                 dict(optimizer="novograd", lr=1e-2)),
}


@pytest.fixture(scope="module")
def setup():
    jm = JResNet(**CI)
    params, state = jax.jit(jm.init)(jax.random.key(0))
    tm = ResNet(**CI, device="cpu")
    tp, ts = resnet_from_jax(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), device="cpu")
    rs = np.random.RandomState(0)
    pool = rs.randint(0, 256, (BATCH + EVAL_BATCH, POOL, POOL, 3),
                      dtype=np.uint8)
    off = (POOL - IMAGE) // 2
    crops = np.ascontiguousarray(pool[:, off:off + IMAGE, off:off + IMAGE])
    y = rs.randint(0, CI["num_classes"], BATCH + EVAL_BATCH).astype(np.int32)
    return (jm, params, state, tm, tp, ts, crops[:BATCH], y[:BATCH],
            crops[BATCH:], y[BATCH:])


def _jax_run(jm, params, state, x, y, opt_level, case, n, eval_x, eval_y):
    """main_amp.py:239-288's step and :401-414's eval_step from the public
    calls; the update through the optimizer's (or LARC's) ``step``."""
    jcls, kw, larc, _ = CASES[case]
    _, handle = jamp.initialize(opt_level=opt_level, verbosity=0)
    amp_state = handle.init_state()
    cast = handle.policy.cast_model_dtype
    half = cast or jnp.float32
    opt = jcls(params, **kw)
    driver = JLARC(opt) if larc else opt
    table = opt._tables[0]
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def unflat(master):
        return JF.unflatten(master, table, dtype=half) if cast is not None \
            else JF.unflatten(master, table)

    def loss_fn(master, bn, amp_st):
        xn = j_normalize(xj, dtype=half)
        logits, new_bn = jm.apply(unflat(master), bn, xn, training=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        loss = -jnp.mean(j_select(logp, yj))
        return handle.scale_loss(loss, amp_st), (loss, new_bn)

    @jax.jit
    def grads(master, bn, amp_st):
        fg, (loss, new_bn) = jax.grad(loss_fn, has_aux=True)(master, bn,
                                                             amp_st)
        fg, found_inf = handle.unscale(fg, amp_st)
        return fg, found_inf, loss, new_bn, handle.update(amp_st, found_inf)

    @jax.jit
    def eval_step(master, bn, ex, ey):
        logits, _ = jm.apply(unflat(master), bn, j_normalize(ex, dtype=half),
                             training=False)
        _, topk = jax.lax.top_k(logits.astype(jnp.float32), 5)
        hit = topk == ey[:, None]
        return (jnp.mean(hit[:, 0].astype(jnp.float32)),
                jnp.mean(jnp.any(hit, -1).astype(jnp.float32)))

    out = []
    for _ in range(n):
        fg, found_inf, loss, state, amp_state = grads(
            opt.state[0].master, state, amp_state)
        driver.step(JF.unflatten(fg, table), found_inf=found_inf)
        out.append((float(loss), np.asarray(opt.state[0].master),
                    int(opt.state[0].step)))
    acc = eval_step(opt.state[0].master, state, jnp.asarray(eval_x),
                    jnp.asarray(eval_y))
    return out, tuple(float(a) for a in acc)


@pytest.fixture(scope="module")
def jax_runs(setup):
    jm, params, state, _, _, _, x, y, ex, ey = setup
    return {(case, lvl): _jax_run(jm, params, state, x, y, lvl, case, 3,
                                  ex, ey)
            for case in CASES for lvl in ("O0", "O1", "O2")}


@pytest.mark.parametrize("opt_level", ["O0", "O1", "O2"])
@pytest.mark.parametrize("case", list(CASES))
def test_three_main_amp_steps_match_jax(setup, jax_runs, case, opt_level):
    _, _, _, tm, tp, ts, x, y, ex, ey = setup
    want, want_acc = jax_runs[(case, opt_level)]
    tr = Trainer(tm, tp, ts, opt_level=opt_level, device="cpu",
                 **CASES[case][3])
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    assert xt.dtype == torch.uint8 and xt.shape == (BATCH, IMAGE, IMAGE, 3)
    assert tr.handle.policy.autocast == (opt_level == "O1")
    if opt_level == "O1":
        assert tr.half == torch.float32
    for i, (wloss, wmaster, wstep) in enumerate(want):
        loss = tr.step(xt, yt)
        master = tr.opt.state[0].master.numpy()
        assert int(tr.opt.state[0].step) == wstep == i + 1
        if opt_level in ("O0", "O1"):
            assert abs(float(loss) - wloss) <= 1e-5 * abs(wloss)
            np.testing.assert_allclose(master, wmaster, rtol=0, atol=1e-4)
        else:
            o0_loss, o0_master, _ = jax_runs[(case, "O0")][0][i]
            assert abs(float(loss) - wloss) <= max(
                5e-3, 1.5 * abs(wloss - o0_loss)), (i, float(loss), wloss,
                                                   o0_loss)
            err = np.abs(master - wmaster)
            bf16 = np.abs(wmaster - o0_master)
            assert err.mean() <= 1.5 * bf16.mean(), (i, err.mean(),
                                                     bf16.mean())
            assert err.max() <= 1.5 * bf16.max(), (i, err.max(), bf16.max())
    assert float(loss) < want[0][0]                  # it learns
    top1, top5 = tr.evaluate(torch.from_numpy(ex), torch.from_numpy(ey))
    assert top1.dim() == top5.dim() == 0 and 0 <= top1 <= top5 <= 1
    if opt_level != "O2":                  # f32: the same top-k, image for
        assert (float(top1), float(top5)) == want_acc       # image


def test_normalize_imagenet_matches_jax_bit_for_bit():
    x = np.random.RandomState(1).randint(0, 256, (2, 5, 7, 3),
                                         dtype=np.uint8)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        got = normalize_imagenet(torch.from_numpy(x), dtype=tdt)
        want = j_normalize(jnp.asarray(x), dtype=jdt)
        assert got.dtype == tdt and got.shape == x.shape
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_uint8_batch_is_the_normalized_float_batch(setup):
    """A uint8 NHWC batch is normalized in the step; the same batch
    normalized beforehand and given as NCHW floats takes the same step."""
    _, _, _, tm, tp, ts, x, y, _, _ = setup
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    a = Trainer(tm, tp, ts, opt_level="O0", optimizer="sgd", device="cpu")
    b = Trainer(tm, tp, ts, opt_level="O0", optimizer="sgd", device="cpu")
    la = a.step(xt, yt)
    lb = b.step(normalize_imagenet(xt).permute(0, 3, 1, 2), yt)
    assert float(la) == float(lb)
    assert torch.equal(a.opt.state[0].master, b.opt.state[0].master)


def test_trainer_optimizer_choice(setup):
    _, _, _, tm, tp, ts, _, _, _, _ = setup
    tr = Trainer(tm, tp, ts, optimizer="sgd", device="cpu")
    hp = tr.opt.param_groups[0]
    assert (hp["lr"], hp["momentum"], hp["weight_decay"]) == (0.1, 0.9,
                                                              1e-4)
    tr = Trainer(tm, tp, ts, device="cpu")           # bench.py's FusedLAMB
    assert type(tr.opt).__name__ == "FusedLAMB"
    assert tr.opt.param_groups[0]["lr"] == 1e-3
    tr = Trainer(tm, tp, ts, optimizer="novograd", larc=True, norm_type=0,
                 device="cpu")
    assert type(tr.opt).__name__ == "LARC"
    assert tr.opt.param_groups[0]["norm_type"] == 0
    tr = Trainer(tm, tp, ts, optimizer="sgd", lr=0.05, momentum=0.5,
                 weight_decay=0.0, device="cpu")       # main_amp's flags
    hp = tr.opt.param_groups[0]
    assert (hp["lr"], hp["momentum"], hp["weight_decay"]) == (0.05, 0.5, 0.0)
    with pytest.raises(TypeError, match="momentum"):  # LAMB has none
        Trainer(tm, tp, ts, momentum=0.9, device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        Trainer(tm, tp, ts, optimizer="adagrad", device="cpu")


def test_full_size_resnet50_grad_is_within_jax_own_sensitivity():
    """Why the parity bars stay on the CI model: at random init the full
    ResNet-50's flat grad (batch 8, 32², uint8 input, O0) is
    ill-conditioned. A 1e-7 relative perturbation of the masters moves the
    JAX package's own grad by more than 1%; the port's grad, whose
    convolutions add in another order, is no farther from JAX's than
    twice that and than 6%, while the losses agree to 1e-5.
    At 32² the last stage's maps are 1×1, so this size does not speak for
    the 224² step; chip_smoke.py's imagenet_train holds that step against
    its plain versions on the card instead."""
    from apex_tpu.models import resnet50 as j_resnet50
    from apex_tpu_torch.models import resnet50
    jm = j_resnet50()
    params, state = jax.jit(jm.init)(jax.random.key(0))
    rs = np.random.RandomState(0)
    x = rs.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    y = rs.randint(0, 1000, 8).astype(np.int32)
    master, table = JF.flatten(params, dtype=jnp.float32)

    def loss_fn(m):
        logits, _ = jm.apply(JF.unflatten(m, table), state,
                             j_normalize(jnp.asarray(x)), training=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(j_select(logp, jnp.asarray(y)))

    grad = jax.jit(jax.value_and_grad(loss_fn))
    jloss, jg = grad(master)
    noise = 1 + 1e-7 * np.random.RandomState(1).randn(
        master.shape[0]).astype(np.float32)
    jg, jg2 = np.asarray(jg), np.asarray(grad(master * noise)[1])
    tp, ts = resnet_from_jax(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), device="cpu")
    tr = Trainer(resnet50(device="cpu"), tp, ts, opt_level="O0",
                 optimizer="sgd", device="cpu")
    tg, tloss, _ = tr.loss_and_grad(torch.from_numpy(x), torch.from_numpy(y))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    own = rel(jg2, jg)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert own > 1e-2, own                  # 1 ulp moves the grad by > 1%
    assert rel(tg.numpy(), jg) <= min(2 * own, 0.06), (rel(tg.numpy(), jg),
                                                        own)
