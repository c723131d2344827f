"""Port parity: ResNet and the AMP FusedLAMB training step.

``bench.py:1248``'s CI model (``ResNet(block_sizes=(1, 1),
bottleneck=True, num_classes=10, width=8)``, image 32, batch 4; its
stage 1 opens with a stride-2 bottleneck, so a SAME padding that is
symmetric where XLA's is not shows) converted from the JAX package's
init: logits and new BN state against JAX's f32 ``apply``; the flat
master grad against ``jax.grad`` of bench.py's ``_loss_fn``; three full
train steps of the port's ``Trainer`` against a JAX ``train_step`` built
from the same public calls as bench.py:1278-1306, in O0 (f32) and O2
(bf16); ``analytic_flops``.

Tolerances. f32: logits and BN state 1e-4, the flat grad 1e-4 of its
largest entry (convolutions sum in another order). O0 steps: masters
1e-4, losses 1e-5 relative. O2 steps: bf16 convolutions round their
outputs at other places in the two frameworks, and LAMB's first steps
move each weight by about ``lr`` times the sign of its gradient, so a
small gradient that rounds differently moves its weight differently.
The bar is the size of bf16's own effect: the port's O2 masters may be
no farther from JAX's O2 masters, in mean and in max, than 1.5 times
JAX's own O2 masters are from its O0 masters; losses within 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.contrib.xentropy import select_label_logits as j_select
from apex_tpu.models import ResNet as JResNet
from apex_tpu.models import resnet50 as j_resnet50
from apex_tpu.models.resnet import analytic_flops as j_flops
from apex_tpu.ops import flat as JF
from apex_tpu.optimizers import FusedLAMB as JLAMB
from apex_tpu_torch.convert import resnet_from_jax
from apex_tpu_torch.models import ResNet, analytic_flops, resnet50
from apex_tpu_torch.ops import flat as F
from apex_tpu_torch.train import Trainer

CI = dict(block_sizes=(1, 1), bottleneck=True, num_classes=10, width=8)
BATCH, IMAGE = 4, 32


@pytest.fixture(scope="module")
def setup():
    jm = JResNet(**CI)
    params, state = jax.jit(jm.init)(jax.random.key(0))
    tm = ResNet(**CI, device="cpu")
    tp, ts = resnet_from_jax(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), device="cpu")
    rs = np.random.RandomState(0)
    x = rs.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    y = rs.randint(0, CI["num_classes"], BATCH).astype(np.int32)
    return jm, params, state, tm, tp, ts, x, y


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype).permute(
        0, 3, 1, 2)


def _close(got, want, tol):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_logits_and_bn_state_match_jax(setup):
    jm, params, state, tm, tp, ts, x, _ = setup
    apply = jax.jit(jm.apply, static_argnames="training")
    want, wstate = apply(params, state, jnp.asarray(x), training=True)
    got, gstate = tm.apply(tp, ts, _nchw(x), training=True)
    assert got.dtype == torch.float32 and got.shape == (BATCH, 10)
    _close(got.detach().numpy(), want, 1e-4)
    for g, w in zip(F.tree_leaves(gstate), jax.tree_util.tree_leaves(wstate)):
        _close(g.detach().float().numpy(), w, 1e-4)
    # eval mode reads the running stats
    want_e, _ = apply(params, wstate, jnp.asarray(x), training=False)
    got_e, _ = tm.apply(tp, gstate, _nchw(x), training=False)
    _close(got_e.detach().numpy(), want_e, 1e-4)


def test_flat_master_grad_matches_jax(setup):
    jm, params, state, tm, tp, ts, x, y = setup
    master, table = JF.flatten(params, dtype=jnp.float32)

    def loss_fn(master):                         # bench.py's _loss_fn, O0
        logits, _ = jm.apply(JF.unflatten(master, table), state,
                             jnp.asarray(x), training=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(j_select(logp, jnp.asarray(y)))

    want = np.asarray(jax.jit(jax.grad(loss_fn))(master))
    tr = Trainer(tm, tp, ts, opt_level="O0", device="cpu")
    got, loss, _ = tr.loss_and_grad(_nchw(x), torch.from_numpy(y))
    assert got.shape == (table.total,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert np.isclose(float(loss), float(loss_fn(master)), rtol=1e-5)
    assert not got[~tr.table.valid_mask()].any()


def _jax_steps(jm, params, state, x, y, opt_level, n):
    """bench.py:1244-1306's _loss_fn / train_step from the public calls."""
    _, handle = jamp.initialize(opt_level=opt_level, verbosity=0)
    amp_state = handle.init_state()
    half = handle.policy.cast_model_dtype
    opt = JLAMB(params, lr=1e-3)
    table = opt._tables[0]
    opt_state = opt.init_state()
    xj, yj = jnp.asarray(x, half), jnp.asarray(y)

    def loss_fn(master, bn_state, amp_state):
        p_half = JF.unflatten(master, table, dtype=half)
        logits, new_st = jm.apply(p_half, bn_state, xj, training=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        loss = -jnp.mean(j_select(logp, yj))
        return handle.scale_loss(loss, amp_state), (loss, new_st)

    @jax.jit
    def train_step(opt_state, bn_state, amp_state):
        fg, (loss, new_bn) = jax.grad(loss_fn, has_aux=True)(
            opt_state[0].master, bn_state, amp_state)
        fg, found_inf = handle.unscale(fg, amp_state)
        new_opt = opt.apply_update(opt_state, [fg], found_inf=found_inf)
        return new_opt, new_bn, handle.update(amp_state, found_inf), loss

    out = []
    for _ in range(n):
        opt_state, state, amp_state, loss = train_step(opt_state, state,
                                                       amp_state)
        out.append((float(loss), np.asarray(opt_state[0].master),
                    int(opt_state[0].step)))
    return out


@pytest.fixture(scope="module")
def jax_steps(setup):
    jm, params, state, _, _, _, x, y = setup
    return {lvl: _jax_steps(jm, params, state, x, y, lvl, 3)
            for lvl in ("O0", "O2")}


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_three_train_steps_match_jax(setup, jax_steps, opt_level):
    _, _, _, tm, tp, ts, x, y = setup
    want = jax_steps[opt_level]
    tr = Trainer(tm, tp, ts, opt_level=opt_level, device="cpu")
    assert tr.half == (torch.float32 if opt_level == "O0"
                       else torch.bfloat16)
    xt, yt = _nchw(x), torch.from_numpy(y)
    for i, (wloss, wmaster, wstep) in enumerate(want):
        loss = tr.step(xt, yt)
        master = tr.opt.state[0].master.numpy()
        assert int(tr.opt.state[0].step) == wstep == i + 1
        if opt_level == "O0":
            assert abs(float(loss) - wloss) <= 1e-5 * abs(wloss)
            np.testing.assert_allclose(master, wmaster, rtol=0, atol=1e-4)
        else:
            assert abs(float(loss) - wloss) <= 5e-3, (i, float(loss), wloss)
            err = np.abs(master - wmaster)
            bf16 = np.abs(wmaster - jax_steps["O0"][i][1])
            assert err.mean() <= 1.5 * bf16.mean(), (i, err.mean(),
                                                     bf16.mean())
            assert err.max() <= 1.5 * bf16.max(), (i, err.max(), bf16.max())
    assert float(loss) < want[0][0]                  # it learns


def test_analytic_flops_match_jax():
    assert analytic_flops(resnet50(device="cpu"), 224) == \
        j_flops(j_resnet50(), 224)
    assert analytic_flops(ResNet(**CI, device="cpu"), IMAGE) == \
        j_flops(JResNet(**CI), IMAGE)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="slice 7"):
        ResNet(**CI, stem="space_to_depth", device="cpu")
    # cross-replica BN is ported: the BNs sync over the named axis
    # (tests/test_torch_data_parallel.py trains it on gloo ranks)
    sync = ResNet(**CI, bn_axis_name="data", device="cpu")
    assert sync._bn(8).axis_name == "data"
    assert sync.replace(bn_axis_name=None)._bn(8).axis_name is None
    # O1 is ported: main_amp's O1 step keeps the model fp32
    # (tests/test_torch_imagenet.py holds it against JAX's)
    m = ResNet(**CI, device="cpu")
    tr = Trainer(m, *m.init(0), opt_level="O1", device="cpu")
    assert tr.handle.policy.autocast and tr.half == torch.float32
