"""The slice as a whole: bench.py's ``--zero ddp`` and ``--zero zero``
steps (``_run_zero_arm``, bench.py:840-1000) at its CPU width (ResNet
(1, 1) bottleneck, width 32, 10 classes, image 32, global batch 8,
bench.py:877-884), the port's ``DDPTrainer`` / ``ZeROTrainer`` on 2 gloo
ranks for 3 steps against the JAX step body under ``shard_map`` over 2 of
the conftest's 8 CPU devices, from the same init and inputs.

Tolerances. Against JAX in fp32 (O0, the half dtype fp32 in both): masters
and BN state 1e-4, losses 1e-5 relative (``test_torch_resnet.py``'s O0
bar; convolutions sum in another order). The two ranks end bit-equal. The
port's 2 ranks against its own 1-rank ``Trainer`` on the global batch, in
bf16 (O2): the BN sums are added in another order, so bf16 rounds
differently; the bar is bf16's own effect, as in ``test_torch_resnet.py``:
the masters no farther apart, in mean and max, than 1.5 times the
1-rank run's O2 masters are from its O0 masters; losses within 5e-3.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu import amp as jamp
from apex_tpu.contrib.optimizers import DistributedFusedLAMB as JZLAMB
from apex_tpu.contrib.xentropy import select_label_logits as j_select
from apex_tpu.models import ResNet as JResNet
from apex_tpu.ops import flat as JF
from apex_tpu.data import normalize_imagenet as j_normalize
from apex_tpu.optimizers import FusedLAMB as JLAMB
from apex_tpu.optimizers import FusedSGD as JSGD
from apex_tpu.parallel import DistributedDataParallel as JDDP
from apex_tpu.parallel import make_mesh as j_make_mesh
from apex_tpu_torch.convert import resnet_from_jax
from apex_tpu_torch.models import ResNet
from apex_tpu_torch.ops import flat as F
from apex_tpu_torch.train import Trainer

CPU = dict(block_sizes=(1, 1), bottleneck=True, num_classes=10, width=32)
BATCH, IMAGE, WORLD, STEPS = 8, 32, 2, 3


@pytest.fixture(scope="module")
def init():
    params, state = jax.jit(JResNet(**CPU).init)(jax.random.key(0))
    rs = np.random.RandomState(0)                    # bench.py:887-889
    x = rs.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    y = rs.randint(0, CPU["num_classes"], BATCH).astype(np.int32)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state),
            x, y)


def jax_arm(mode, init, opt_level):
    """bench.py's step body (:905-948) under shard_map over WORLD devices,
    STEPS times; the half dtype fp32 at O0. ``mode`` "sgd" is main_amp's
    distributed step (:239-288): a uint8 batch normalized in the step,
    FusedSGD at its defaults, the grad averaged before the unscale."""
    params, bn_state, x, y = init
    mesh = j_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    model = JResNet(**CPU, bn_axis_name="data")
    _, handle = jamp.initialize(opt_level=opt_level, verbosity=0)
    amp_state = handle.init_state()
    half = handle.policy.cast_model_dtype or jnp.float32
    if mode == "zero":
        opt = JZLAMB(params, lr=1e-3, axis_name="data", num_shards=WORLD,
                     model_dtype=half)
        table, opt_state, spec = opt.table, opt.init_state(), \
            opt.state_pspec()
    else:
        opt = JSGD(params, lr=0.1, momentum=0.9, weight_decay=1e-4) \
            if mode == "sgd" else JLAMB(params, lr=1e-3)
        table, opt_state, spec = opt._tables[0], opt.init_state(), P()
        ddp = JDDP(axis_name="data")

    def loss_fn(flat, bn_state, amp_state, x, y):
        if mode == "sgd":
            x = j_normalize(x, dtype=half)
        logits, new_st = model.apply(JF.unflatten(flat, table, dtype=half),
                                     bn_state, x, training=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        loss = -jnp.mean(j_select(logp, y))
        return handle.scale_loss(loss, amp_state), (loss, new_st)

    def step(opt_state, bn_state, amp_state, x, y):
        if mode == "zero":
            gathered = jax.lax.all_gather(
                opt_state.master.astype(opt.gather_dtype), "data",
                tiled=True)
            fg, (loss, new_bn) = jax.grad(loss_fn, has_aux=True)(
                gathered, bn_state, amp_state, x, y)
            fg, found_inf = handle.unscale(fg.astype(jnp.float32),
                                           amp_state)
            found_inf = jnp.minimum(jax.lax.psum(found_inf, "data"), 1.0)
            new_opt, _ = opt.shard_step(opt_state, fg,
                                        found_inf=found_inf > 0)
        else:
            fg, (loss, new_bn) = jax.grad(loss_fn, has_aux=True)(
                opt_state[0].master, bn_state, amp_state, x, y)
            fg = ddp.average_gradients(fg)
            fg, found_inf = handle.unscale(fg, amp_state)
            new_opt = opt.apply_update(opt_state, [fg], found_inf=found_inf)
        new_amp = handle.update(amp_state, found_inf)
        return new_opt, new_bn, new_amp, jax.lax.pmean(loss, "data")

    f = jax.jit(jax.shard_map(step, mesh=mesh,
                              in_specs=(spec, P(), P(), P("data"), P("data")),
                              out_specs=(spec, P(), P(), P()),
                              check_vma=False))
    xs = jnp.asarray(x) if mode == "sgd" else jnp.asarray(x, half)
    ys = jnp.asarray(y)
    losses = []
    for _ in range(STEPS):
        opt_state, bn_state, amp_state, loss = f(opt_state, bn_state,
                                                 amp_state, xs, ys)
        losses.append(float(loss))
    master = opt_state.master if mode == "zero" else opt_state[0].master
    return (np.array(losses),
            [np.asarray(a) for a in jax.tree.leaves(JF.unflatten(master,
                                                                 table))],
            [np.asarray(a) for a in jax.tree.leaves(bn_state)])


def port_arm(mode, init, tmp_path, opt_level):
    params, state, x, y = init
    return D.run_ranks(D.bench_steps, WORLD, tmp_path / f"{mode}{opt_level}",
                       mode=mode, params=params, state=state, x=x, y=y,
                       steps=STEPS, opt_level=opt_level)


def _leaves(r, prefix):
    return [r[k] for k in sorted((k for k in r if k.startswith(prefix)),
                                 key=lambda k: int(k[len(prefix):]))]


@pytest.mark.parametrize("mode", ["ddp", "zero"])
def test_two_ranks_match_the_jax_step_body(mode, init, tmp_path):
    got = port_arm(mode, init, tmp_path, "O0")
    for k in got[0]:                     # the ranks agree bit for bit
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    losses, masters, bn = jax_arm(mode, init, "O0")
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    for a, b in zip(_leaves(got[0], "master"), masters, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    for a, b in zip(_leaves(got[0], "bn"), bn, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    # one step's collectives: a forward and a backward all-reduce a BN
    # (9 BNs), the loss's; ddp the flat grad's, zero the gather, the
    # reduce-scatter, the overflow flag and LAMB's two sums
    assert int(got[0]["tally_calls"]) == 18 + 1 + (1 if mode == "ddp" else 5)


def test_main_amp_data_parallel_sync_bn_step_matches_jax(init, tmp_path):
    """main_amp's ``--data-parallel 2 --sync_bn`` step (FusedSGD, a uint8
    NHWC batch normalized on the device) on bench.py's CPU model, O0."""
    params, state, x, y = init
    xu8 = np.random.RandomState(1).randint(0, 256, x.shape).astype(np.uint8)
    got = D.run_ranks(D.bench_steps, WORLD, tmp_path, mode="sgd",
                      params=params, state=state, x=xu8, y=y, steps=STEPS,
                      opt_level="O0")
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    losses, masters, bn = jax_arm("sgd", (params, state, xu8, y), "O0")
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    for a, b in zip(_leaves(got[0], "master"), masters, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    for a, b in zip(_leaves(got[0], "bn"), bn, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def _one_rank(init, opt_level):
    params, state, x, y = init
    tp, ts = resnet_from_jax(params, state, device="cpu")
    tr = Trainer(ResNet(**CPU, device="cpu"), tp, ts, opt_level=opt_level,
                 device="cpu")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    losses = [float(tr.step(xt, torch.from_numpy(y))) for _ in range(STEPS)]
    return np.array(losses), [t.numpy() for t in F.tree_leaves(
        F.unflatten(tr.opt.state[0].master, tr.table))]


def _gap(a, b):
    d = np.concatenate([np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64)).ravel()
                        for x, y in zip(a, b)])
    return d.mean(), d.max()


def test_step1_grad_of_two_ranks_is_the_global_batch_grad(init, tmp_path):
    """Before any update, in fp32: the ranks' averaged grad and loss are
    the 1-rank ``Trainer``'s on the global batch within 1e-5 (relative to
    the grad's mean and max; the sums run in another order), and the
    control, BNs left local, is not (its statistics are each half's)."""
    params, state, x, y = init
    tp, ts = resnet_from_jax(params, state, device="cpu")
    tr = Trainer(ResNet(**CPU, device="cpu"), tp, ts, opt_level="O0",
                 device="cpu")
    grad, loss, _ = tr.loss_and_grad(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     torch.from_numpy(y))
    want, want_loss = grad.numpy(), float(loss)

    def gap(r):
        d = np.abs(r["grad"] - want)
        return (d.mean() / np.abs(want).mean(), d.max() / np.abs(want).max(),
                abs(float(r["loss"][0]) - want_loss))
    synced = D.run_ranks(D.step1_grad, WORLD, tmp_path / "sync",
                         params=params, state=state, x=x, y=y)
    local = D.run_ranks(D.step1_grad, WORLD, tmp_path / "local",
                        params=params, state=state, x=x, y=y, sync=False)
    np.testing.assert_array_equal(synced[0]["grad"], synced[1]["grad"])
    assert max(gap(synced[0])) <= 1e-5, gap(synced[0])
    assert gap(local[0])[0] > 1e-2, gap(local[0])


@pytest.mark.parametrize("mode", ["ddp", "zero"])
def test_two_ranks_match_one_rank_on_the_global_batch(mode, init, tmp_path):
    got = port_arm(mode, init, tmp_path, "O2")
    one_l, one_m = _one_rank(init, "O2")
    _, one_m0 = _one_rank(init, "O0")
    mean, mx = _gap(_leaves(got[0], "master"), one_m)
    bmean, bmx = _gap(one_m, one_m0)
    assert mean <= 1.5 * bmean and mx <= 1.5 * bmx, (mean, mx, bmean, bmx)
    np.testing.assert_allclose(got[0]["losses"], one_l, atol=5e-3)
