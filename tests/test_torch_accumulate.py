"""Port parity: gradient accumulation (``AmpHandle.unscale_with_stashed``,
``accumulate_grads``, ``LMTrainer(microbatches=...)``) and the fp16_utils
training path (``FP16_Optimizer`` with ``clip_master_grads`` over
``FusedAdagrad``) against the JAX package's.

The accumulation cases of tests/test_amp.py:467-560 (mean mode, sum mode,
a poisoned microbatch, a poisoned stash that must not raise the flag), on
numpy inputs fed to both packages, rtol 1e-5 / atol 1e-6. Then a tiny LM
(2 layers, embed 64, 4 heads, vocab 256, S 33, batch 4, f32, attention
"default"), initialised by the JAX package and carried across, trained 3
steps by ``LMTrainer(microbatches=2, loss_scale="dynamic")`` against JAX's
``accumulate_grads`` + ``FusedAdam`` + ``update``, and by
``FP16_Optimizer(FusedAdagrad)`` with clipping against the JAX one, in
both weight-decay modes. Tolerance 1e-5 (f32); masters whose gradient is
rounding noise at some step (the key biases, zero analytically, and a
few weights at init) move by about lr either way under Adam and Adagrad,
so they are held to 2·3·lr, as ``chip_smoke.py``'s crosschecks leave
them out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import fp16_utils as JF16
from apex_tpu.models import TransformerLM as JLM
from apex_tpu.ops import flat as JF
from apex_tpu.optimizers import FusedAdagrad as JAdagrad
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu_torch import amp
from apex_tpu_torch import fp16_utils as F16
from apex_tpu_torch.convert import opt_state_from_jax, params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM
from apex_tpu_torch.ops import flat as F
from apex_tpu_torch.optimizers import FusedAdagrad
from apex_tpu_torch.train import LMTrainer

ATOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)       # the LM's, as tests/test_torch_lm_train


def _handles(**kw):
    _, jh = jamp.initialize(opt_level="O2", verbosity=0, **kw)
    _, th = amp.initialize(opt_level="O2", verbosity=0, **kw)
    return jh, th, jh.init_state(), th.init_state("cpu")


def test_unscale_with_stashed_matches_jax_and_checks_fresh_grads_only():
    jh, th, jst, tst = _handles(loss_scale="dynamic")
    rs = np.random.RandomState(0)
    fresh = (rs.randn(256) * 65536).astype(np.float32)
    stash = rs.randn(256).astype(np.float32)
    got, fi = th.unscale_with_stashed(torch.from_numpy(fresh),
                                      torch.from_numpy(stash), tst)
    want, jfi = jh.unscale_with_stashed(jnp.asarray(fresh),
                                        jnp.asarray(stash), jst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    assert not bool(fi) and not bool(jfi)
    bad = fresh.copy()
    bad[7] = np.inf
    assert bool(th.unscale_with_stashed(torch.from_numpy(bad),
                                        torch.from_numpy(stash), tst)[1])
    bad_stash = stash.copy()
    bad_stash[3] = np.inf
    assert not bool(th.unscale_with_stashed(
        torch.from_numpy(fresh), torch.from_numpy(bad_stash), tst)[1])


def _quadratic():
    params = {"w": np.random.RandomState(0).randn(8, 4).astype(np.float32)}
    x = np.random.RandomState(1).randn(16, 8).astype(np.float32)
    y = np.random.RandomState(2).randn(16, 4).astype(np.float32)
    jmaster, jtable = JF.flatten(jax.tree.map(jnp.asarray, params),
                                 dtype=jnp.float32)
    tmaster, ttable = F.flatten(F.tree_map(torch.from_numpy, params),
                                dtype=torch.float32)

    def jloss(m, mb):
        p = JF.unflatten(m, jtable)
        return jnp.mean((mb[0] @ p["w"] - mb[1]) ** 2)

    def tloss(m, mb):
        p = F.unflatten(m, ttable)
        return torch.mean((mb[0] @ p["w"] - mb[1]) ** 2)

    return jmaster, tmaster, x, y, jloss, tloss


@pytest.mark.parametrize("average", [True, False])
def test_accumulate_grads_matches_jax(average):
    jmaster, tmaster, x, y, jloss, tloss = _quadratic()
    jh, th, jst, tst = _handles(loss_scale="dynamic")
    jmicro = (jnp.asarray(x).reshape(4, 4, 8), jnp.asarray(y).reshape(4, 4, 4))
    tmicro = (torch.from_numpy(x).reshape(4, 4, 8),
              torch.from_numpy(y).reshape(4, 4, 4))
    fg, fi, loss = th.accumulate_grads(tloss, tmaster, tmicro, tst,
                                       average=average)
    jfg, jfi, jl = jh.accumulate_grads(jloss, jmaster, jmicro, jst,
                                       average=average)
    assert fi.dtype == torch.float32 and float(fi) == float(jfi) == 0.0
    np.testing.assert_allclose(fg.numpy(), np.asarray(jfg), **ATOL)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    if average:      # the mean of the microbatches' grads is the batch's
        full = jax.grad(lambda m: jloss(m, (jnp.asarray(x),
                                            jnp.asarray(y))))(jmaster)
        np.testing.assert_allclose(fg.numpy(), np.asarray(full), **ATOL)


def test_accumulate_grads_flags_a_poisoned_microbatch_like_jax():
    jmaster, tmaster, x, y, jloss, tloss = _quadratic()
    jh, th, jst, tst = _handles(loss_scale="dynamic")
    poison = np.zeros(4, np.float32)
    poison[2] = np.inf

    def jbad(m, mb):
        return jloss(m, mb[:2]) + jnp.sum(m) * mb[2]

    def tbad(m, mb):
        return tloss(m, mb[:2]) + torch.sum(m) * mb[2]

    jmicro = (jnp.asarray(x).reshape(4, 4, 8),
              jnp.asarray(y).reshape(4, 4, 4), jnp.asarray(poison))
    tmicro = (torch.from_numpy(x).reshape(4, 4, 8),
              torch.from_numpy(y).reshape(4, 4, 4), torch.from_numpy(poison))
    _, fi, _ = th.accumulate_grads(tbad, tmaster, tmicro, tst)
    _, jfi, _ = jh.accumulate_grads(jbad, jmaster, jmicro, jst)
    assert float(fi) == float(jfi) == 1.0
    new = th.update(tst, fi)
    assert float(th.loss_scale(new)) == 32768.0
    assert int(new[0].overflow_count) == 1


def test_update_with_census_through_the_handle():
    jh, th, jst, tst = _handles(loss_scale="dynamic")
    g = np.ones(256, np.float32)
    g[5] = np.nan
    table = F.make_table({"a": torch.zeros(100), "b": torch.zeros(100)})
    jtable = JF.make_table({"a": jnp.zeros(100), "b": jnp.zeros(100)})
    tnew, tcar = th.update_with_census(tst, torch.tensor(True),
                                       torch.from_numpy(g), table=table)
    jnew, jcar = jh.update_with_census(jst, jnp.asarray(True),
                                       jnp.asarray(g), table=jtable)
    assert th.state_dict(tnew) == jh.state_dict(jnew)
    np.testing.assert_array_equal(tcar.nan_count.numpy(),
                                  np.asarray(jcar.nan_count))


# -- a tiny LM, trained -------------------------------------------------------

CFG = dict(vocab_size=256, max_seq_len=64, embed_dim=64, num_heads=4,
           num_layers=2, attn_impl="default", head_chunk=64)
B, S = 4, 33
LR = 1e-3
MAX_NORM = 0.25


@pytest.fixture(scope="module")
def lm():
    jm = JLM(**CFG)
    jp = jm.init(jax.random.key(0))
    tm = TLM(**CFG, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(1).randint(0, 256, (B, S)).astype(np.int32)
    return jm, jp, tm, tp, toks


def _masters_close(got, want, grads):
    """Masters within 1e-5, leaving out those whose gradient at some step
    is rounding noise, within 1e-7 of the largest entry (the key biases,
    zero analytically, and a few weights at init): Adam and Adagrad turn
    such noise into moves of about lr either way, so they are held to
    2·3·lr."""
    noise = np.zeros(got.shape, bool)
    for g in grads:
        g = np.abs(np.asarray(g))
        noise |= g <= 1e-7 * g.max()
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[~noise], want[~noise], **TOL)
    assert np.abs(got[noise] - want[noise]).max() <= 2 * 3 * LR


def test_lm_trainer_accumulation_matches_jax(lm):
    jm, jp, tm, tp, toks = lm
    jopt = JAdam(jp, lr=LR)
    table = jopt._tables[0]
    _, jh = jamp.initialize(opt_level="O2", loss_scale="dynamic",
                            verbosity=0)
    jst, state = jh.init_state(), jopt.init_state()
    tr = LMTrainer(tm, tp, lr=LR, dtype=None, microbatches=2,
                   loss_scale="dynamic", device="cpu")
    tr.opt.state = opt_state_from_jax(state, device="cpu")
    micro = jnp.asarray(toks).reshape(2, B // 2, S)

    def loss_fn(m, mb):
        return jm.loss(JF.unflatten(m, table), mb)

    jacc = jax.jit(lambda m, st: jh.accumulate_grads(loss_fn, m, micro, st))
    losses, jlosses, grads = [], [], []
    for step in range(3):
        fg, fi, jl = jacc(state[0].master, jst)
        grads.append(fg)
        if step == 0:      # the first step's accumulated grad
            g, tfi, _ = tr.accumulate_grads(torch.from_numpy(toks))
            assert float(tfi) == 0.0
            np.testing.assert_allclose(g.numpy(), np.asarray(fg), **ATOL)
        state = jopt.apply_update(state, [fg], found_inf=fi)
        jst = jh.update(jst, fi)
        jlosses.append(float(jl))
        losses.append(float(tr.step(torch.from_numpy(toks))))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert tr.handle.state_dict(tr.amp_state) == jh.state_dict(jst)
    assert int(tr.opt.state[0].step) == 3
    _masters_close(tr.opt.state[0].master, state[0].master, grads)


def test_lm_trainer_accumulation_refuses_a_ragged_split(lm):
    _, _, tm, tp, toks = lm
    tr = LMTrainer(tm, tp, dtype=None, microbatches=3, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        tr.step(torch.from_numpy(toks))
    plain = LMTrainer(tm, tp, dtype=None, device="cpu")
    assert plain.handle is None
    with pytest.raises(ValueError, match="microbatches"):
        plain.accumulate_grads(torch.from_numpy(toks))


@pytest.mark.parametrize("w_mode", [False, True])
def test_fp16_optimizer_adagrad_with_clipping_matches_jax(lm, w_mode):
    jm, jp, tm, tp, toks = lm
    kw = dict(lr=LR, weight_decay=1e-2, adagrad_w_mode=w_mode)
    jopt = JF16.FP16_Optimizer(JAdagrad(jp, **kw), dynamic_loss_scale=True)
    topt = F16.FP16_Optimizer(FusedAdagrad(tp, device="cpu", **kw),
                              dynamic_loss_scale=True)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    # the grads of scale_loss(loss): the fp32 loss times the scale
    jgrad = jax.jit(jax.grad(lambda p, scale: jm.loss(p, jt) * scale))
    jflat = []
    for _ in range(3):
        jg = jgrad(jopt.params_tree(), jopt.scaler_state.scale)
        jc, jn = jopt.clip_master_grads(MAX_NORM, jg)
        jflat.append(jopt.optimizer.flatten_grads(jg)[0])
        jopt.step(jc)
        params = F.tree_map(lambda t: t.detach().requires_grad_(True),
                            topt.params_tree())
        leaves, treedef = F.tree_flatten(params)
        loss = tm.loss(params, tt)
        grads = F.tree_unflatten(treedef, torch.autograd.grad(
            topt.scale_loss(loss), leaves))
        clipped, norm = topt.clip_master_grads(MAX_NORM, grads)
        topt.step(clipped)
        np.testing.assert_allclose(float(norm), float(jn), rtol=1e-5)
        assert float(norm) > MAX_NORM     # the clip is on the path
        assert topt.overflow == jopt.overflow is False
    _masters_close(topt.optimizer.state[0].master,
                   jopt.optimizer.state[0].master, jflat)
    np.testing.assert_allclose(
        topt.optimizer.state[0].slots["sum"].numpy(),
        np.asarray(jopt.optimizer.state[0].slots["sum"]), rtol=1e-4,
        atol=1e-7)
