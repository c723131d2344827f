"""Port parity: the DCGAN example's three-loss step
(``train.DCGANTrainer``, ``models.DCGAN``) and the underflow census
(``prof.numerics.underflow_census``) against the JAX package's.

The example's step is a closure inside its ``main()``, so the JAX side is
rebuilt here from ``apex_tpu.amp``, ``apex_tpu.optimizers.FusedAdam`` and
``apex_tpu.ops.flat``, with the example's G, D and step
(examples/dcgan/main_amp.py:73-207) copied in at tiny widths (nz 8, ngf
4, ndf 4, batch 4); the example's data stream (``RandomState(0)`` normal
reals and latents, :229-235) feeds both. JAX's init goes across through
``convert.params_from_jax``. After 3 steps the three scalers' states
(scale, growth tracker, step, overflow and growth counts) are equal, and
the masters agree within 2e-6 at O0 (fp32), and step 1's gradients
within 1e-5 of their largest entry. Under O1 the two policies give the
same dtypes op by op; step 1's gradients are held within 1.5 times
bf16's own effect on them (JAX's O1 gradients against its O0 ones), in
mean and in max. An operand can round to bf16 the other way in the two
packages, and Adam at lr 2e-4 turns a gradient near rounding noise (G's
are 1e-7) into a move of about lr either way at each step: the masters
are held to 2·3·lr in max, as tests/test_torch_accumulate.py holds such
masters, and to lr/10 in mean. An inf written into loss 1's gradient
must skip D's update, halve scaler 1 alone, let G update and be named by
scaler 1's census.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.ops import flat as JF
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu.prof import numerics as JNU
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import DCGAN, bce_logits
from apex_tpu_torch.models.resnet import conv
from apex_tpu_torch.ops import flat as F
from apex_tpu_torch.prof import numerics as NU
from apex_tpu_torch.train import DCGANTrainer

NZ, NGF, NDF, B = 8, 4, 4, 4
LR, BETAS = 2e-4, (0.5, 0.999)
STEPS = 3
MASTER_ATOL = {"O0": 2e-6, "O1": 2 * STEPS * LR}
MASTER_MEAN = {"O0": 2e-7, "O1": LR / 10}
INJECT_AT = 3            # flat index of the injected inf in loss 1's grad


# -- the example's models and step, at the test's widths ----------------------

def j_g_init(key):
    ks = jax.random.split(key, 4)
    s = lambda k, sh: jax.random.normal(k, sh) * 0.02     # noqa: E731
    return {"fc": s(ks[0], (NZ, 4 * 4 * NGF * 4)),
            "c1": s(ks[1], (4, 4, NGF * 4, NGF * 2)),
            "c2": s(ks[2], (4, 4, NGF * 2, NGF)),
            "c3": s(ks[3], (4, 4, NGF, 3))}


def j_d_init(key):
    ks = jax.random.split(key, 4)
    s = lambda k, sh: jax.random.normal(k, sh) * 0.02     # noqa: E731
    return {"c1": s(ks[0], (4, 4, 3, NDF)),
            "c2": s(ks[1], (4, 4, NDF, NDF * 2)),
            "c3": s(ks[2], (4, 4, NDF * 2, NDF * 4)),
            "fc": s(ks[3], (4 * 4 * NDF * 4, 1))}


def j_upconv(x, w, out_hw):
    b = x.shape[0]
    y = jax.image.resize(x, (b, out_hw, out_hw, x.shape[-1]), "nearest")
    return jax.lax.conv_general_dilated(
        y, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


def j_downconv(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


def j_generator(p, z):
    h = (z @ p["fc"]).reshape(-1, 4, 4, NGF * 4)
    h = jax.nn.relu(h)
    h = jax.nn.relu(j_upconv(h, p["c1"], 8))
    h = jax.nn.relu(j_upconv(h, p["c2"], 16))
    return jnp.tanh(j_upconv(h, p["c3"], 32))


def j_discriminator(p, x):
    h = jax.nn.leaky_relu(j_downconv(x, p["c1"]), 0.2)
    h = jax.nn.leaky_relu(j_downconv(h, p["c2"]), 0.2)
    h = jax.nn.leaky_relu(j_downconv(h, p["c3"]), 0.2)
    return (h.reshape(h.shape[0], -1) @ p["fc"])[:, 0]


def j_bce_logits(logits, target):
    return jnp.mean(jnp.maximum(logits, 0) - logits * target +
                    jnp.log1p(jnp.exp(-jnp.abs(logits))))


class JaxDCGAN:
    """main_amp.py:115-207 with an optional inf written into loss 1's
    flat gradient before its unscale."""

    def __init__(self, opt_level, numerics=False, **overrides):
        _, h = jamp.initialize(opt_level=opt_level, num_losses=3,
                               verbosity=0, **overrides)
        self.handle, self.amp_state = h, h.init_state()
        self.gp0, self.dp0 = j_g_init(jax.random.key(1)), \
            j_d_init(jax.random.key(2))
        g_opt = JAdam(self.gp0, lr=LR, betas=BETAS)
        d_opt = JAdam(self.dp0, lr=LR, betas=BETAS)
        g_table, d_table = g_opt._tables[0], d_opt._tables[0]
        self.g_state, self.d_state = g_opt.init_state(), d_opt.init_state()
        g_fwd = jamp.autocast(j_generator) if h.policy.autocast \
            else j_generator
        d_fwd = jamp.autocast(j_discriminator) if h.policy.autocast \
            else j_discriminator
        self.censuses = None
        if numerics:
            self.d_meta, self.g_meta = JNU.tree_meta(d_table), \
                JNU.tree_meta(g_table)
            self.censuses = (JNU.empty_census(self.d_meta.n),
                             JNU.empty_census(self.d_meta.n),
                             JNU.empty_census(self.g_meta.n))

        def grads(g_state, d_state, amp_state, real, z):
            """The three scaled losses' flat gradients (:151-188)."""
            gp = JF.unflatten(g_state[0].master, g_table)
            dp = JF.unflatten(d_state[0].master, d_table)
            fake = g_fwd(gp, z)

            def d_loss_real(dp):
                return h.scale_loss(j_bce_logits(d_fwd(dp, real), 1.0),
                                    amp_state, loss_id=0)

            def d_loss_fake(dp):
                return h.scale_loss(j_bce_logits(
                    d_fwd(dp, jax.lax.stop_gradient(fake)), 0.0),
                    amp_state, loss_id=1)

            fg_r = JF.flatten(jax.grad(d_loss_real)(dp), table=d_table,
                              dtype=jnp.float32)[0]
            fg_f = JF.flatten(jax.grad(d_loss_fake)(dp), table=d_table,
                              dtype=jnp.float32)[0]

            def g_loss(gp):
                return h.scale_loss(j_bce_logits(d_fwd(dp, g_fwd(gp, z)),
                                                 1.0), amp_state, loss_id=2)

            fgg = JF.flatten(jax.grad(g_loss)(gp), table=g_table,
                             dtype=jnp.float32)[0]
            return fg_r, fg_f, fgg, dp, fake

        @jax.jit
        def train_step(g_state, d_state, amp_state, real, z, inject,
                       censuses):
            fg_r, fg_f, fgg, dp, fake = grads(g_state, d_state, amp_state,
                                              real, z)
            fg_f = jnp.where(inject, fg_f.at[INJECT_AT].set(jnp.inf), fg_f)
            fg_r, inf0 = h.unscale(fg_r, amp_state, loss_id=0)
            fg_f, inf1 = h.unscale(fg_f, amp_state, loss_id=1)
            d_new = d_opt.apply_update(d_state, [fg_r + fg_f],
                                       found_inf=inf0 | inf1)
            fgg, inf2 = h.unscale(fgg, amp_state, loss_id=2)
            g_new = g_opt.apply_update(g_state, [fgg], found_inf=inf2)
            if censuses is not None:
                c0, c1, c2 = censuses
                new_amp, c0 = h.update_with_census(
                    amp_state, inf0, fg_r, c0, loss_id=0, table=d_table)
                new_amp, c1 = h.update_with_census(
                    new_amp, inf1, fg_f, c1, loss_id=1, table=d_table)
                new_amp, c2 = h.update_with_census(
                    new_amp, inf2, fgg, c2, loss_id=2, table=g_table)
                censuses = (c0, c1, c2)
            else:
                new_amp = h.update(amp_state, inf0, loss_id=0)
                new_amp = h.update(new_amp, inf1, loss_id=1)
                new_amp = h.update(new_amp, inf2, loss_id=2)
            d_loss = j_bce_logits(d_fwd(dp, real), 1.0) + \
                j_bce_logits(d_fwd(dp, fake), 0.0)
            g_l = j_bce_logits(d_fwd(dp, fake), 1.0)
            return g_new, d_new, new_amp, censuses, d_loss, g_l

        self.train_step = train_step
        self.grads = jax.jit(lambda *a: grads(*a)[:3])

    def step(self, real, z, inject=False):
        (self.g_state, self.d_state, self.amp_state, self.censuses, d_l,
         g_l) = self.train_step(self.g_state, self.d_state, self.amp_state,
                                jnp.asarray(real), jnp.asarray(z),
                                jnp.bool_(inject), self.censuses)
        return float(d_l), float(g_l)


def batches(n):
    """The example's data stream (main_amp.py:229-235)."""
    rs = np.random.RandomState(0)
    for _ in range(n):
        real = (rs.randn(B, 32, 32, 3) * 0.5).astype(np.float32)
        z = rs.randn(B, NZ).astype(np.float32)
        yield real, z


def port_trainer(jx, opt_level, **kw):
    model = DCGAN(nz=NZ, ngf=NGF, ndf=NDF, device="cpu")
    return DCGANTrainer(model, params_from_jax(jx.gp0, device="cpu"),
                        params_from_jax(jx.dp0, device="cpu"),
                        opt_level=opt_level, lr=LR, betas=BETAS,
                        device="cpu", **kw)


def port_step(tr, real, z, inject=False):
    grads, losses = tr.loss_and_grads(torch.from_numpy(real),
                                      torch.from_numpy(z))
    if inject:
        grads[1][INJECT_AT] = float("inf")
    tr.apply_grads(*grads)
    return tuple(float(v) for v in losses)


def scaler_states(handle, amp_state):
    return [handle.scalers[i].state_dict(amp_state[i]) for i in range(3)]


def assert_masters(tr, jx, level):
    for opt, st in ((tr.g_opt, jx.g_state), (tr.d_opt, jx.d_state)):
        got, want = opt.state[0].master.numpy(), np.asarray(st[0].master)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=MASTER_ATOL[level])
        assert np.abs(got - want).mean() <= MASTER_MEAN[level]


# -- the step -------------------------------------------------------------------

@pytest.mark.parametrize("opt_level", ["O0", "O1"])
def test_three_loss_step_matches_jax(opt_level):
    jx = JaxDCGAN(opt_level)
    tr = port_trainer(jx, opt_level)
    assert tr.handle.policy.autocast == (opt_level == "O1")
    for i, (real, z) in enumerate(batches(STEPS)):
        if i == 0:
            tgrads, _ = tr.loss_and_grads(torch.from_numpy(real),
                                          torch.from_numpy(z))
            args = (jnp.asarray(real), jnp.asarray(z))
            jgrads = jx.grads(jx.g_state, jx.d_state, jx.amp_state, *args)
            j0 = JaxDCGAN("O0") if opt_level == "O1" else jx
            fgrads = j0.grads(j0.g_state, j0.d_state, j0.amp_state, *args)
            for t, j, f in zip(tgrads, jgrads, fgrads):
                err = np.abs(t.numpy() - np.asarray(j))
                if opt_level == "O0":
                    assert err.max() <= 1e-5 * np.abs(np.asarray(j)).max()
                    continue
                own = np.abs(np.asarray(j) - np.asarray(f))
                assert err.mean() <= 1.5 * own.mean(), (err.mean(),
                                                        own.mean())
                assert err.max() <= 1.5 * own.max(), (err.max(), own.max())
        got = port_step(tr, real, z)
        want = jx.step(real, z)
        np.testing.assert_allclose(got, want, rtol=1e-2 if opt_level == "O1"
                                   else 1e-5)
    assert scaler_states(tr.handle, tr.amp_state) == \
        scaler_states(jx.handle, jx.amp_state)
    assert_masters(tr, jx, opt_level)
    for opt in (tr.g_opt, tr.d_opt):
        assert int(opt.state[0].step) == STEPS


def test_inf_in_loss_1_skips_d_and_halves_scaler_1_alone():
    jx = JaxDCGAN("O1", numerics=True, loss_scale="dynamic")
    tr = port_trainer(jx, "O1", numerics=True, loss_scale="dynamic")
    data = list(batches(STEPS))
    for i, (real, z) in enumerate(data):
        inject = i == 1
        if inject:
            d0, g0 = tr.d_opt.state[0], tr.g_opt.state[0]
        port_step(tr, real, z, inject)
        jx.step(real, z, inject)
        if inject:
            d1, g1 = tr.d_opt.state[0], tr.g_opt.state[0]
            assert torch.equal(d1.master, d0.master)
            assert all(torch.equal(d1.slots[k], d0.slots[k])
                       for k in d0.slots)
            assert int(d1.step) == int(d0.step)
            assert not torch.equal(g1.master, g0.master)
            assert int(g1.step) == int(g0.step) + 1
    states = scaler_states(tr.handle, tr.amp_state)
    assert states == scaler_states(jx.handle, jx.amp_state)
    assert [s["loss_scale"] for s in states] == [65536.0, 32768.0, 65536.0]
    assert [s["overflow_count"] for s in states] == [0, 1, 0]
    culprits = NU.culprit_table(tr.d_meta, tr.censuses[1])
    jculprits = JNU.culprit_table(jx.d_meta, jx.censuses[1])
    assert [c["path"] for c in culprits] == [c["path"] for c in jculprits]
    assert culprits[0]["inf"] == 1 and int(tr.censuses[1].step) == 1
    assert culprits[0]["path"] == tr.d_meta.paths[
        [o <= INJECT_AT < o + n for o, n in zip(tr.d_table.offsets,
                                                 tr.d_table.sizes)].index(
            True)]
    assert NU.culprit_table(tr.g_meta, tr.censuses[2]) == []
    assert_masters(tr, jx, "O1")


# -- the layout traps ---------------------------------------------------------

@pytest.mark.parametrize("hw", [4, 8, 16])
def test_nearest_resize_matches_jax(hw):
    x = np.random.RandomState(hw).randn(2, hw, hw, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 2 * hw, 2 * hw, 3),
                            "nearest")
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stride,hw", [(1, 8), (1, 5), (2, 32), (2, 7)])
def test_same_padding_of_a_4x4_kernel_matches_jax(stride, hw):
    rs = np.random.RandomState(stride * 100 + hw)
    x = rs.randn(2, hw, hw, 3).astype(np.float32)
    w = rs.randn(4, 4, 3, 5).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv(torch.from_numpy(w), torch.from_numpy(x).permute(0, 3, 1, 2),
               stride=stride, padding="SAME").permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_models_and_loss_match_jax_on_the_same_weights():
    gp, dp = j_g_init(jax.random.key(1)), j_d_init(jax.random.key(2))
    real, z = next(batches(1))
    model = DCGAN(nz=NZ, ngf=NGF, ndf=NDF, device="cpu")
    tg, td = params_from_jax(gp, device="cpu"), \
        params_from_jax(dp, device="cpu")
    assert {k: tuple(v.shape) for k, v in model.g_init(0).items()} == \
        {k: tuple(v.shape) for k, v in tg.items()}
    assert {k: tuple(v.shape) for k, v in model.d_init(0).items()} == \
        {k: tuple(v.shape) for k, v in td.items()}
    fake = model.generator(tg, torch.from_numpy(z))
    jfake = j_generator(gp, jnp.asarray(z))
    np.testing.assert_allclose(fake.numpy(), np.asarray(jfake), rtol=1e-5,
                               atol=1e-6)
    logits = model.discriminator(td, torch.from_numpy(real))
    jlogits = j_discriminator(dp, jnp.asarray(real))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)
    for t in (0.0, 1.0):
        np.testing.assert_allclose(float(bce_logits(logits, t)),
                                   float(j_bce_logits(jlogits, t)),
                                   rtol=1e-6)


# -- the underflow census -----------------------------------------------------

def _census_case():
    tree = {"a": np.zeros((3, 5), np.float32), "b": np.zeros(7, np.float32),
            "c": {"d": np.zeros((2, 2), np.float32)}}
    rs = np.random.RandomState(7)
    leaves = []
    for leaf in jax.tree_util.tree_leaves(tree):
        mags = 2.0 ** rs.uniform(-30, 20, leaf.size)
        v = (mags * rs.choice([-1, 1], leaf.size)).astype(np.float32)
        v[rs.rand(leaf.size) < 0.2] = 0.0
        leaves.append(v.reshape(leaf.shape))
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree),
                                        leaves)


@pytest.mark.parametrize("flat", [False, True])
def test_underflow_census_matches_jax(flat):
    tree = _census_case()
    ttree = params_from_jax(tree, device="cpu")
    if flat:
        jbuf, jtable = JF.flatten(tree, dtype=jnp.float32)
        tbuf, ttable = F.flatten(ttree, dtype=torch.float32)
        want = JNU.underflow_census(jbuf, table=jtable)
        got = NU.underflow_census(tbuf, table=ttable)
        jmeta, tmeta = JNU.tree_meta(jtable), NU.tree_meta(ttable)
    else:
        want = JNU.underflow_census(tree)
        got = NU.underflow_census(ttree)
        jmeta, tmeta = JNU.tree_meta(tree), NU.tree_meta(ttree)
    for name in ("tiny_count", "ftz_count", "zero_count", "hist"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(float(got.grad_norm), float(want.grad_norm),
                               rtol=1e-6)
    assert NU.hist_labels() == JNU.hist_labels()
    gs, ws = NU.underflow_summary(tmeta, got), JNU.underflow_summary(jmeta,
                                                                     want)
    assert gs["grad_norm"] == pytest.approx(ws["grad_norm"], rel=1e-6)
    assert {k: v for k, v in gs.items() if k != "grad_norm"} == \
        {k: v for k, v in ws.items() if k != "grad_norm"}


def test_g_underflow_census_is_the_census_of_gs_gradient():
    jx = JaxDCGAN("O1")
    tr = port_trainer(jx, "O1", numerics=True)
    real, z = next(batches(1))
    port_step(tr, real, z)
    zt = torch.from_numpy(z)
    got = tr.g_underflow_census(zt)
    g_m, _, gp, dp = tr.master_trees()
    (fgg,) = torch.autograd.grad(
        bce_logits(tr.d_fwd(dp, tr.g_fwd(gp, zt)), 1.0), g_m)
    want = NU.underflow_census(F.unflatten(fgg, tr.g_table))
    for name in ("tiny_count", "ftz_count", "zero_count", "hist"):
        assert torch.equal(getattr(got, name), getattr(want, name))
