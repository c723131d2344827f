"""Port parity: the softmax cross-entropy kernels and the loss op.

The JAX package's ``xent_fwd`` / ``xent_bwd`` run their Pallas kernels in
interpret mode off the TPU (``_common.interpret_mode``); its
``softmax_cross_entropy_loss`` is taken through ``jax.vjp``. The port's
wrappers run their plain versions on CPU tensors, and its loss op runs
under torch autograd. Both get the same numpy inputs: ragged vocabularies
(V = 37 and 1000, neither a multiple of the Pallas kernels' 2048-wide
vocab tile), label smoothing 0 and 0.1, a label at V − 1 and one outside
[0, V), ``padding_idx`` 0 and None. Tolerance: f32 within 1e-5 (atol and
rtol: the two sum a row in other orders); with bf16 logits, the fp32
losses (``half_to_float``) within 1e-5 and the bf16 outputs within one
bf16 rounding (rtol 2^-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.xentropy import select_label_logits as j_select
from apex_tpu.contrib.xentropy import softmax_cross_entropy_loss as j_loss
from apex_tpu.ops.pallas import xentropy as JX
from apex_tpu_torch.contrib.xentropy import (SoftmaxCrossEntropyLoss,
                                             select_label_logits,
                                             softmax_cross_entropy_loss)
from apex_tpu_torch.ops import xentropy as XE

TOL = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-6, rtol=2.0 ** -7)


def _case(n, v, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, v) * 3).astype(np.float32)
    lab = rs.randint(0, v, n).astype(np.int32)
    lab[::4] = 0                     # pad rows under padding_idx=0
    lab[1] = v - 1
    g = rs.randn(n).astype(np.float32)
    return x, lab, g


@pytest.mark.parametrize("v", [37, 1000])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_kernels_match_the_pallas_kernels(v, smoothing):
    x, lab, g = _case(19, v, seed=v)
    lab[2] = -1                      # matches no column: x_y is 0
    loss_j, lse_j = JX.xent_fwd(jnp.asarray(x), jnp.asarray(lab), smoothing)
    dx_j = JX.xent_bwd(jnp.asarray(x), jnp.asarray(lab), lse_j,
                       jnp.asarray(g), smoothing)
    xt, labt = torch.from_numpy(x), torch.from_numpy(lab)
    loss, lse = XE.xent_fwd(xt, labt, smoothing)
    dx = XE.xent_bwd(xt, labt, lse, torch.from_numpy(g), smoothing)
    assert loss.dtype == lse.dtype == torch.float32 and dx.dtype == xt.dtype
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **TOL)


@pytest.mark.parametrize("labels", [np.int32, np.int64])
def test_plain_versions_follow_their_definition(labels):
    """float64 oracle: loss = lse − (1−ε)·x_y − ε·mean(x) and
    dx = g·(softmax − (1−ε)·onehot − ε/V)."""
    x, lab, g = _case(8, 37, seed=3)
    eps = 0.1
    xt = torch.from_numpy(x)
    labt = torch.from_numpy(lab.astype(labels))
    loss, lse = XE.xent_fwd_plain(xt, labt, eps)
    dx = XE.xent_bwd_plain(xt, labt, lse, torch.from_numpy(g), eps)
    xd = xt.double()
    lse64 = torch.logsumexp(xd, -1)
    onehot = torch.nn.functional.one_hot(labt.long(), 37).double()
    want = lse64 - (1 - eps) * (xd * onehot).sum(-1) - eps * xd.mean(-1)
    want_dx = torch.from_numpy(g).double()[:, None] * (
        torch.softmax(xd, -1) - (1 - eps) * onehot - eps / 37)
    torch.testing.assert_close(loss.double(), want, **TOL)
    torch.testing.assert_close(dx.double(), want_dx, **TOL)


@pytest.mark.parametrize("v", [37, 1000])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("padding_idx", [0, None])
def test_loss_and_grad_match_jax(v, smoothing, padding_idx):
    x, lab, g = _case(23, v, seed=2 * v + 1)
    want, vjp = jax.vjp(lambda a: j_loss(a, jnp.asarray(lab), smoothing,
                                         padding_idx), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = softmax_cross_entropy_loss(xt, torch.from_numpy(lab), smoothing,
                                     padding_idx)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **TOL)
    pad = torch.from_numpy(lab == 0)
    if padding_idx is None:
        assert got[pad].abs().min() > 0
    else:
        assert not got[pad].any() and not dx[pad].any()


@pytest.mark.parametrize("half_to_float", [False, True])
def test_half_to_float(half_to_float):
    """bf16 logits: the losses keep bf16 unless ``half_to_float``; the
    gradient is bf16."""
    x, lab, g = _case(16, 1000, seed=5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, vjp = jax.vjp(lambda a: j_loss(a, jnp.asarray(lab), 0.1, 0,
                                         half_to_float), xb)
    (dx_j,) = vjp(jnp.asarray(g).astype(want.dtype))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True)
    got = SoftmaxCrossEntropyLoss.apply(xt, torch.from_numpy(lab), 0.1, 0,
                                        half_to_float)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g).to(got.dtype))
    assert got.dtype == (torch.float32 if half_to_float else torch.bfloat16)
    assert dx.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **(TOL if half_to_float else BF16))
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(dx_j.astype(jnp.float32)), **BF16)


def test_residuals_are_logits_lse_and_labels():
    """The backward recomputes the softmax from the fp32 logsumexp: the
    Function keeps the logits, lse [N] and the labels, no [N, V] softmax
    (softmax_xentropy.py:86-93)."""
    x, lab, _ = _case(6, 37, seed=7)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = softmax_cross_entropy_loss(xt, torch.from_numpy(lab), 0.1)
    saved = loss.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(6, 37), (6,), (6,)]
    assert saved[0] is xt or saved[0].data_ptr() == xt.data_ptr()
    assert saved[1].dtype == torch.float32


def test_leading_dims_and_cpu_wrappers_launch_nothing():
    """[B, T, V] logits against [B, T] labels, as the Seq2Seq loss's
    reshape leaves them; on the CPU no kernel launches."""
    x, lab, g = _case(12, 37, seed=9)
    before = XE.xent_fwd.launches, XE.xent_bwd.launches
    xt = torch.from_numpy(x).requires_grad_(True)
    flat = softmax_cross_entropy_loss(xt, torch.from_numpy(lab), 0.1)
    x3 = torch.from_numpy(x.reshape(3, 4, 37)).requires_grad_(True)
    got = softmax_cross_entropy_loss(x3, torch.from_numpy(lab.reshape(3, 4)),
                                     0.1)
    assert got.shape == (3, 4)
    torch.testing.assert_close(got.reshape(-1), flat, atol=0, rtol=0)
    (dx,) = torch.autograd.grad(got.sum(), x3)
    assert dx.shape == (3, 4, 37)
    assert (XE.xent_fwd.launches, XE.xent_bwd.launches) == before



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_label_logits_match_jax_select(dtype):
    """The one label pick (``ops.xentropy.label_logits``, re-exported as
    ``select_label_logits`` for the RN50 loss) against JAX's
    ``select_label_logits`` on [3, 4, 37] logits with labels at 0, V − 1,
    −1 and V (the last two match no column): values and the gradient
    exactly (each is one logit or 0, no sum of terms)."""
    x, lab, _ = _case(12, 37, seed=11)
    lab[3], lab[5] = -1, 37
    x3, lab3 = x.reshape(3, 4, 37), lab.reshape(3, 4)
    w = np.random.RandomState(12).randn(3, 4).astype(np.float32)
    jdt = getattr(jnp, dtype)
    got_j, vjp = jax.vjp(lambda a: j_select(a, jnp.asarray(lab3)),
                         jnp.asarray(x3, jdt))
    (dx_j,) = vjp(jnp.asarray(w))
    xt = torch.from_numpy(x3).to(getattr(torch, dtype)).requires_grad_(True)
    got = select_label_logits(xt, torch.from_numpy(lab3))
    assert select_label_logits is XE.label_logits
    assert got.dtype == torch.float32 and got.shape == (3, 4)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(w))
    assert dx.dtype == xt.dtype
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(got_j))
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(dx_j.astype(jnp.float32)))
    assert not got[0, 3] and not got[1, 1]
