"""Port parity: LayerNorm forward.

The port's plain version (what ``ops.layer_norm.ln_fwd`` runs for a CPU
tensor, and what the CUDA kernel is held against on the card) against the
JAX package's Pallas forward kernel in interpret mode (``ln_fwd`` and
``fused_layer_norm_affine`` under ``dispatch.backend("pallas")``, as
tests/test_fused_layer_norm.py runs it), on the same numpy inputs: y,
mean and invvar. Tolerances: 1e-5 in f32 (the reductions sum in another
order); for bf16 input one bf16 ulp of y (8e-3 relative), since an fp32
value a rounding apart can land on either side of a bf16 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import fused_layer_norm_affine as j_ln
from apex_tpu.ops import dispatch as jdispatch
from apex_tpu.ops.pallas import layer_norm as JP
from apex_tpu_torch.normalization import (FusedLayerNorm, fused_layer_norm,
                                          fused_layer_norm_affine)
from apex_tpu_torch.ops import layer_norm as OPS

ROWS = 37      # ragged: not a multiple of any block


def _data(f, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(ROWS, f) * 3.0 + 0.5).astype(np.float32)
    w = (rng.randn(f) + 1.0).astype(np.float32)
    b = np.linspace(-1, 1, f).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("f", [256, 1024])
def test_plain_matches_jax_pallas_f32(f):
    x, w, b = _data(f)
    with jdispatch.backend("pallas"):
        y_j, mean_j, inv_j = JP.ln_fwd(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), 1e-5)
    y, mean, inv = OPS.ln_fwd(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), 1e-5)
    assert y.dtype == torch.float32 and mean.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_j), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("f", [256, 1024])
def test_plain_matches_jax_pallas_bf16_input(f):
    x, w, b = _data(f, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    with jdispatch.backend("pallas"):
        y_j, mean_j, inv_j = JP.ln_fwd(xb, jnp.asarray(w), jnp.asarray(b),
                                       1e-5)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    y, mean, inv = OPS.ln_fwd(xt, torch.from_numpy(w), torch.from_numpy(b),
                              1e-5)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j, np.float32),
                               atol=8e-3, rtol=8e-3)
    # the statistics are fp32 of the same bf16 inputs
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_j), atol=1e-5,
                               rtol=1e-5)


def test_functional_affine_matches_jax_on_3d_input():
    """The model's call shape: [B, T, E] normalized over E, eps 1e-5."""
    x, w, b = _data(256, seed=2)
    x3 = x[:36].reshape(4, 9, 256)
    with jdispatch.backend("pallas"):
        want = j_ln(jnp.asarray(x3), (256,), jnp.asarray(w), jnp.asarray(b),
                    1e-5)
    got = fused_layer_norm_affine(torch.from_numpy(x3), (256,),
                                  torch.from_numpy(w), torch.from_numpy(b),
                                  1e-5)
    assert got.shape == (4, 9, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_non_affine_and_module_forms():
    x, _, _ = _data(256, seed=3)
    xt = torch.from_numpy(x)
    plain = fused_layer_norm(xt, 256, eps=1e-5)
    mod = FusedLayerNorm(256, eps=1e-5, device="cpu")
    np.testing.assert_array_equal(mod(xt).detach().numpy(), plain.numpy())
    mod_plain = FusedLayerNorm(256, eps=1e-5, elementwise_affine=False,
                               device="cpu")
    np.testing.assert_array_equal(mod_plain(xt).numpy(), plain.numpy())
    with jdispatch.backend("pallas"):
        y_j, _, _ = JP.ln_fwd(jnp.asarray(x), None, None, 1e-5)
    np.testing.assert_allclose(plain.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=1e-5)


def test_cpu_tensors_launch_nothing_and_shape_errors_raise():
    x, w, b = _data(256, seed=4)
    before = OPS.ln_fwd.launches
    OPS.ln_fwd(torch.from_numpy(x), torch.from_numpy(w),
               torch.from_numpy(b), 1e-5)
    assert OPS.ln_fwd.launches == before
    with pytest.raises(ValueError, match="normalized_shape"):
        fused_layer_norm(torch.from_numpy(x), (128,))


# -- backward ---------------------------------------------------------------
#
# The port's ln_bwd plain version and its autograd Function against the JAX
# package's Pallas backward kernel in interpret mode (``ln_bwd`` and the
# custom VJP ``_ln_affine_bwd`` / ``_ln_plain_bwd`` under
# ``dispatch.backend("pallas")``). Tolerances as above: 1e-5 in f32; one
# bf16 ulp of dx for bf16 input (the fp32 column sums stay within 1e-5 of
# each column's magnitude: both sum fp32 terms of the same bf16 inputs).

@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("f", [256, 1024])
def test_ln_bwd_plain_matches_jax_pallas(f, affine):
    x, w, _ = _data(f, seed=5)
    dy = np.random.RandomState(6).randn(ROWS, f).astype(np.float32)
    _, mean, inv = OPS.ln_fwd(torch.from_numpy(x), None, None, 1e-5)
    wj = jnp.asarray(w) if affine else None
    with jdispatch.backend("pallas"):
        want = JP.ln_bwd(jnp.asarray(dy), jnp.asarray(x), wj,
                         jnp.asarray(mean.numpy()), jnp.asarray(inv.numpy()))
    got = OPS.ln_bwd(torch.from_numpy(dy), torch.from_numpy(x),
                     torch.from_numpy(w) if affine else None, mean, inv)
    assert len(want) == (3 if affine else 1)
    assert (got[1] is None) == (not affine)
    for g, j in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_affine_matches_jax_vjp(dtype):
    """The model's call: [B, T, E] through ``fused_layer_norm_affine``;
    dx in x's dtype, the gamma/beta grads in theirs (fp32 here)."""
    x, w, b = _data(256, seed=7)
    x3 = x[:36].reshape(4, 9, 256)
    dy = np.random.RandomState(8).randn(4, 9, 256).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj, dyj = jnp.asarray(x3, jdt), jnp.asarray(dy, jdt)
    with jdispatch.backend("pallas"):
        _, vjp = jax.vjp(lambda a, g_, b_: j_ln(a, (256,), g_, b_, 1e-5),
                         xj, jnp.asarray(w), jnp.asarray(b))
        dx_j, dw_j, db_j = vjp(dyj)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(tdt)
    wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (w, b))
    xt.requires_grad_(True)
    y = fused_layer_norm_affine(xt, (256,), wt, bt, 1e-5)
    dx, dw, db = torch.autograd.grad(
        y, (xt, wt, bt), torch.from_numpy(np.array(dyj, np.float32)).to(tdt))
    assert dx.dtype == tdt and dw.dtype == db.dtype == torch.float32
    tol = 8e-3 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(dx_j, np.float32), atol=tol,
                               rtol=tol)
    # the column sums add 36 fp32 terms: a few fp32 ulps of their scale
    for g, j in ((dw, dw_j), (db, db_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)


def test_autograd_non_affine_and_weight_dtype():
    """Non-affine backward against JAX's ``_ln_plain_bwd``; bf16 gamma and
    beta get their grads back in bf16 (``_ln_affine_bwd``'s casts)."""
    from apex_tpu.normalization import fused_layer_norm as j_plain
    x, w, b = _data(256, seed=9)
    dy = np.random.RandomState(10).randn(ROWS, 256).astype(np.float32)
    with jdispatch.backend("pallas"):
        _, vjp = jax.vjp(lambda a: j_plain(a, (256,), 1e-5), jnp.asarray(x))
        (dx_j,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(fused_layer_norm(xt, 256, eps=1e-5), xt,
                                torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-5,
                               rtol=1e-5)
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    bt = torch.from_numpy(b).to(torch.bfloat16).requires_grad_(True)
    y = fused_layer_norm_affine(torch.from_numpy(x), (256,), wt, bt, 1e-5)
    dw, db = torch.autograd.grad(y, (wt, bt), torch.from_numpy(dy))
    assert dw.dtype == db.dtype == torch.bfloat16


def test_ln_bwd_cpu_launches_nothing():
    x, w, _ = _data(256, seed=11)
    xt = torch.from_numpy(x)
    _, mean, inv = OPS.ln_fwd(xt, None, None, 1e-5)
    before = OPS.ln_bwd.launches
    OPS.ln_bwd(xt, xt, torch.from_numpy(w), mean, inv)
    assert OPS.ln_bwd.launches == before
