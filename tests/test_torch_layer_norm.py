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
