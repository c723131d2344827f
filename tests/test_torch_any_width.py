"""Port parity: LayerNorm and BatchNorm at widths the vector kernels do not
take (F or C not a multiple of 4).

The kernels take such rows through their scalar forms on the card
(tests/test_torch_cuda.py); here the wrappers run their plain versions on
the CPU and are held against the JAX package on the same numpy inputs:
``FusedLayerNorm(1022)`` forward and gradients against ``jax.vjp`` of
``fused_layer_norm_affine`` (its Pallas kernels in interpret mode), the
wide path at a width over 8192 that is not a multiple of 4, and
``SyncBatchNorm(6)``'s training core against ``_bn_train``'s vjp. The
welford grid's row chunks are a function of the width alone, whatever
form the C side picks from the buffers (``ops.welford._chunks``),
checked here too.

Tolerances: f32 1e-5 forward and 1e-4 for the gradients (the reductions
sum in another order; the column sums add 24 rows); bf16 2e-2 (a value an
fp32 rounding apart lands on either side of a bf16 step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import fused_layer_norm_affine as j_ln
from apex_tpu.ops import dispatch as jdispatch
from apex_tpu.parallel import sync_batchnorm as JBN
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import layer_norm as LN
from apex_tpu_torch.ops import welford as WF
from apex_tpu_torch.parallel.sync_batchnorm import bn_train

TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _ln_case(f, dtype, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(2, 12, f) * 2.0 + 0.3).astype(np.float32)
    w = (rs.randn(f) + 1.0).astype(np.float32)
    b = rs.randn(f).astype(np.float32)
    dy = rs.randn(2, 12, f).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    with jdispatch.backend("pallas"):
        y_j, vjp = jax.vjp(lambda a, g, c: j_ln(a, (f,), g, c, 1e-5), xj,
                           jnp.asarray(w), jnp.asarray(b))
        dx_j, dw_j, db_j = vjp(dyj)
    ln = FusedLayerNorm(f, device="cpu")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    xt = _t(xj, dtype).requires_grad_(True)
    y = ln(xt)
    dx, dw, db = torch.autograd.grad(y, (xt, ln.weight, ln.bias),
                                     _t(dyj, dtype))
    fwd, bwd = TOL[dtype]
    for got, want, tol in ((y, y_j, fwd), (dx, dx_j, bwd), (dw, dw_j, bwd),
                           (db, db_j, bwd)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layer_norm_1022_matches_jax(dtype):
    _ln_case(1022, dtype, seed=3)


def test_wide_layer_norm_not_a_multiple_of_4_matches_jax():
    """F 8194 > F_SINGLE_MAX: the wide path, F % 4 == 2."""
    _ln_case(8194, "float32", seed=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True], ids=["norelu", "relu"])
def test_sync_batchnorm_6_channels_matches_jax(relu, dtype):
    rs = np.random.RandomState(5)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(rs.randn(4, 5, 6, 6) * 2.0 + 0.5, jdt)
    z = jnp.asarray(rs.randn(4, 5, 6, 6), jdt)
    dy = jnp.asarray(rs.randn(4, 5, 6, 6), jdt)
    w = jnp.asarray(rs.rand(6) + 0.5, jnp.float32)
    b = jnp.asarray(rs.randn(6), jnp.float32)

    def jfwd(x, z, w, b):
        out, mean, var, _ = JBN._bn_train(x, z, w, b, 1e-5, None, None,
                                          relu, -1)
        return out, (mean, var)

    out_j, vjp, (mean_j, var_j) = jax.vjp(jfwd, x, z, w, b, has_aux=True)
    grads_j = vjp(dy)
    xt, zt = (_t(a, dtype).requires_grad_(True) for a in (x, z))
    wt, bt = (_t(a, "float32").requires_grad_(True) for a in (w, b))
    out, mean, var, _ = bn_train(xt, zt, wt, bt, 1e-5, relu, -1)
    grads = torch.autograd.grad(out, (xt, zt, wt, bt), _t(dy, dtype))
    fwd, bwd = TOL[dtype]
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(out_j, np.float32), atol=fwd,
                               rtol=fwd)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), atol=1e-5,
                               rtol=1e-5)
    for i, (got, want) in enumerate(zip(grads, grads_j)):
        tol = bwd * (10 if i >= 2 else 1)      # dw, db: sums of 144 terms
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("c", [1, 6, 7, 8, 64, 2048])
def test_welford_chunks_follow_the_width(c, monkeypatch):
    """The row chunks (and with them the sums' order) depend on the shape
    alone: C / 4 vectors 32 threads across where C is a multiple of 4 (the
    vector form's count), C channels otherwise (the scalar form's)."""
    monkeypatch.setattr(WF, "_sm_count", lambda device: 132)
    rows = 256 * 56 * 56
    n = WF._chunks(rows, c, None)
    vecs = c // 4 if c % 4 == 0 else c
    tx = min(32, vecs)
    want = -(-8 * 132 // -(-vecs // tx))
    assert n == max(1, min(want, -(-rows // (8 * (256 // tx))), 65535))
    assert WF._chunks(1, c, None) == 1


@pytest.mark.parametrize("c", [1, 6, 7, 12])
def test_welford_plain_sums_any_width(c):
    """The wrappers run any C on the CPU: the sums equal float64's."""
    rs = np.random.RandomState(c)
    x = torch.from_numpy(rs.randn(33, c).astype(np.float32))
    s, q = WF.bn_moments(x)
    xd = x.double()
    np.testing.assert_allclose(s.numpy(), xd.sum(0).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(q.numpy(), (xd * xd).sum(0).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f", [1, 3, 1022, 9218])
def test_layer_norm_wrappers_take_any_width_on_the_cpu(f):
    x = torch.from_numpy(np.random.RandomState(f).randn(5, f)
                         .astype(np.float32))
    y, mean, inv = LN.ln_fwd(x, None, None, 1e-5)
    y0, mean0, inv0 = LN.ln_fwd_plain(x, None, None, 1e-5)
    assert torch.equal(y, y0) and torch.equal(mean, mean0)
    dx, gw, gb = LN.ln_bwd(torch.ones_like(x), x, None, mean, inv)
    assert dx.shape == x.shape and gw is None and gb is None
