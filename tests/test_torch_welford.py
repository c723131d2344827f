"""Port parity: the BatchNorm welford passes (``apex_tpu_torch.ops.welford``).

The plain versions — what a CPU tensor runs, and what the CUDA kernels are
held against on the card — against the JAX package's Pallas kernels
(``apex_tpu/ops/pallas/welford.py``) in interpret mode, on the same numpy
``[rows, C]`` inputs: ``bn_moments``, ``bn_backward_fused_reduce``,
``bn_backward_dx`` (with the relu mask and ``dz`` on and off) and
``bn_backward_reduce``, f32 and bf16. Then the whole training BN through
JAX's welford route (dispatch backend "pallas") against the port's
``bn_train``, which runs these passes.

Tolerances: the sums 1e-5 relative to the sum of |terms| of their column
(fp32 sums of 300 values in another order); dx and dz f32 1e-5 and bf16
2e-2 (one bf16 rounding of the output, as tests/test_pallas_kernels.py:
30-32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import dispatch as jdispatch
from apex_tpu.ops.pallas import welford as W
from apex_tpu.parallel import sync_batchnorm as JBN
from apex_tpu_torch.ops import welford as WF
from apex_tpu_torch.parallel.sync_batchnorm import bn_train

ROWS = 300          # a ragged final block for the Pallas kernels
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, name):
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


def _case(c, name, seed=0):
    rs = np.random.RandomState(seed)
    x = _pair(rs.randn(ROWS, c) * 2.0 + 0.5, name)
    dy = _pair(rs.randn(ROWS, c), name)
    out = _pair(np.maximum(rs.randn(ROWS, c), 0.0), name)   # relu output
    mean = rs.randn(c).astype(np.float32) * 0.1 + 0.5
    invvar = (rs.rand(c) + 0.5).astype(np.float32)
    return x, dy, out, mean, invvar


def _sum_close(got, want, terms):
    """|got − want| within 1e-5 of each column's sum of |terms|."""
    bound = 1e-5 * np.abs(terms).sum(axis=0) + 1e-6
    err = np.abs(got.numpy() - np.asarray(want, np.float32))
    assert (err <= bound).all(), float((err / bound).max())


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("name", list(DTYPES))
def test_moments_match_pallas(c, name):
    (xj, xt), *_ = _case(c, name)
    s, sq = WF.bn_moments(xt)
    assert s.dtype == sq.dtype == torch.float32 and s.shape == (c,)
    js, jsq = W.bn_moments(xj)
    xf = _f32(xt)
    _sum_close(s, js, xf)
    _sum_close(sq, jsq, xf * xf)


@pytest.mark.parametrize("relu", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_backward_reduce_matches_pallas(relu, name):
    (xj, xt), (dj, dt), (oj, ot), mean, invvar = _case(128, name, seed=1)
    got = WF.bn_backward_fused_reduce(
        dt, xt, torch.from_numpy(mean), torch.from_numpy(invvar),
        ot if relu else None)
    want = W.bn_backward_fused_reduce(dj, xj, jnp.asarray(mean),
                                      jnp.asarray(invvar),
                                      oj if relu else None)
    dyf = _f32(dt) * ((_f32(ot) > 0) if relu else 1.0)
    xhat = (_f32(xt) - mean) * invvar
    _sum_close(got[0], want[0], dyf)
    _sum_close(got[1], want[1], dyf * xhat)


@pytest.mark.parametrize("name", list(DTYPES))
def test_backward_reduce_from_xhat_matches_pallas(name):
    """``bn_backward_reduce`` at tools/tpu_smoke.py's [1000, 256]: dy and
    the materialized xhat in one dtype, and fp32 dy beside a bf16-derived
    xhat as tpu_smoke passes them."""
    rs = np.random.RandomState(4)
    dj, dt = _pair(rs.randn(1000, 256), name)
    xj, xt = _pair(rs.randn(1000, 256), name)
    fj, ft = _pair(np.asarray(xj, np.float32), "float32")
    for (dyj, dyt), (xhj, xht) in (((dj, dt), (xj, xt)), ((fj, ft),
                                                          (xj, xt))):
        before = WF.bn_backward_reduce.launches
        sdy, sdx = WF.bn_backward_reduce(dyt, xht)
        assert WF.bn_backward_reduce.launches == before   # CPU: plain
        assert sdy.dtype == sdx.dtype == torch.float32 and sdy.shape == (256,)
        jdy, jdx = W.bn_backward_reduce(dyj, xhj)
        _sum_close(sdy, jdy, _f32(dyt))
        _sum_close(sdx, jdx, _f32(dyt) * _f32(xht))


@pytest.mark.parametrize("emit_dz", [False, True], ids=["nodz", "dz"])
@pytest.mark.parametrize("relu", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_backward_dx_matches_pallas(emit_dz, relu, name):
    (xj, xt), (dj, dt), (oj, ot), mean, invvar = _case(256, name, seed=2)
    rs = np.random.RandomState(3)
    winv, mdy, mdx = (rs.randn(256).astype(np.float32) for _ in range(3))
    chan = [mean, invvar, winv, mdy, mdx]
    dx, dz = WF.bn_backward_dx(dt, xt, *map(torch.from_numpy, chan),
                               ot if relu else None, emit_dz=emit_dz)
    jdx, jdz = W.bn_backward_dx(dj, xj, *map(jnp.asarray, chan),
                                oj if relu else None, emit_dz=emit_dz)
    tol = 2e-2 if name == "bfloat16" else 1e-5
    assert dx.dtype == xt.dtype
    np.testing.assert_allclose(_f32(dx), np.asarray(jdx, np.float32),
                               rtol=tol, atol=tol)
    if emit_dz:
        # the masked dy, cast: exact in both
        np.testing.assert_array_equal(_f32(dz), np.asarray(jdz, np.float32))
    else:
        assert dz is None and jdz is None


@pytest.mark.parametrize("use_z", [False, True], ids=["noz", "z"])
@pytest.mark.parametrize("relu", [False, True], ids=["norelu", "relu"])
def test_bn_train_matches_the_pallas_route(relu, use_z):
    """The port's BN core (the welford passes) against JAX's
    ``_bn_train`` with the Pallas welford kernels (C = 128, channels
    last, f32), forward and backward."""
    rs = np.random.RandomState(4)
    shape = (2, 5, 6, 128)
    x, z, dy = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    w = (rs.rand(128) + 0.5).astype(np.float32)
    b = rs.randn(128).astype(np.float32)

    def jfwd(x, z, w, b):
        out, mean, var, _ = JBN._bn_train(x, z, w, b, 1e-5, None, None,
                                          relu, -1)
        return out, (mean, var)

    with jdispatch.backend("pallas"):
        assert JBN._use_pallas_bn(jnp.asarray(x), -1)
        out_j, vjp, (mean_j, var_j) = jax.vjp(
            jfwd, jnp.asarray(x), jnp.asarray(z) if use_z else None,
            jnp.asarray(w), jnp.asarray(b), has_aux=True)
        dx_j, dz_j, dw_j, db_j = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, z, w, b)]
    out, mean, var, _ = bn_train(ts[0], ts[1] if use_z else None, ts[2],
                                 ts[3], 1e-5, relu, -1)
    grads = torch.autograd.grad(
        out, [t for i, t in enumerate(ts) if use_z or i != 1],
        torch.from_numpy(dy))
    for got, want in ((out, out_j), (mean, mean_j), (var, var_j)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    want = [dx_j] + ([dz_j] if use_z else []) + [dw_j, db_j]
    for i, (got, w_) in enumerate(zip(grads, want)):
        tol = 1e-4 if i < len(want) - 2 else 1e-3   # dw, db: sums of 60
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), rtol=tol,
                                   atol=tol)
