"""Port parity: the SyncBatchNorm training core with local statistics.

The port's ``SyncBatchNorm(axis_name=None)`` against the JAX package's, on
the same numpy inputs: forward ``out``, batch mean and var, and the
backward ``dx``, ``dz``, ``dw``, ``db`` against ``jax.vjp``, with
``fuse_relu`` and the residual ``z`` on and off, f32 and bf16
activations, channels-last (NHWC, ``channel_axis=-1``) and the port's
NCHW-in-channels_last layout (``channel_axis=1``, what the ResNet uses);
then the running-stat update (momentum 0.1 and the cumulative
``momentum=None``) and the eval path.

Tolerances: f32 1e-5 forward and 1e-4 backward (the sums run in another
order; dx subtracts two sums of 120 values); bf16 2e-2 (a value an fp32
rounding apart can land on either side of a bf16 step, as in
tests/test_pallas_kernels.py:30-32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.parallel import sync_batchnorm as JBN
from apex_tpu_torch.parallel import SyncBatchNorm
from apex_tpu_torch.parallel.sync_batchnorm import bn_train

N, H, W, C = 4, 5, 6, 8
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


def _inputs(seed, name):
    rs = np.random.RandomState(seed)
    jdt = jnp.float32 if name == "float32" else jnp.bfloat16
    x = jnp.asarray(rs.randn(N, H, W, C) * 2.0 + 0.5, jdt)
    z = jnp.asarray(rs.randn(N, H, W, C), jdt)
    dy = jnp.asarray(rs.randn(N, H, W, C), jdt)
    w = jnp.asarray(rs.rand(C) + 0.5, jnp.float32)
    b = jnp.asarray(rs.randn(C), jnp.float32)
    return x, z, dy, w, b


def _t(a, nchw=False):
    t = torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    return t.permute(0, 3, 1, 2) if nchw else t


def _np(t, nchw=False):
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if nchw else t).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_z", [False, True], ids=["noz", "z"])
@pytest.mark.parametrize("relu", [False, True], ids=["norelu", "relu"])
def test_forward_and_backward_match_jax(relu, use_z, name, nchw):
    x, z, dy, w, b = _inputs(0, name)
    zj = z if use_z else None

    def jfwd(x, z, w, b):
        out, mean, var, _ = JBN._bn_train(x, z, w, b, 1e-5, None, None,
                                          relu, -1)
        return out, (mean, var)

    out_j, vjp, (mean_j, var_j) = jax.vjp(jfwd, x, zj, w, b, has_aux=True)
    dx_j, dz_j, dw_j, db_j = vjp(dy)

    ca = 1 if nchw else -1
    xt = _t(x, nchw).requires_grad_(True)
    zt = _t(z, nchw).requires_grad_(True) if use_z else None
    wt = _t(w).requires_grad_(True)
    bt = _t(b).requires_grad_(True)
    out, mean, var, count = bn_train(xt, zt, wt, bt, 1e-5, relu, ca)
    assert out.dtype == xt.dtype and mean.dtype == torch.float32
    assert count == N * H * W
    grads = torch.autograd.grad(
        out, [t for t in (xt, zt, wt, bt) if t is not None], _t(dy, nchw))
    fwd_tol, bwd_tol = TOL[name]
    _close(_np(out, nchw), out_j, fwd_tol)
    _close(mean.numpy(), mean_j, 1e-5)
    _close(var.numpy(), var_j, 1e-5)
    dx, *rest = grads
    dz = rest.pop(0) if use_z else None
    dw, db = rest
    assert dx.dtype == xt.dtype and dw.dtype == torch.float32
    _close(_np(dx, nchw), dx_j, bwd_tol)
    if use_z:
        _close(_np(dz, nchw), dz_j, bwd_tol)
    _close(dw.numpy(), dw_j, bwd_tol * 10)  # sums of 120 products
    _close(db.numpy(), db_j, bwd_tol * 10)


@pytest.mark.parametrize("momentum", [0.1, None])
def test_running_stats_and_eval_match_jax(momentum):
    x, z, _, w, b = _inputs(1, "float32")
    jbn = JBN.SyncBatchNorm(C, momentum=momentum, fuse_relu=True,
                            axis_name=None)
    tbn = SyncBatchNorm(C, momentum=momentum, fuse_relu=True,
                        axis_name=None, channel_axis=1)
    jp = {"weight": w, "bias": b}
    tp = {"weight": _t(w), "bias": _t(b)}
    _, jst = jbn.init()
    _, tst = tbn.init("cpu")
    for scale in (1.0, 3.0):                 # two batches: cumulative avg
        _, jst = jbn.apply(jp, jst, x * scale, z=z, training=True)
        _, tst = tbn.apply(tp, tst, _t(x, True) * scale, z=_t(z, True),
                           training=True)
    for k in ("running_mean", "running_var"):
        _close(tst[k].numpy(), jst[k], 1e-5)
    assert int(tst["num_batches_tracked"]) == int(jst["num_batches_tracked"])
    out_j, _ = jbn.apply(jp, jst, x, z=z, training=False)
    out_t, same = tbn.apply(tp, tst, _t(x, True), z=_t(z, True),
                            training=False)
    assert same is tst
    _close(_np(out_t, True), out_j, 1e-5)


def test_cross_replica_and_unaffine_forms():
    # axis_name defaults to "data": cross-replica statistics, which need
    # the axis bound to a process group (tests/test_torch_sync_batchnorm_
    # dist.py runs them on gloo ranks); unbound, training mode says so
    bn = SyncBatchNorm(8)
    assert bn.axis_name == "data"
    with pytest.raises(RuntimeError, match="not bound"):
        bn.apply(*bn.init("cpu"), torch.ones(2, 8))
    x, _, dy, _, _ = _inputs(2, "float32")
    jbn = JBN.SyncBatchNorm(C, affine=False, track_running_stats=False,
                            axis_name=None)
    tbn = SyncBatchNorm(C, affine=False, track_running_stats=False,
                        axis_name=None)
    out_j, _ = jbn.apply({}, {}, x)
    xt = _t(x).requires_grad_(True)
    out_t, st = tbn.apply({}, {}, xt)
    assert st == {}
    _close(_np(out_t), out_j, 1e-5)
    (dx,) = torch.autograd.grad(out_t, xt, _t(dy))
    dx_j = jax.vjp(lambda x: jbn.apply({}, {}, x)[0], x)[1](dy)[0]
    _close(_np(dx), dx_j, 1e-4)
