"""Port parity: cross-replica ``SyncBatchNorm`` on 4 gloo ranks against
``apex_tpu.parallel.SyncBatchNorm`` under ``shard_map`` over 4 of the
conftest's 8 CPU devices, and against BatchNorm over the global batch.

Covers the JAX tests' cases (``tests/test_parallel.py``) at their
tolerances: the forward and running statistics equal global-batch BN
(1e-5), the backward equal JAX's custom vjp and global autodiff (x 1e-5,
weight and bias 1e-4), sub-groups (each pair's own statistics), the fused
add + relu, NCHW, eval on running statistics, cumulative momentum, and the
reference signature's errors. The weight and bias grads: the port leaves
them local, so DDP's average is the one reduction; it equals JAX's under
both vma modes (``check_vma=True``, where the vjp sums them, and
``False``, where DDP does), 1e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu import parallel as JP
from apex_tpu_torch.parallel import SyncBatchNorm
from apex_tpu_torch.parallel import create_syncbn_process_group

WORLD = 4
GROUPS = ((0, 1), (2, 3))


def _jmesh():
    return JP.make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])


def _local_bn(x, axes, eps=1e-5):
    mean = np.mean(x, axis=axes, keepdims=True)
    var = np.var(x, axis=axes, keepdims=True)
    return (x - mean) / np.sqrt(var + eps)


def _cat(got, key):
    return np.concatenate([r[key] for r in got])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rs = np.random.RandomState(0)
    inp = dict(fwd_x=rs.randn(16, 5, 6).astype(np.float32),
               bwd_x=np.random.RandomState(3).randn(8, 3, 4).astype(
                   np.float32),
               grp_x=np.random.RandomState(4).randn(16, 2).astype(
                   np.float32),
               relu_x=rs.randn(8, 4).astype(np.float32),
               relu_z=rs.randn(8, 4).astype(np.float32),
               relu_dy=rs.randn(8, 4).astype(np.float32),
               nchw_x=np.random.RandomState(6).randn(8, 5, 3, 3).astype(
                   np.float32),
               vma_x=np.asarray(jax.random.normal(jax.random.key(2),
                                                  (32, 4, 4, 16))),
               vma_y=np.asarray(jax.random.normal(jax.random.key(3),
                                                  (32, 4, 4, 16))))
    return inp, D.run_ranks(D.syncbn_ops, WORLD,
                            tmp_path_factory.mktemp("bn"), **inp)


def test_forward_and_running_stats_match_the_global_batch(case):
    inp, got = case
    x = inp["fwd_x"]
    bn = JP.SyncBatchNorm(6, axis_name="data")
    params, state = bn.init()
    y, jst = jax.shard_map(
        lambda p, s, x: bn.apply(p, s, x, training=True), mesh=_jmesh(),
        in_specs=(P(), P(), P("data")), out_specs=(P("data"), P()),
        check_vma=False)(params, state, jnp.asarray(x))
    np.testing.assert_allclose(_cat(got, "fwd_y"), y, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_cat(got, "fwd_y"), _local_bn(x, (0, 1)),
                               atol=1e-5, rtol=1e-5)
    for r in got:
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[f"fwd_{k}"], jst[k], atol=1e-5)
        assert int(r["fwd_num_batches_tracked"]) == 1
    gv = np.var(x, axis=(0, 1)) * 80 / 79
    np.testing.assert_allclose(got[0]["fwd_running_var"], 0.9 + 0.1 * gv,
                               atol=1e-5)


def test_cumulative_momentum_over_two_batches(case):
    inp, got = case
    x = jnp.asarray(inp["fwd_x"])
    bn = JP.SyncBatchNorm(6, momentum=None, axis_name="data")
    params, state = bn.init()

    def two(p, s, x):
        _, s = bn.apply(p, s, x, training=True)
        return bn.apply(p, s, x * 3.0, training=True)[1]

    jst = jax.shard_map(two, mesh=_jmesh(), in_specs=(P(), P(), P("data")),
                        out_specs=P(), check_vma=False)(params, state, x)
    for r in got:
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[f"cum_{k}"], jst[k], atol=1e-5)
        assert int(r["cum_num_batches_tracked"]) == 2


def test_backward_matches_jax_and_global_autodiff(case):
    inp, got = case
    x = jnp.asarray(inp["bwd_x"])
    bn = JP.SyncBatchNorm(4, axis_name="data", track_running_stats=False)
    params, state = bn.init()

    def dist_grads(params, x):
        def loss(p, xs):
            y, _ = bn.apply(p, state, xs, training=True)
            return jax.lax.psum(jnp.sum(jnp.sin(y)), "data")
        return jax.grad(loss, argnums=(0, 1))(params, x)

    gp, gx = jax.shard_map(dist_grads, mesh=_jmesh(),
                           in_specs=(P(), P("data")),
                           out_specs=(P(), P("data")))(params, x)

    def global_loss(p, x):
        mean = jnp.mean(x, axis=(0, 1), keepdims=True)
        var = jnp.mean((x - mean) ** 2, axis=(0, 1), keepdims=True)
        out = (x - mean) * jax.lax.rsqrt(var + bn.eps) * p["weight"] \
            + p["bias"]
        return jnp.sum(jnp.sin(out))

    gp_want, gx_want = jax.grad(global_loss, argnums=(0, 1))(params, x)
    np.testing.assert_allclose(_cat(got, "bwd_gx"), gx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_cat(got, "bwd_gx"), gx_want, atol=1e-5,
                               rtol=1e-5)
    for r in got:
        np.testing.assert_allclose(r["bwd_gw"], gp["weight"], atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(r["bwd_gb"], gp["bias"], atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(r["bwd_gw"], gp_want["weight"],
                                   atol=1e-4, rtol=1e-4)
    # the weight grad is local: the ranks' parts differ, their sum is it
    assert not np.allclose(got[0]["bwd_gw_local"], got[0]["bwd_gw"])
    np.testing.assert_allclose(sum(r["bwd_gw_local"] for r in got),
                               got[0]["bwd_gw"], atol=1e-5)


def test_groups_keep_their_statistics_apart(case):
    inp, got = case
    groups = create_syncbn_process_group(2, WORLD)
    assert tuple(map(tuple, groups)) == GROUPS
    bn = JP.SyncBatchNorm(2, axis_name="data", axis_index_groups=GROUPS,
                          affine=False, track_running_stats=False)
    x = inp["grp_x"]
    want = jax.shard_map(lambda x: bn.apply({}, {}, x, training=True)[0],
                         mesh=_jmesh(), in_specs=P("data"),
                         out_specs=P("data"), check_vma=False)(
        jnp.asarray(x))
    y = _cat(got, "grp_y")
    np.testing.assert_allclose(y, want, atol=1e-5)
    np.testing.assert_allclose(y[:8], _local_bn(x[:8], (0,)), atol=1e-5)
    np.testing.assert_allclose(y[8:], _local_bn(x[8:], (0,)), atol=1e-5)
    assert not np.allclose(y[:8], _local_bn(x, (0,))[:8], atol=1e-3)


def test_fused_add_relu_forward_and_backward_match_jax(case):
    inp, got = case
    bn = JP.SyncBatchNorm(4, axis_name="data", fuse_relu=True,
                          track_running_stats=False)
    params, _ = bn.init()
    x, z, dy = (jnp.asarray(inp[k]) for k in ("relu_x", "relu_z",
                                              "relu_dy"))

    def body(p, x, z, dy):
        y, vjp = jax.vjp(lambda p, x, z: bn.apply(p, {}, x, z=z,
                                                  training=True)[0], p, x, z)
        gp, gx, gz = vjp(dy)
        return y, gx, gz, gp

    y, gx, gz, gp = jax.shard_map(
        body, mesh=_jmesh(), in_specs=(P(), P("data"), P("data"),
                                       P("data")),
        out_specs=(P("data"), P("data"), P("data"), P()),
        check_vma=True)(params, x, z, dy)
    for k, want in (("relu_y", y), ("relu_gx", gx), ("relu_gz", gz)):
        np.testing.assert_allclose(_cat(got, k), want, atol=1e-5, rtol=1e-5)
    for r in got:
        np.testing.assert_allclose(r["relu_gw"], gp["weight"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(r["relu_gb"], gp["bias"], atol=1e-5,
                                   rtol=1e-5)


def test_nchw_matches_the_global_batch(case):
    inp, got = case
    np.testing.assert_allclose(_cat(got, "nchw_y"),
                               _local_bn(inp["nchw_x"], (0, 2, 3)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("check_vma", [True, False])
def test_grouped_affine_grads_through_ddp_match_both_vma_modes(case,
                                                               check_vma):
    inp, got = case
    bn = JP.SyncBatchNorm(16, axis_name="data", axis_index_groups=GROUPS)
    bp, bst = bn.init()
    ddp = JP.DistributedDataParallel(axis_name="data")

    def step(bp, bst, x, y):
        def lf(bp):
            out, _ = bn.apply(bp, bst, x, training=True)
            return jnp.mean((out.astype(jnp.float32) - y) ** 2)
        return ddp.average_gradients(jax.grad(lf)(bp))

    want = jax.jit(jax.shard_map(
        step, mesh=_jmesh(), in_specs=(P(), P(), P("data"), P("data")),
        out_specs=P(), check_vma=check_vma))(
        bp, bst, jnp.asarray(inp["vma_x"]), jnp.asarray(inp["vma_y"]))
    for r in got:
        np.testing.assert_allclose(r["vma_gw"], want["weight"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["vma_gb"], want["bias"], rtol=1e-5,
                                   atol=1e-6)


def test_eval_uses_running_stats_and_makes_no_collective():
    """Eval mode reads the running statistics: no axis is bound in this
    process, and none is needed."""
    bn = SyncBatchNorm(3, axis_name="data")
    params, state = bn.init("cpu")
    state = {**state, "running_mean": torch.tensor([1.0, 2.0, 3.0]),
             "running_var": torch.tensor([4.0, 4.0, 4.0])}
    y, new_state = bn.apply(params, state, torch.ones(2, 3), training=False)
    jbn = JP.SyncBatchNorm(3, axis_name="data")
    jp, jst = jbn.init()
    jst = {**jst, "running_mean": jnp.asarray([1.0, 2.0, 3.0]),
           "running_var": jnp.asarray([4.0, 4.0, 4.0])}
    jy, _ = jbn.apply(jp, jst, jnp.ones((2, 3)), training=False)
    np.testing.assert_allclose(y.numpy(), jy, atol=1e-6)
    assert new_state is state


def test_reference_signature_and_its_errors():
    bn = SyncBatchNorm(64, 1e-5, 0.1, True, True, None, False, True)
    jbn = JP.SyncBatchNorm(64, 1e-5, 0.1, True, True, None, False, True)
    assert (bn.channel_axis, bn.fuse_relu) == (jbn.channel_axis,
                                               jbn.fuse_relu)
    g = create_syncbn_process_group(2, axis_size=8)
    assert SyncBatchNorm(64, process_group=g).axis_index_groups == \
        JP.SyncBatchNorm(64, process_group=g).axis_index_groups
    for cls in (SyncBatchNorm, JP.SyncBatchNorm):
        with pytest.raises(ValueError, match="not both"):
            cls(64, process_group=g, axis_index_groups=g)
        with pytest.raises(TypeError, match="keyword-only"):
            cls(16, 1e-5, 0.1, True, True, "data")
    with pytest.raises(RuntimeError, match="not bound"):
        SyncBatchNorm(4, axis_name="data").apply(
            *SyncBatchNorm(4).init("cpu"), torch.ones(2, 4))
