"""Port parity: ``apex_tpu_torch.contrib.groupbn`` (``BatchNorm2d_NHWC``,
``bn_groups_for``) on 4 gloo ranks against ``apex_tpu.contrib.groupbn``
under ``shard_map`` over 4 of the conftest's 8 CPU devices: the fused
add + relu forward, the running mean and the grads of x, z, weight and
bias (summed over the ranks), with ``bn_group`` 2 (pairs) and 1 (each
rank alone), within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu.contrib import groupbn as JG
from apex_tpu.parallel import make_mesh as j_make_mesh
from apex_tpu_torch.contrib import groupbn as TG

WORLD = 4


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rs = np.random.RandomState(0)
    inp = {k: rs.randn(8, 3, 3, 8).astype(np.float32)
           for k in ("x", "z", "dy")}
    return inp, D.run_ranks(D.groupbn_ops, WORLD,
                            tmp_path_factory.mktemp("gbn"), **inp)


@pytest.mark.parametrize("bn_group", [2, 1])
def test_batchnorm2d_nhwc_matches_jax(case, bn_group):
    inp, got = case
    bn = JG.BatchNorm2d_NHWC(8, fuse_relu=True, bn_group=bn_group,
                             world_size=WORLD)
    params, state = bn.init()
    mesh = j_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])

    def body(p, s, x, z, dy):
        y, vjp = jax.vjp(
            lambda p, x, z: bn.apply(p, s, x, z=z, training=True)[0],
            p, x, z)
        gp, gx, gz = vjp(dy)
        _, new = bn.apply(p, s, x, z=z, training=True)
        if bn_group == 1:    # local BN: each device's param grads, summed
            gp = jax.tree.map(lambda g: jax.lax.psum(g, "data"), gp)
        return y, new["running_mean"], gx, gz, gp

    y, mean, gx, gz, gp = jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P("data"), P("data"),
                                   P("data")),
        out_specs=(P("data"), P("data"), P("data"), P("data"), P()),
        # with vma on, the synced BN's replicated params get their grads
        # summed over the axis inside the vjp; local BN needs it off
        check_vma=bn_group != 1)(params, state, *(jnp.asarray(inp[k])
                                         for k in ("x", "z", "dy")))
    cat = lambda k: np.concatenate([r[f"{k}{bn_group}"] for r in got])
    np.testing.assert_allclose(cat("y"), y, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cat("gx"), gx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cat("gz"), gz, atol=1e-5, rtol=1e-5)
    mean = np.asarray(mean).reshape(WORLD, -1)
    for r, row in enumerate(got):
        np.testing.assert_allclose(row[f"mean{bn_group}"], mean[r],
                                   atol=1e-5)
        np.testing.assert_allclose(row[f"gw{bn_group}"], gp["weight"],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(row[f"gb{bn_group}"], gp["bias"],
                                   atol=1e-5, rtol=1e-5)
    if bn_group == 2:      # pairs share statistics, the pairs differ
        assert np.allclose(got[0]["mean2"], got[1]["mean2"])
        assert not np.allclose(got[0]["mean2"], got[2]["mean2"])


def test_groups_and_their_errors_match_jax():
    for args in ((8, 2), (8, 4), (4, 1), (8, 0)):
        assert TG.bn_groups_for(*args) == JG.bn_groups_for(*args)
    for cls, groups in ((TG, TG.bn_groups_for), (JG, JG.bn_groups_for)):
        with pytest.raises(ValueError, match="not divisible"):
            groups(6, 4)
        with pytest.raises(ValueError, match="needs world_size"):
            cls.BatchNorm2d_NHWC(8, bn_group=2)
    t = TG.BatchNorm2d_NHWC(8, False, 2, 3, 8, True, world_size=4)
    j = JG.BatchNorm2d_NHWC(8, False, 2, 3, 8, True, world_size=4)
    assert (t.axis_name, t.axis_index_groups, t.channel_axis) == \
        (j.axis_name, j.axis_index_groups, j.channel_axis)
    assert TG.BatchNorm2d_NHWC(8).axis_name is None
