"""Port parity: the flat parameter store (``apex_tpu_torch.ops.flat``).

The port's segment table, flatten and unflatten against the JAX
package's on the CI ResNet's trees (``bench.py:1248``'s model) and a
nested tree with lists and ``None``: the same offsets, padded sizes and
segment ids, the same buffer bit for bit, and a gradient through
``unflatten(dtype=bf16)`` that lands in the fp32 buffer as JAX's does,
zero on the padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import ResNet as JResNet
from apex_tpu.ops import flat as JF
from apex_tpu.ops.pallas import multi_tensor as JP
from apex_tpu_torch.convert import resnet_from_jax
from apex_tpu_torch.ops import flat as F


@pytest.fixture(scope="module")
def resnet_trees():
    model = JResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10,
                    width=8)
    params, state = model.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    np_state = jax.tree.map(np.asarray, state)
    tp, ts = resnet_from_jax(np_params, np_state, device="cpu")
    return params, tp, state, ts


def _nested(rs):
    return {"b": [rs.randn(3, 5), {"z": rs.randn(130), "a": rs.randn(2)}],
            "a": (rs.randn(1), None, rs.randn(4, 4, 2)),
            "c": {"w": rs.randn(7, 128)}}


def _table_fields(t):
    return (t.shapes, t.sizes, t.offsets, t.padded_sizes, t.total, t.align)


@pytest.mark.parametrize("align", [128, 256])
def test_table_matches_jax_on_the_resnet_tree(resnet_trees, align):
    jparams, tparams, _, _ = resnet_trees
    jt = JF.make_table(jparams, align=align)
    tt = F.make_table(tparams, align=align)
    assert _table_fields(tt) == _table_fields(jt)
    np.testing.assert_array_equal(tt.segment_ids().numpy(),
                                  np.asarray(jt.segment_ids()))
    np.testing.assert_array_equal(
        tt.row_segment_ids().numpy(),
        np.asarray(JP.row_segment_ids(jt.segment_ids())))
    np.testing.assert_array_equal(tt.valid_mask().numpy(),
                                  np.asarray(jt.valid_mask()))
    assert sum(tt.row_counts()) * 128 == tt.total


def test_table_and_buffer_match_jax_on_a_nested_tree():
    tree = _nested(np.random.RandomState(0))
    jt = JF.make_table(tree)
    tt = F.make_table(tree)
    assert _table_fields(tt) == _table_fields(jt)
    jbuf, _ = JF.flatten(jax.tree.map(jnp.asarray, tree), dtype=jnp.float32)
    tbuf, _ = F.flatten(F.tree_map(torch.from_numpy, tree),
                        dtype=torch.float32)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    back = F.unflatten(tbuf, tt)
    assert back["a"][1] is None and isinstance(back["a"], tuple)
    assert isinstance(back["b"], list)


def test_flatten_matches_jax_bitwise(resnet_trees):
    jparams, tparams, jstate, tstate = resnet_trees
    for jtree, ttree in ((jparams, tparams), (jstate, tstate)):
        jbuf, _ = JF.flatten(jtree, dtype=jnp.float32)
        tbuf, _ = F.flatten(ttree, dtype=torch.float32)
        assert tbuf.dtype == torch.float32
        np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))


def test_unflatten_round_trip(resnet_trees):
    _, tparams, _, _ = resnet_trees
    buf, table = F.flatten(tparams)
    back = F.unflatten(buf, table)
    for a, b in zip(F.tree_leaves(back), F.tree_leaves(tparams)):
        assert a.shape == b.shape and torch.equal(a, b)
    half = F.unflatten(buf, table, dtype=torch.bfloat16)
    for a, b in zip(F.tree_leaves(half), F.tree_leaves(tparams)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))   # one cast, same bits
    assert torch.equal(F.zeros_like_flat(table), torch.zeros(table.total))
    with pytest.raises(ValueError, match="1-D"):
        F.unflatten(buf[:-1], table)
    with pytest.raises(ValueError, match="segments"):
        F.flatten({"x": torch.zeros(3)}, table=table)


def test_grad_through_bf16_unflatten_lands_in_the_fp32_buffer(resnet_trees):
    jparams, tparams, _, _ = resnet_trees
    jbuf, jt = JF.flatten(jparams, dtype=jnp.float32)
    rs = np.random.RandomState(1)
    weights = [rs.randn(*s).astype(np.float32) for s in jt.shapes]

    def jloss(flat):
        leaves = jax.tree_util.tree_leaves(
            JF.unflatten(flat, jt, dtype=jnp.bfloat16))
        return sum(jnp.sum(leaf.astype(jnp.float32) * w)
                   for leaf, w in zip(leaves, weights))

    want = np.asarray(jax.grad(jloss)(jbuf))
    tbuf, tt = F.flatten(tparams, dtype=torch.float32)
    master = tbuf.clone().requires_grad_(True)
    leaves = F.tree_leaves(F.unflatten(master, tt, dtype=torch.bfloat16))
    loss = sum((leaf.float() * torch.from_numpy(w)).sum()
               for leaf, w in zip(leaves, weights))
    (got,) = torch.autograd.grad(loss, master)
    assert got.dtype == torch.float32 and got.shape == (tt.total,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[~tt.valid_mask()].any()            # padding gets 0


def test_tree_walks_leave_no_reference_cycle():
    """Flattening a tree and unflattening a buffer keep no leaf alive once
    the caller drops it, without the cyclic collector: a walker that is a
    recursive closure held the LM's 2.24e9-parameter init tree and the bf16
    cast of the masters until a collection, which ran the card out of
    memory in Adam."""
    import gc
    import weakref
    tree = {"a": torch.zeros(3), "b": [torch.ones(2), (torch.ones(1),)]}
    gc.disable()
    try:
        leaf = weakref.ref(tree["b"][0])
        buf, table = F.flatten(tree)
        del tree
        assert leaf() is None
        view = weakref.ref(F.unflatten(buf, table, dtype=torch.float64)["a"])
        assert view() is None
    finally:
        gc.enable()
