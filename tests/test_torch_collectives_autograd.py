"""Port parity: the differentiable collectives of
``apex_tpu_torch.parallel.collectives`` — ``ppermute``, ``all_to_all``,
``psum``, ``pmean``, ``pmax``, ``pvary`` — against JAX's ``lax``
collectives under ``shard_map`` (vma semantics, grads taken outside).

The port's ranks are 4 gloo child processes over a ``"seq"`` axis
(``_torch_dist.collective_grad_ops``), each term run twice: by the
axis's own rules (gloo on CPU tensors: send/recv, all-to-all) and by the
gloo-on-CUDA rules forced onto the same group (bytes staged through host
buffers), which must give the same values and grads bit for bit. A
varying term is weighted by the rank's rows, a replicated one once by a
weight the same on every rank, and a replicated sum consumed by a
varying computation passes through ``pvary``: the rule of the module
docstring, which JAX's implicit casts apply.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu.parallel import make_mesh
from apex_tpu_torch.parallel import collectives as C

N = 4
R, COLS = 2, 8          # rows a rank, columns
RULES = ("seq", "seq_rules")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rs = np.random.RandomState(0)
    x = rs.randn(N * R, COLS).astype(np.float32)
    x[5, 3] = x[1, 3] = 7.0            # a tie for pmax's maximum
    y = rs.randn(N * R, COLS).astype(np.float32)
    c = rs.randn(R, COLS).astype(np.float32)
    got = D.run_ranks(D.collective_grad_ops, N,
                      tmp_path_factory.mktemp("cgrad"),
                      mesh_axes={"seq": N}, x=x, y=y, c=c)
    return x, y, c, got


def _mesh():
    return make_mesh({"seq": N}, devices=jax.devices()[:N])


def _jgrad(body, out_spec, weight, x, y):
    """JAX's value and grad of sum(shard_map(body)(x, y) * weight)."""
    f = jax.jit(jax.shard_map(body, mesh=_mesh(),
                              in_specs=(P("seq"), P("seq")),
                              out_specs=out_spec))
    val = f(jnp.asarray(x), jnp.asarray(y))
    g = jax.grad(lambda a: jnp.sum(f(a, jnp.asarray(y)) * weight))(
        jnp.asarray(x))
    return np.asarray(val), np.asarray(g)


def _mine(got, key):
    return np.concatenate([r[key] for r in got])


def test_both_rule_sets_give_the_same_values_and_grads(ranks):
    _, _, _, got = ranks
    for r in got:
        assert dict(r["rules"].tolist()) == {
            "all_gather": "broadcast_each", "all_to_all": "host_all_to_all",
            "ppermute": "host_send_recv",
            "reduce_scatter": "all_reduce+slice"}
        for key in r:
            if key.endswith("_seq"):
                np.testing.assert_array_equal(
                    r[key], r[key[:-len("_seq")] + "_seq_rules"], err_msg=key)
        # the tally names what ran, backwards included, under JAX's keys:
        # the two ppermutes and the all_to_all each way; psum, psum_vary,
        # pmean and pvary's sums forward, pvary's two backward and pmax's
        # count of ties
        assert r["tally_seq"].tolist() == r["tally_seq_rules"].tolist() == [
            ["all_to_all", "2"], ["pmax", "1"], ["ppermute", "4"],
            ["psum", "7"]]


@pytest.mark.parametrize("rules", RULES)
def test_ppermute_ring_and_its_inverse_backward(ranks, rules):
    x, y, _, got = ranks
    ring = [(j, (j + 1) % N) for j in range(N)]
    val, g = _jgrad(lambda a, w: lax.ppermute(a, "seq", ring), P("seq"),
                    jnp.asarray(y), x, y)
    np.testing.assert_array_equal(_mine(got, f"ring_{rules}"), val)
    np.testing.assert_array_equal(_mine(got, f"g_ring_{rules}"), g)


@pytest.mark.parametrize("rules", RULES)
def test_ppermute_partial_permutation_in_bf16(ranks, rules):
    """(0 -> 1): rank 1 gets rank 0's rows, every other rank zeros; the
    cotangent goes back to rank 0 only, in bf16 as it travelled."""
    x, y, _, got = ranks
    val, g = _jgrad(lambda a, w: lax.ppermute(a.astype(jnp.bfloat16),
                                              "seq", [(0, 1)]).astype(
        jnp.float32), P("seq"), jnp.asarray(y), x, y)
    np.testing.assert_array_equal(_mine(got, f"half_{rules}"), val)
    np.testing.assert_array_equal(_mine(got, f"g_half_{rules}"), g)
    assert not _mine(got, f"g_half_{rules}")[R:].any()


@pytest.mark.parametrize("rules", RULES)
def test_all_to_all_and_its_inverse_backward(ranks, rules):
    x, y, _, got = ranks
    val, g = _jgrad(lambda a, w: lax.all_to_all(a, "seq", 1, 0, tiled=True),
                    P("seq"), 1.0, x, y)
    np.testing.assert_array_equal(_mine(got, f"a2a_{rules}"), val)
    np.testing.assert_allclose(_mine(got, f"g_a2a_{rules}"), g, rtol=1e-6)


@pytest.mark.parametrize("rules", RULES)
def test_psum_identity_backward_under_a_replicated_consumer(ranks, rules):
    x, y, c, got = ranks
    val, g = _jgrad(lambda a, w: lax.psum(a * w, "seq"), P(),
                    jnp.asarray(c), x, y)
    for r in got:
        np.testing.assert_allclose(r[f"psum_{rules}"], val, rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(_mine(got, f"g_psum_{rules}"), g, rtol=1e-6)


@pytest.mark.parametrize("rules", RULES)
def test_psum_through_pvary_under_a_varying_consumer(ranks, rules):
    """A replicated sum weighted by each rank's own rows: pvary's backward
    sums the cotangents (JAX inserts the cast)."""
    x, y, _, got = ranks
    _, g = _jgrad(lambda a, w: lax.psum(a * w, "seq") * w, P("seq"), 1.0,
                  x, y)
    np.testing.assert_allclose(_mine(got, f"g_psum_vary_{rules}"), g,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rules", RULES)
def test_pmean_and_pvary(ranks, rules):
    x, y, c, got = ranks
    val, g = _jgrad(lambda a, w: lax.pmean(a, "seq"), P(), jnp.asarray(c),
                    x, y)
    for r in got:      # four fp32 summands: another order, an ulp off
        np.testing.assert_allclose(r[f"pmean_{rules}"], val, rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(_mine(got, f"g_pmean_{rules}"), g, rtol=1e-6)
    rank_w = jnp.repeat(jnp.arange(1.0, N + 1.0), R)[:, None] * \
        jnp.ones((1, COLS))
    _, g = _jgrad(lambda a, w: lax.psum(jnp.sum(a), "seq") * w[:1, :1],
                  P("seq"), 1.0, x, np.asarray(rank_w, np.float32))
    np.testing.assert_allclose(_mine(got, f"g_pvary_{rules}"), g, rtol=1e-6)


@pytest.mark.parametrize("rules", RULES)
def test_pmax_gives_the_cotangent_to_the_maximum(ranks, rules):
    """The replicated maximum; its cotangent (weighted once) goes to the
    rows holding it, split evenly between the two tied ranks."""
    x, _, c, got = ranks
    blocks = x.reshape(N, R, COLS)
    mx = blocks.max(0)
    for r in got:
        np.testing.assert_array_equal(r[f"pmax_{rules}"], mx)
    hold = (blocks == mx[None]).astype(np.float32)
    want = (hold / hold.sum(0, keepdims=True) * c[None]).reshape(N * R,
                                                                  COLS)
    np.testing.assert_allclose(_mine(got, f"g_pmax_{rules}"), want,
                               rtol=1e-6)
    assert hold[:, 1, 3].sum() == 2 and want[5, 3] == want[1, 3] == \
        c[1, 3] / 2


def test_rules_and_refusals_without_a_group():
    assert C.collective_rules("nccl", "cuda")["ppermute"] == "send_recv"
    assert C.collective_rules("gloo", "cpu")["all_to_all"] == "all_to_all"
    with pytest.raises(ValueError, match="partial permutation"):
        C._canon_perm([(0, 1), (1, 1)], 2)
    # outside autograd and without an axis the psum family is the identity
    t = torch.ones(2)
    assert C.psum(t, None) is t and C.pmean(t, None) is t
    assert C.pvary(t, "nowhere") is t
