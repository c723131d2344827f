"""Port parity: ``apex_tpu_torch.parallel.ring_attention`` — the ring,
Ulysses and ``merge_partials`` — against ``apex_tpu.parallel.ring_attention``.

The counterparts of every case of ``tests/test_ring_attention.py``: the
port's ranks are 4 gloo child processes over a ``"seq"`` axis
(``_torch_dist.ring_ops``, one run for the module), the JAX side runs
``shard_map`` over 4 of the conftest's 8 CPU devices (its flash kernel
in interpret mode) on the same numpy inputs, and both are held to full
attention at the JAX tests' tolerances (outputs rtol 1e-4 / atol 1e-5,
grads rtol 1e-3 / atol 1e-4). The port's grads are each rank's grads of
its own sum(out²) — the rule of ``parallel.collectives``: the ranks'
losses count as one sum, and ``ppermute``'s and ``all_to_all``'s
backwards send the cotangents home.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu.contrib.multihead_attn import flash_attention as j_flash
from apex_tpu.contrib.multihead_attn import reference_attention as j_ref
from apex_tpu.parallel import make_mesh
from apex_tpu.parallel.ring_attention import merge_partials as j_merge
from apex_tpu.parallel.ring_attention import ring_attention as j_ring
from apex_tpu.parallel.ring_attention import ulysses_attention as j_uly
from apex_tpu_torch.contrib.multihead_attn.flash_attention import \
    reference_attention
from apex_tpu_torch.parallel.ring_attention import merge_partials

N = 4
B, H, S, D_ = 2, 4, 64, 16
SEQ = P(None, None, "seq")


def _qkv(seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(B, H, S, D_).astype(np.float32) for _ in range(3))


def _mesh():
    return make_mesh({"seq": N}, devices=jax.devices()[:N])


def _biases():
    pad = np.arange(S) >= S - 10
    kvb = np.broadcast_to(np.where(pad, -1.0e30, 0.0)[None, :],
                          (B * H, S)).astype(np.float32).copy()
    per = np.stack([np.where(np.arange(S) >= S - 4 * (i % 3 + 1), -1.0e30,
                             0.0) for i in range(B * H)]).astype(np.float32)
    shared = np.where(np.arange(S) >= S - 12, -1.0e30,
                      0.0)[None, :].astype(np.float32)
    return kvb, per, shared


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    q, k, v = _qkv(0)
    q2, k2, v2 = _qkv(2)
    q3, k3, v3 = _qkv(3)
    q5, k5, v5 = _qkv(5)
    kvb, per, shared = _biases()
    inputs = dict(q=q, k=k, v=v, q2=q2, k2=k2, v2=v2, q3=q3, k3=k3, v3=v3,
                  q5=q5, k5=k5, v5=v5, kvb=kvb, kvb_bh=per,
                  kvb_shared=shared)
    got = D.run_ranks(D.ring_ops, N, tmp_path_factory.mktemp("ring"),
                      timeout=120, mesh_axes={"seq": N}, **inputs)
    return inputs, got


def _cat(got, key):
    return np.concatenate([r[key] for r in got], axis=2)


class TestMergePartials:
    def test_two_halves_equal_full(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(0))
        o1, l1 = reference_attention(q, k[:, :, :32], v[:, :, :32],
                                     return_lse=True)
        o2, l2 = reference_attention(q, k[:, :, 32:], v[:, :, 32:],
                                     return_lse=True)
        o, lse = merge_partials(o1.float(), l1, o2.float(), l2)
        full = reference_attention(q, k, v)
        np.testing.assert_allclose(o.numpy(), full.numpy(), rtol=1e-5,
                                   atol=1e-5)
        jo, jl = j_merge(*(jnp.asarray(t.numpy()) for t in (o1, l1, o2, l2)))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=1e-6)

    def test_masked_partial_is_identity(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(0))
        o1, l1 = reference_attention(q, k, v, return_lse=True)
        o0 = torch.zeros_like(o1)
        l0 = torch.full(l1.shape, -1e30)
        o, lse = merge_partials(o1.float(), l1, o0, l0)
        np.testing.assert_allclose(o.numpy(), o1.numpy(), rtol=1e-6)
        np.testing.assert_allclose(lse.numpy(), l1.numpy(), rtol=1e-6)
        # both masked: weightless, lse stays NEG_INF, no NaN
        o, lse = merge_partials(o0, l0, o0, l0)
        assert torch.equal(o, o0) and torch.equal(lse, l0)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full(ranks, causal):
    inputs, got = ranks
    q, k, v = (jnp.asarray(inputs[n]) for n in "qkv")

    @jax.jit
    @partial(shard_map, mesh=_mesh(), in_specs=(SEQ,) * 3, out_specs=SEQ,
             check_vma=False)
    def run(q, k, v):
        bh = q.shape[0] * q.shape[1]
        out = j_ring(*(t.reshape(bh, t.shape[2], t.shape[3])
                       for t in (q, k, v)), "seq", N, causal=causal)
        return out.reshape(q.shape)

    out = _cat(got, f"ring_{causal}")
    np.testing.assert_allclose(out, np.asarray(run(q, k, v)), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(j_ref(q, k, v,
                                                     causal=causal)),
                               rtol=1e-4, atol=1e-5)


def test_ring_attention_4d_and_grads(ranks):
    inputs, got = ranks
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q3", "k3", "v3"))

    @jax.jit
    @partial(shard_map, mesh=_mesh(), in_specs=(SEQ,) * 3, out_specs=SEQ,
             check_vma=False)
    def run(q, k, v):
        return j_ring(q, k, v, "seq", N, causal=True)

    g_ring = jax.grad(lambda q, k, v: jnp.sum(run(q, k, v) ** 2),
                      argnums=(0, 1, 2))(q, k, v)
    g_full = jax.grad(lambda q, k, v: jnp.sum(
        j_ref(q, k, v, causal=True) ** 2), argnums=(0, 1, 2))(q, k, v)
    for a, b, c, name in zip(g_ring, g_full, "qkv", "qkv"):
        mine = _cat(got, f"ring_g{c}")
        np.testing.assert_allclose(mine, np.asarray(a), rtol=1e-3,
                                   atol=1e-4, err_msg=f"grad {name}")
        np.testing.assert_allclose(mine, np.asarray(b), rtol=1e-3,
                                   atol=1e-4, err_msg=f"grad {name}")


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_full(ranks, causal):
    inputs, got = ranks
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q2", "k2", "v2"))

    @jax.jit
    @partial(shard_map, mesh=_mesh(), in_specs=(SEQ,) * 3, out_specs=SEQ,
             check_vma=False)
    def run(q, k, v):
        return j_uly(q, k, v, "seq", N, causal=causal)

    want = np.asarray(run(q, k, v))
    ref = np.asarray(j_ref(q, k, v, causal=causal))
    for key in (f"ulysses_{causal}", f"ulysses_ref_{causal}"):
        out = _cat(got, key)
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5,
                                   err_msg=key)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_ulysses_grads_match_full(ranks):
    inputs, got = ranks
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q3", "k3", "v3"))
    g_full = jax.grad(lambda q, k, v: jnp.sum(
        j_ref(q, k, v, causal=True) ** 2), argnums=(0, 1, 2))(q, k, v)
    for b, c in zip(g_full, "qkv"):
        np.testing.assert_allclose(_cat(got, f"ulysses_g{c}"),
                                   np.asarray(b), rtol=1e-3, atol=1e-4,
                                   err_msg=f"grad {c}")


def test_ulysses_rejects_indivisible_heads(ranks):
    _, got = ranks
    with pytest.raises(ValueError, match="not divisible") as e:
        shard_map(lambda q: j_uly(q, q, q, "seq", N), mesh=_mesh(),
                  in_specs=SEQ, out_specs=SEQ, check_vma=False)(
            jnp.zeros((B, 3, S, D_)))
    for r in got:
        assert str(r["indivisible"]) == str(e.value)


def test_ring_kv_bias_padded_keys_matches_full(ranks):
    inputs, got = ranks
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q2", "k2", "v2"))
    kvb = jnp.asarray(inputs["kvb"])

    @jax.jit
    @partial(shard_map, mesh=_mesh(),
             in_specs=(SEQ, SEQ, SEQ, P(None, "seq")), out_specs=SEQ,
             check_vma=False)
    def run(q, k, v, kvb):
        bh = q.shape[0] * q.shape[1]
        out = j_ring(*(t.reshape(bh, t.shape[2], t.shape[3])
                       for t in (q, k, v)), "seq", N, kv_bias=kvb)
        return out.reshape(q.shape)

    out = _cat(got, "ring_kvb")
    np.testing.assert_allclose(out, np.asarray(run(q, k, v, kvb)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        out, np.asarray(j_ref(q, k, v, kv_bias=kvb.reshape(B, H, S))),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rows", ["shared", "per_bh"])
def test_ulysses_kv_bias_matches_full(ranks, rows):
    inputs, got = ranks
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q5", "k5", "v5"))
    kvb = jnp.asarray(inputs["kvb_shared" if rows == "shared"
                             else "kvb_bh"])

    @jax.jit
    @partial(shard_map, mesh=_mesh(),
             in_specs=(SEQ, SEQ, SEQ, P(None, "seq")), out_specs=SEQ,
             check_vma=False)
    def run(q, k, v, kvb):
        return j_uly(q, k, v, "seq", N, causal=True, kv_bias=kvb)

    want = np.asarray(run(q, k, v, kvb))
    ref_bias = kvb.reshape(1, 1, S) if rows == "shared" \
        else kvb.reshape(B, H, S)
    ref = np.asarray(j_ref(q, k, v, kv_bias=ref_bias, causal=True))
    for impl in ("flash", "default"):
        out = _cat(got, f"ulysses_kvb_{rows}_{impl}")
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5,
                                   err_msg=impl)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=impl)


def test_ring_dropout_matches_single_device(ranks):
    """Masks from global positions: the sharded result equals the
    single-device flash computation with the same seed, in both
    packages."""
    inputs, got = ranks
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q3", "k3", "v3"))
    out = _cat(got, "ring_drop")
    ref = np.asarray(j_flash(q, k, v, causal=True, dropout_rate=0.2,
                             dropout_seed=123))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    plain = np.asarray(j_flash(q, k, v, causal=True))
    assert float(np.max(np.abs(out - plain))) > 1e-3
