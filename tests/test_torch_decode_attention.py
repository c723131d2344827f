"""Port parity: single-query slot decode attention, dense and paged.

The port's plain versions (what ``apex_tpu_torch``'s kernel wrappers run
for a CPU tensor, and what the CUDA kernels are held against on the card)
against the JAX package on the same numpy inputs: its Pallas kernels run
in interpret mode (``impl="pallas"``, as tests/test_decode_attention.py
runs them) and its reference twin (``impl="reference"``). Tolerance
1e-5 in f32: the Pallas kernels sum in another order (the paged one with
an online softmax across pages), so the agreement is to fp32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import decode_attention as JDA
from apex_tpu_torch.contrib.multihead_attn import decode_attention as TDA
from apex_tpu_torch.ops import decode_attn as OPS

S, H, L, HD, PAGE = 3, 2, 64, 128, 16
MAX_PAGES = L // PAGE
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def dense():
    """q/k/v of a dense arena with ragged lengths: 1, a mid value, and the
    whole arena."""
    rng = np.random.RandomState(0)
    q = rng.randn(S, H, HD).astype(np.float32)
    k = rng.randn(S, H, L, HD).astype(np.float32)
    v = rng.randn(S, H, L, HD).astype(np.float32)
    lengths = np.asarray([1, 37, L], np.int32)
    return q, k, v, lengths


@pytest.fixture(scope="module")
def paged(dense):
    """The same logical K/V as page pools behind a shuffled page table.
    Pages past a slot's length map to the null page 0, which holds large
    garbage (it must never be read unmasked)."""
    q, k, v, lengths = dense
    rng = np.random.RandomState(1)
    n_phys = 1 + S * MAX_PAGES
    phys = rng.permutation(np.arange(1, n_phys))
    table = np.zeros((S, MAX_PAGES), np.int32)
    kp = np.full((n_phys, H, PAGE, HD), 1e4, np.float32)
    vp = np.full((n_phys, H, PAGE, HD), -1e4, np.float32)
    nxt = 0
    for s in range(S):
        for lp in range(-(-int(lengths[s]) // PAGE)):
            table[s, lp] = phys[nxt]
            nxt += 1
            sl = slice(lp * PAGE, (lp + 1) * PAGE)
            kp[table[s, lp]] = k[s, :, sl]
            vp[table[s, lp]] = v[s, :, sl]
    assert (table == 0).any()          # the null page is in use
    return q, kp, vp, lengths, table


@pytest.mark.parametrize("impl", ["pallas", "reference"])
def test_dense_plain_matches_jax(dense, impl):
    q, k, v, lengths = dense
    want = JDA.slot_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     impl=impl)
    got = TDA.slot_decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    assert got.dtype == torch.float32 and got.shape == (S, H, HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["pallas", "reference"])
def test_paged_plain_matches_jax(paged, impl):
    q, kp, vp, lengths, table = paged
    want = JDA.slot_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), impl=impl, page_table=jnp.asarray(table))
    got = TDA.slot_decode_attention(_t(q), _t(kp), _t(vp), _t(lengths),
                                    page_table=_t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_plain_bit_equals_dense_after_gather(paged):
    """The port's paged plain version is the dense one after the gather:
    bitwise equal, as in the JAX reference twin."""
    q, kp, vp, lengths, table = paged
    pt = _t(table)
    kd = TDA.gather_pages(_t(kp), pt)
    vd = TDA.gather_pages(_t(vp), pt)
    assert kd.shape == (S, H, L, HD)
    dense_out = TDA.reference_slot_decode_attention(_t(q), kd, vd,
                                                    _t(lengths))
    paged_out = TDA.reference_slot_decode_attention(
        _t(q), _t(kp), _t(vp), _t(lengths), page_table=pt)
    np.testing.assert_array_equal(paged_out.numpy(), dense_out.numpy())


def test_gather_pages_matches_jax(paged):
    _, kp, _, _, table = paged
    want = JDA.gather_pages(jnp.asarray(kp), jnp.asarray(table))
    got = TDA.gather_pages(_t(kp), _t(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_garbage_past_length_is_unreachable(dense, paged):
    """Poisoning every position past a slot's length (dense) or the null
    page and each page's tail (paged) leaves the output bit-unchanged:
    masked positions contribute exactly 0.0."""
    q, k, v, lengths = dense
    base = TDA.slot_decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    tail = np.arange(L)[None, None, :, None] >= lengths[:, None, None, None]
    kz = np.where(tail, 3e4, k).astype(np.float32)
    vz = np.where(tail, -3e4, v).astype(np.float32)
    got = TDA.slot_decode_attention(_t(q), _t(kz), _t(vz), _t(lengths))
    np.testing.assert_array_equal(got.numpy(), base.numpy())

    q, kp, vp, lengths, table = paged
    base = TDA.slot_decode_attention(_t(q), _t(kp), _t(vp), _t(lengths),
                                     page_table=_t(table))
    kz, vz = kp.copy(), vp.copy()
    kz[0], vz[0] = 7e4, -7e4           # the null page
    for s in range(S):
        n = int(lengths[s])
        if n % PAGE:
            last = table[s, n // PAGE]
            kz[last, :, n % PAGE:] = 5e4
            vz[last, :, n % PAGE:] = -5e4
    got = TDA.slot_decode_attention(_t(q), _t(kz), _t(vz), _t(lengths),
                                    page_table=_t(table))
    np.testing.assert_array_equal(got.numpy(), base.numpy())


def test_length_zero_gives_zeros_like_jax(dense):
    """A slot of length 0 (the l_sum > 0 guard) yields zeros in both
    packages."""
    q, k, v, _ = dense
    lengths = np.asarray([0, 1, L], np.int32)
    want = JDA.slot_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     impl="pallas")
    got = TDA.slot_decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    assert not got[0].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_plain_matches_jax_reference(dense):
    """The serving dtype: bf16 arena, fp32 scores, output in bf16 (one
    rounding of the same fp32 value in both packages)."""
    q, k, v, lengths = dense
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = JDA.slot_decode_attention(*bf, jnp.asarray(lengths),
                                     impl="reference")
    got = TDA.slot_decode_attention(
        *[_t(a).to(torch.bfloat16) for a in (q, k, v)], _t(lengths))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing(dense,
                                                              paged):
    q, k, v, lengths = dense
    before = (OPS.decode_attention.launches,
              OPS.paged_decode_attention.launches)
    out = OPS.decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    plain = OPS.decode_attention_plain(_t(q), _t(k), _t(v), _t(lengths))
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    q, kp, vp, lengths, table = paged
    OPS.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(lengths),
                               page_table=_t(table))
    assert (OPS.decode_attention.launches,
            OPS.paged_decode_attention.launches) == before


def test_multi_row_form_waits_for_spec_decoding(dense):
    """The [S, Q, H, hd] form (speculative scoring) is ported: each row
    masked to its own length matches the JAX reference with a query axis,
    and a one-row call equals the 1-query call."""
    q, k, v, lengths = dense
    rng = np.random.RandomState(7)
    qm = rng.randn(S, 3, H, HD).astype(np.float32)
    lm = np.stack([np.clip(lengths - 2 + j, 0, L)
                   for j in range(3)], axis=1).astype(np.int32)
    want = JDA.slot_decode_attention(jnp.asarray(qm), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lm),
                                     impl="reference")
    got = TDA.slot_decode_attention(_t(qm), _t(k), _t(v), _t(lm))
    assert got.shape == (S, 3, H, HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    one = TDA.slot_decode_attention(_t(q)[:, None], _t(k), _t(v),
                                    _t(lengths)[:, None])
    np.testing.assert_allclose(
        one[:, 0].numpy(),
        TDA.slot_decode_attention(_t(q), _t(k), _t(v), _t(lengths)).numpy(),
        **TOL)
