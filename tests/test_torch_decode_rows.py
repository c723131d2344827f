"""Port parity: the [S, Q] multi-row decode (speculative scoring).

The plain multi-row slot attention (what the kernel wrappers run for a
CPU tensor, and what the multi-row CUDA kernel is held against on the
card) against the JAX package's ``reference_slot_decode_attention`` with a
query axis and its Pallas kernels in interpret mode (which see the rows
flattened into the slot axis), dense and paged; and the model's
``_decode_slots`` at [S, Q] against the JAX one, dense and paged, the K/V
of row j written before attention and each row masked to its own length.
Tolerance 1e-5 (f32; the frameworks sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import decode_attention as JDA
from apex_tpu.models import TransformerLM as JLM
from apex_tpu_torch.contrib.multihead_attn import decode_attention as TDA
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM
from apex_tpu_torch.ops import decode_attn as OPS

S, Q, H, L, HD, PAGE = 3, 4, 2, 64, 128, 16
MAX_PAGES = L // PAGE
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def rows():
    """Q rows a slot at consecutive lengths, one slot's rows crossing a
    chunk edge, one reaching the arena's end; and the same K/V as page
    pools behind a shuffled table (unmapped pages at the null page 0,
    which holds large garbage)."""
    rng = np.random.RandomState(0)
    q = rng.randn(S, Q, H, HD).astype(np.float32)
    k = rng.randn(S, H, L, HD).astype(np.float32)
    v = rng.randn(S, H, L, HD).astype(np.float32)
    lengths = np.asarray([[1, 2, 3, 4], [15, 16, 17, 18],
                          [L - 3, L - 2, L - 1, L]], np.int32)
    n_phys = 1 + S * MAX_PAGES
    phys = rng.permutation(np.arange(1, n_phys))
    table = np.zeros((S, MAX_PAGES), np.int32)
    kp = np.full((n_phys, H, PAGE, HD), 1e4, np.float32)
    vp = np.full((n_phys, H, PAGE, HD), -1e4, np.float32)
    nxt = 0
    for s in range(S):
        for lp in range(-(-int(lengths[s].max()) // PAGE)):
            table[s, lp] = phys[nxt]
            nxt += 1
            sl = slice(lp * PAGE, (lp + 1) * PAGE)
            kp[table[s, lp]] = k[s, :, sl]
            vp[table[s, lp]] = v[s, :, sl]
    assert (table == 0).any()
    return q, k, v, lengths, kp, vp, table


@pytest.mark.parametrize("impl", ["pallas", "reference"])
def test_multi_row_plain_matches_jax_dense(rows, impl):
    q, k, v, lengths, *_ = rows
    want = JDA.slot_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     impl=impl)
    got = TDA.slot_decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    assert got.shape == (S, Q, H, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["pallas", "reference"])
def test_multi_row_plain_matches_jax_paged(rows, impl):
    q, _, _, lengths, kp, vp, table = rows
    want = JDA.slot_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), impl=impl, page_table=jnp.asarray(table))
    got = TDA.slot_decode_attention(_t(q), _t(kp), _t(vp), _t(lengths),
                                    page_table=_t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_multi_row_paged_equals_dense_and_each_row_its_length(rows):
    """Inside the port: paged equals dense bit for bit (the gather is the
    only layout difference), and row j equals the 1-query call at its
    length."""
    q, k, v, lengths, kp, vp, table = rows
    dense = OPS.decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    paged = OPS.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(lengths),
                                       page_table=_t(table))
    np.testing.assert_array_equal(paged.numpy(), dense.numpy())
    for j in range(Q):
        one = OPS.decode_attention(_t(q[:, j]), _t(k), _t(v),
                                   _t(lengths[:, j]))
        np.testing.assert_allclose(dense[:, j].numpy(), one.numpy(), **TOL)


def test_cpu_rows_run_the_plain_version_and_launch_nothing(rows):
    q, k, v, lengths, kp, vp, table = rows
    fns = (OPS.decode_attention_rows, OPS.paged_decode_attention_rows,
           OPS.decode_attention, OPS.decode_merge)
    before = [f.launches for f in fns]
    got = OPS.decode_attention_rows(_t(q), _t(k), _t(v), _t(lengths))
    want = OPS.decode_attention_plain(_t(q), _t(k), _t(v), _t(lengths))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    OPS.paged_decode_attention_rows(_t(q), _t(kp), _t(vp), _t(lengths),
                                    page_table=_t(table))
    assert [f.launches for f in fns] == before


# -- the model's [S, Q] decode step -----------------------------------------

V, T, E, NH, LAYERS = 50, 64, 32, 4, 2
TOTAL, MPAGE = 32, 8


@pytest.fixture(scope="module")
def models():
    jm = JLM(vocab_size=V, max_seq_len=T, embed_dim=E, num_heads=NH,
             num_layers=LAYERS)
    jp = jm.init(jax.random.key(0))
    tm = TLM(vocab_size=V, max_seq_len=T, embed_dim=E, num_heads=NH,
             num_layers=LAYERS, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def prefilled(models):
    jm, jp, tm, tp = models
    prompt = np.random.RandomState(2).randint(0, V, (S, 7)).astype(np.int32)
    _, caches_j = jm._prefill(jp, jnp.asarray(prompt), TOTAL)
    _, caches_t = tm._prefill(tp, torch.from_numpy(prompt), TOTAL)
    return caches_j, caches_t


def _paged_from_dense(caches, table):
    out = {}
    for name, kv in caches.items():
        pools = []
        for c in kv:
            c = np.asarray(c)
            pool = np.zeros((1 + table.size, NH, MPAGE, E // NH), c.dtype)
            for s in range(S):
                for lp in range(table.shape[1]):
                    pool[table[s, lp]] = c[s, :, lp * MPAGE:(lp + 1) * MPAGE]
            pools.append(pool)
        out[name] = tuple(pools)
    return out


def _clone(caches):
    return {n: tuple(c.clone() for c in kv) for n, kv in caches.items()}


def test_decode_slots_rows_dense_and_paged_match_jax(models, prefilled):
    """Q rows a slot at per-row positions (a 2-query catch-up pair for one
    slot, (k+1)-row scoring for the others), dense and paged: hidden
    states and the written K/V agree with JAX's; paged equals dense bit
    for bit inside the port; row j equals a 1-query step after j
    sequential commits."""
    jm, jp, tm, tp = models
    caches_j, caches_t = prefilled
    toks = np.asarray([[3, 17, 41, 8], [5, 6, 7, 9], [11, 12, 13, 14]],
                      np.int32)
    pos = np.asarray([[6, 7, 8, 9], [7, 8, 9, 10], [9, 10, 11, 12]],
                     np.int32)
    hid_j, new_j = jm._decode_slots(jp, jnp.asarray(toks), jnp.asarray(pos),
                                    caches_j, attn_impl="reference")
    dense_t = _clone(caches_t)
    hid_t, new_t = tm._decode_slots(tp, torch.from_numpy(toks),
                                    torch.from_numpy(pos), dense_t)
    assert hid_t.shape == (S, 4, E)
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j), **TOL)
    for name, (kj, vj) in new_j.items():
        np.testing.assert_allclose(new_t[name][0].numpy(), np.asarray(kj),
                                   **TOL)
        np.testing.assert_allclose(new_t[name][1].numpy(), np.asarray(vj),
                                   **TOL)
    table = (1 + np.random.RandomState(3).permutation(S * (TOTAL // MPAGE))
             ).reshape(S, TOTAL // MPAGE).astype(np.int32)
    pools_t = {n: tuple(torch.from_numpy(p) for p in kv) for n, kv in
               _paged_from_dense({n: tuple(c.numpy() for c in kv)
                                  for n, kv in caches_t.items()},
                                 table).items()}
    pools_j = {n: tuple(jnp.asarray(p) for p in kv) for n, kv in
               _paged_from_dense(caches_j, table).items()}
    hid_pj, _ = jm._decode_slots(jp, jnp.asarray(toks), jnp.asarray(pos),
                                 pools_j, attn_impl="reference",
                                 page_table=jnp.asarray(table),
                                 page_size=MPAGE)
    hid_pt, _ = tm._decode_slots(tp, torch.from_numpy(toks),
                                 torch.from_numpy(pos), pools_t,
                                 page_table=torch.from_numpy(table),
                                 page_size=MPAGE)
    np.testing.assert_allclose(hid_pt.numpy(), np.asarray(hid_pj), **TOL)
    np.testing.assert_array_equal(hid_pt.numpy(), hid_t.numpy())
    # row j: the 1-query step after j sequential commits
    seq = _clone(caches_t)
    for j in range(4):
        one, seq = tm._decode_slots(tp, torch.from_numpy(toks[:, j]),
                                    torch.from_numpy(pos[:, j]), seq)
        np.testing.assert_allclose(one.numpy(), hid_t[:, j].numpy(), **TOL)


def test_decode_slots_rows_at_one_position_write_the_first(models,
                                                          prefilled):
    """Rows clamped to one position (past a slot's budget, at the arena's
    end) all write the FIRST such row's K/V, whatever order the scatter
    takes among duplicate targets: the bytes there are those a 1-query
    step at that position writes."""
    _, _, tm, tp = models
    _, caches_t = prefilled
    last = TOTAL - 1
    toks = np.asarray([[3, 17, 41, 8]] * S, np.int32)
    pos = np.asarray([[last - 1, last, last, last]] * S, np.int32)
    got = _clone(caches_t)
    tm._decode_slots(tp, torch.from_numpy(toks), torch.from_numpy(pos), got)
    one = _clone(caches_t)
    tm._decode_slots(tp, torch.from_numpy(toks[:, 1]),
                     torch.from_numpy(pos[:, 1]), one)
    # layer 0's K/V depend on the row's own token and position only
    for c in range(2):
        np.testing.assert_allclose(got["layer_0"][c][:, :, last].numpy(),
                                   one["layer_0"][c][:, :, last].numpy(),
                                   **TOL)
    last_row = _clone(caches_t)
    tm._decode_slots(tp, torch.from_numpy(toks[:, 3]),
                     torch.from_numpy(pos[:, 3]), last_row)
    assert not np.allclose(got["layer_0"][0][:, :, last].numpy(),
                           last_row["layer_0"][0][:, :, last].numpy())
