"""Port parity: TransformerLM on the serving path.

The tiny model of tests/test_serve.py (V=50, T=64, E=32, H=4, 2 layers),
initialised by the JAX package and converted with ``params_from_jax``, so
both packages hold the same f32 weights. Compared: ``apply`` logits, the
prefill + fused slot decode step (dense and paged) hidden states and the
K/V they write, and greedy ``generate`` tokens. Tolerance 1e-5 (f32; the
two frameworks' matmuls sum in another order); tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import TransformerLM as JLM
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM

V, T, E, H, LAYERS = 50, 64, 32, 4, 2
S, TOTAL, PAGE = 3, 32, 8
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    jm = JLM(vocab_size=V, max_seq_len=T, embed_dim=E, num_heads=H,
             num_layers=LAYERS)
    jp = jm.init(jax.random.key(0))
    tm = TLM(vocab_size=V, max_seq_len=T, embed_dim=E, num_heads=H,
             num_layers=LAYERS, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _prompts(b, p, seed):
    return np.random.RandomState(seed).randint(0, V, (b, p)).astype(np.int32)


def test_params_keep_names_shapes_and_layout(models):
    jm, jp, tm, tp = models
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # the port's own init draws the same tree (other values)
    own = tm.init(0)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, jp))


def test_apply_logits_match(models):
    jm, jp, tm, tp = models
    toks = _prompts(2, 12, 1)
    want = jm.apply(jp, jnp.asarray(toks))
    got = tm.apply(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 12, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def prefilled(models):
    """Both packages prefill the same 3 prompts into caches of TOTAL."""
    jm, jp, tm, tp = models
    prompt = _prompts(S, 7, 2)
    hid_j, caches_j = jm._prefill(jp, jnp.asarray(prompt), TOTAL)
    hid_t, caches_t = tm._prefill(tp, torch.from_numpy(prompt), TOTAL)
    return hid_j, caches_j, hid_t, caches_t


def test_prefill_matches(prefilled):
    hid_j, caches_j, hid_t, caches_t = prefilled
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j), **TOL)
    for name, (kj, vj) in caches_j.items():
        kt, vt = caches_t[name]
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)


def _paged_from_dense(caches, table):
    """Page pools [1 + S*max_pages, H, PAGE, hd] holding the dense caches'
    bytes at the pages ``table`` maps (page 0, the null page, zeroed)."""
    out = {}
    for name, kv in caches.items():
        pools = []
        for c in kv:
            c = np.asarray(c)
            pool = np.zeros((1 + table.size, H, PAGE, E // H), c.dtype)
            for s in range(S):
                for lp in range(table.shape[1]):
                    pool[table[s, lp]] = c[s, :, lp * PAGE:(lp + 1) * PAGE]
            pools.append(pool)
        out[name] = tuple(pools)
    return out


def test_decode_slots_dense_and_paged_match(models, prefilled):
    """One fused decode step at per-slot positions through both packages,
    dense and paged (shuffled page table): hidden states and the written
    K/V agree; inside the port paged equals dense bitwise."""
    jm, jp, tm, tp = models
    _, caches_j, _, caches_t = prefilled
    toks = np.asarray([3, 17, 41], np.int32)
    pos = np.asarray([7, 5, 12], np.int32)
    hid_j, new_j = jm._decode_slots(jp, jnp.asarray(toks), jnp.asarray(pos),
                                    caches_j)
    dense_t = {n: tuple(c.clone() for c in kv)
               for n, kv in caches_t.items()}
    hid_t, new_t = tm._decode_slots(tp, torch.from_numpy(toks),
                                    torch.from_numpy(pos), dense_t)
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j), **TOL)
    for name, (kj, _) in new_j.items():
        np.testing.assert_allclose(new_t[name][0].numpy(), np.asarray(kj),
                                   **TOL)

    table = (1 + np.random.RandomState(3).permutation(S * (TOTAL // PAGE))
             ).reshape(S, TOTAL // PAGE).astype(np.int32)
    pools_t = {n: tuple(torch.from_numpy(p) for p in kv) for n, kv in
               _paged_from_dense({n: tuple(c.numpy() for c in kv)
                                  for n, kv in caches_t.items()},
                                 table).items()}
    pools_j = {n: tuple(jnp.asarray(p) for p in kv) for n, kv in
               _paged_from_dense(caches_j, table).items()}
    hid_pj, _ = jm._decode_slots(jp, jnp.asarray(toks), jnp.asarray(pos),
                                 pools_j, page_table=jnp.asarray(table),
                                 page_size=PAGE)
    hid_pt, _ = tm._decode_slots(tp, torch.from_numpy(toks),
                                 torch.from_numpy(pos), pools_t,
                                 page_table=torch.from_numpy(table),
                                 page_size=PAGE)
    np.testing.assert_allclose(hid_pt.numpy(), np.asarray(hid_pj), **TOL)
    np.testing.assert_array_equal(hid_pt.numpy(), hid_t.numpy())
    # the step wrote each slot's K at (table[s, pos // PAGE], pos % PAGE)
    for s in range(S):
        phys, off = table[s, pos[s] // PAGE], pos[s] % PAGE
        np.testing.assert_array_equal(
            pools_t["layer_0"][0][phys, :, off].numpy(),
            dense_t["layer_0"][0][s, :, pos[s]].numpy())


@pytest.mark.parametrize("eos", [False, True])
def test_greedy_generate_tokens_equal(models, eos):
    jm, jp, tm, tp = models
    prompt = _prompts(2, 6, 4)
    want = np.asarray(jm.generate(jp, jnp.asarray(prompt),
                                  max_new_tokens=10))
    eos_id = int(want[0, 6 + 3]) if eos else None
    if eos:
        want = np.asarray(jm.generate(jp, jnp.asarray(prompt),
                                      max_new_tokens=10, eos_id=eos_id))
    got = tm.generate(tp, torch.from_numpy(prompt), max_new_tokens=10,
                      eos_id=eos_id)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_unported_options_refuse(models):
    # MoE and sequence parallelism are ported (tests/test_torch_moe.py,
    # tests/test_torch_seq_parallel.py): moe_experts builds a model with
    # MoE layers; seq_axis without seq_axis_size >= 2 is refused as JAX
    # refuses it
    moe = TLM(vocab_size=V, moe_experts=4, device="cpu")
    assert "moe" in moe.init(0)["layer_1"]
    with pytest.raises(ValueError, match="seq_axis requires seq_axis_size"):
        TLM(vocab_size=V, seq_axis="seq", device="cpu")
    assert TLM(vocab_size=V, seq_axis="seq", seq_axis_size=2,
               device="cpu").seq_axis == "seq"
    # remat is ported (tests/test_torch_remat.py); a policy without it or
    # an unknown one is refused as JAX refuses it
    assert TLM(vocab_size=V, remat=True, device="cpu").remat
    with pytest.raises(ValueError, match="remat_policy"):
        TLM(vocab_size=V, remat_policy="dots_saveable", device="cpu")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TLM(vocab_size=V, remat=True, remat_policy="x", device="cpu")
    # sampling is ported: like JAX, a temperature needs a key
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="PRNG key"):
        tm.generate(tp, torch.zeros((1, 3), dtype=torch.int32),
                    max_new_tokens=2, temperature=0.5)
    out = tm.generate(tp, torch.zeros((1, 3), dtype=torch.int32),
                      max_new_tokens=2, temperature=0.5, key=3)
    assert out.shape == (1, 5)
