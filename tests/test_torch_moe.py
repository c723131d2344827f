"""Port parity: ``apex_tpu_torch.contrib.moe.MoEMLP`` against
``apex_tpu.contrib.moe.MoEMLP``.

The counterparts of every case of ``tests/test_moe.py`` on the JAX init
(``convert.params_from_jax``) and the same numpy tokens: the port's
``apply`` against JAX's and against the per-token numpy oracles (rtol
1e-4 / atol 1e-5), top-1 and top-2, the dropped fractions, gradient
flow, the config refusals, ``decode`` against ``apply``; and expert
parallelism over 4 gloo ranks (``_torch_dist.moe_ep_ops``, an
``"expert"`` axis, each rank its slice of the experts) against the dense
port (rtol 1e-5 / atol 1e-6; 1e-4 / 1e-5 at top 2, as the JAX tests
hold JAX's expert-parallel against its dense) and JAX's ``shard_map``
(another order of fp32 sums: the oracle tolerance, 1e-4 / 1e-5), the
gradients whole on every rank.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu.contrib.moe import MoEMLP as JMoE
from apex_tpu.models import TransformerLM as JLM
from apex_tpu.parallel import make_mesh
from apex_tpu_torch.contrib.moe import MoEMLP
from apex_tpu_torch.convert import params_from_jax

N, H, F, E = 64, 16, 32, 8
EP = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(key, **kw):
    """(JAX module, port module, JAX params as numpy, port params)."""
    jm = JMoE(hidden=H, ffn=F, num_experts=E, **kw)
    tm = MoEMLP(hidden=H, ffn=F, num_experts=E, device="cpu", **kw)
    jp = _np(jm.init(jax.random.key(key)))
    return jm, tm, jp, params_from_jax(jp, device="cpu")


def _data(seed=0):
    return np.asarray(jax.random.normal(jax.random.key(seed), (N, H)))


def _gelu(x):
    return np.asarray(jax.nn.gelu(x), np.float64)


def _ffn(params, e, t):
    hdn = _gelu(t @ np.asarray(params["w1"][e], np.float64)
                + np.asarray(params["b1"][e, 0], np.float64))
    return hdn @ np.asarray(params["w2"][e], np.float64) + \
        np.asarray(params["b2"][e, 0], np.float64)


def _probs(params, x):
    xf = np.asarray(x, np.float64)
    logits = xf @ np.asarray(params["router"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    return xf, probs / probs.sum(-1, keepdims=True)


def _oracle(params, x, capacity, e_total=E):
    xf, probs = _probs(params, x)
    expert = probs.argmax(-1)
    gate = probs[np.arange(len(xf)), expert]
    counts = {e: 0 for e in range(e_total)}
    out = np.zeros_like(xf)
    for i, (t, e) in enumerate(zip(xf, expert)):
        if counts[e] >= capacity:
            continue
        counts[e] += 1
        out[i] = gate[i] * _ffn(params, e, t)
    return out


def _oracle_top2(params, x, capacity):
    xf, probs = _probs(params, x)
    top2 = np.argsort(probs, axis=-1)[:, ::-1][:, :2]
    gsel = np.take_along_axis(probs, top2, 1)
    gates = gsel / gsel.sum(-1, keepdims=True)
    counts = {e: 0 for e in range(E)}
    out = np.zeros_like(xf)
    for choice in range(2):
        for i in range(len(xf)):
            e = int(top2[i, choice])
            if counts[e] >= capacity:
                continue
            counts[e] += 1
            out[i] += gates[i, choice] * _ffn(params, e, xf[i])
    return out


@pytest.mark.parametrize("cf", [4.0, 0.5])  # no drops / heavy drops
def test_matches_per_token_oracle(cf):
    jm, tm, jp, tp = _pair(1, capacity_factor=cf)
    x = _data()
    y, aux = tm.apply(tp, torch.from_numpy(x))
    jy, jaux = jm.apply(jp, jnp.asarray(x))
    want = _oracle(jp, x, tm.capacity(N))
    np.testing.assert_allclose(y.numpy().astype(np.float64), want,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    assert tm.capacity(N) == jm.capacity(N)
    assert float(aux["dropped_fraction"]) == float(jaux["dropped_fraction"])
    np.testing.assert_allclose(float(aux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), rtol=1e-5)
    if cf >= 4.0:
        assert float(aux["dropped_fraction"]) == 0.0
    else:
        assert float(aux["dropped_fraction"]) > 0.0


def test_grads_flow_to_router_and_experts():
    jm, tm, jp, tp = _pair(4, capacity_factor=2.0)
    x = _data(5)

    def jloss(p):
        y, aux = jm.apply(p, jnp.asarray(x))
        return jnp.sum(y ** 2) + 0.01 * aux["load_balance_loss"]

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, jp))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    y, aux = tm.apply(tp, torch.from_numpy(x))
    names = sorted(tp)
    gs = torch.autograd.grad((y ** 2).sum() + 0.01 *
                             aux["load_balance_loss"], [tp[n] for n in names])
    for n, g in zip(names, gs):
        assert torch.isfinite(g).all() and float(g.abs().sum()) > 0.0, n
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_config_validation():
    with pytest.raises(ValueError, match="divisible"):
        MoEMLP(hidden=H, ffn=F, num_experts=E, expert_axis="expert",
               expert_axis_size=3, device="cpu")
    with pytest.raises(ValueError, match=">= 2"):
        MoEMLP(hidden=H, ffn=F, num_experts=E, expert_axis="expert",
               expert_axis_size=1, device="cpu")


def test_init_names_shapes_and_scales():
    tm = MoEMLP(hidden=H, ffn=F, num_experts=E, device="cpu")
    p = tm.init(0)
    jp = JMoE(hidden=H, ffn=F, num_experts=E).init(jax.random.key(0))
    for k in jp:
        assert tuple(p[k].shape) == jp[k].shape and p[k].dtype == \
            torch.float32, k
    # normal draws at the JAX scales: router 0.02, experts sqrt(2/fan_in)
    assert abs(float(p["w1"].std()) - (2.0 / H) ** 0.5) < 0.05
    assert abs(float(p["w2"].std()) - (2.0 / F) ** 0.5) < 0.05
    assert abs(float(p["router"].std()) - 0.02) < 0.005
    assert torch.equal(tm.init(0)["w1"], p["w1"])


def test_ties_go_to_the_lower_expert_as_lax_top_k():
    """Equal router probs: lax.top_k picks the lower index, and so does
    the port (a stable sort)."""
    jm, tm, jp, tp = _pair(0, top_k=2, capacity_factor=4.0)
    jp = dict(jp, router=np.zeros((H, E), np.float32))
    tp = dict(tp, router=torch.zeros(H, E))
    x = _data(2)
    y, _ = tm.apply(tp, torch.from_numpy(x))
    jy, _ = jm.apply(jp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tm.decode(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jm.decode(jp, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


class TestTopK:
    @pytest.mark.parametrize("cf", [4.0, 0.75])
    def test_top2_matches_oracle(self, cf):
        jm, tm, jp, tp = _pair(3, capacity_factor=cf, top_k=2)
        x = _data(7)
        y, aux = tm.apply(tp, torch.from_numpy(x))
        jy, jaux = jm.apply(jp, jnp.asarray(x))
        np.testing.assert_allclose(y.numpy().astype(np.float64),
                                   _oracle_top2(jp, x, tm.capacity(N)),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-5)
        assert float(aux["dropped_fraction"]) == \
            float(jaux["dropped_fraction"])
        if cf >= 4.0:
            assert float(aux["dropped_fraction"]) == 0.0

    def test_first_choices_never_displaced(self):
        tm = MoEMLP(hidden=H, ffn=F, num_experts=2, top_k=2,
                    capacity_factor=1.0 / N, device="cpu")
        p = tm.init(0)
        p["router"] = torch.zeros(H, 2)
        p["router"][:, 0] = 1.0
        x = torch.from_numpy(np.abs(_data(1)) + 0.1)
        _, aux = tm.apply(p, x)
        np.testing.assert_allclose(float(aux["dropped_fraction"]),
                                   1.0 - 2 / (2 * N), rtol=1e-6)

    def test_top_k_validation(self):
        with pytest.raises(ValueError, match="top_k"):
            MoEMLP(hidden=H, ffn=F, num_experts=4, top_k=5, device="cpu")


def test_decode_matches_apply_when_capacity_generous():
    jm = JMoE(hidden=16, ffn=32, num_experts=4, top_k=2,
              capacity_factor=8.0)
    jp = _np(jm.init(jax.random.key(0)))
    p = params_from_jax(jp, device="cpu")
    x = np.asarray(jax.random.normal(jax.random.key(1), (12, 16)))
    generous = MoEMLP(hidden=16, ffn=32, num_experts=4, top_k=2,
                      capacity_factor=8.0, device="cpu")
    y_apply, aux = generous.apply(p, torch.from_numpy(x))
    assert float(aux["dropped_fraction"]) == 0.0
    y_dec = generous.decode(p, torch.from_numpy(x))
    np.testing.assert_allclose(y_apply.numpy(), y_dec.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(y_dec.numpy(),
                               np.asarray(jm.decode(jp, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    tight = MoEMLP(hidden=16, ffn=32, num_experts=4, top_k=2,
                   capacity_factor=0.25, device="cpu")
    y_tight, aux_tight = tight.apply(p, torch.from_numpy(x))
    assert float(aux_tight["dropped_fraction"]) > 0.0
    np.testing.assert_allclose(tight.decode(p, torch.from_numpy(x)).numpy(),
                               y_dec.numpy(), atol=1e-5, rtol=1e-5)
    assert not np.allclose(y_tight.numpy(), y_dec.numpy())
    with pytest.raises(NotImplementedError, match="single-device"):
        MoEMLP(hidden=16, ffn=32, num_experts=4, expert_axis="expert",
               expert_axis_size=2, device="cpu").decode(
            p, torch.from_numpy(x))


# -- expert parallelism over 4 ranks ------------------------------------------

LM_KW = dict(vocab_size=512, max_seq_len=32, embed_dim=32, num_heads=2,
             num_layers=2, moe_experts=4, moe_every=2,
             moe_capacity_factor=2.0)


@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory):
    jm = JMoE(hidden=H, ffn=F, num_experts=E, capacity_factor=1.5)
    params = _np(jm.init(jax.random.key(2)))
    x = _data(3)
    jlm = JLM(**LM_KW)
    params_lm = _np(jlm.init(jax.random.key(1)))
    toks = np.asarray(jax.random.randint(jax.random.key(2), (4, 17), 0, 512),
                      np.int64)
    inputs = dict(params=params, x=x, params_lm=params_lm, cfg_lm=LM_KW,
                  toks=toks)
    got = D.run_ranks(D.moe_ep_ops, EP, tmp_path_factory.mktemp("ep"),
                      timeout=120, mesh_axes={"expert": EP}, **inputs)
    return inputs, got


def _j_ep(top_k):
    moe_p = JMoE(hidden=H, ffn=F, num_experts=E, capacity_factor=1.5,
                 top_k=top_k, expert_axis="expert", expert_axis_size=EP)
    mesh = make_mesh({"expert": EP}, devices=jax.devices()[:EP])
    espec = {"router": P(), "w1": P("expert"), "b1": P("expert"),
             "w2": P("expert"), "b2": P("expert")}

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(espec, P()),
             out_specs=(P(), P()))
    def run(params, x):
        y, aux = moe_p.apply(params, x)
        return y, aux["dropped_fraction"]
    return run


@pytest.mark.parametrize("top_k,rtol,atol", [(1, 1e-5, 1e-6),
                                             (2, 1e-4, 1e-5)])
def test_expert_parallel_matches_dense(ep_ranks, top_k, rtol, atol):
    inputs, got = ep_ranks
    params, x = inputs["params"], inputs["x"]
    dense = MoEMLP(hidden=H, ffn=F, num_experts=E, capacity_factor=1.5,
                   top_k=top_k, device="cpu")
    tp = params_from_jax(params, device="cpu")
    y_d, aux_d = dense.apply(tp, torch.from_numpy(x))
    run = _j_ep(top_k)
    jparams = jax.tree.map(jnp.asarray, params)
    y_p, dropped = run(jparams, jnp.asarray(x))
    for r in got:
        np.testing.assert_allclose(r[f"y{top_k}"], y_d.numpy(), rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(r[f"y{top_k}"], np.asarray(y_p),
                                   rtol=rtol, atol=atol)
        assert float(r[f"dropped{top_k}"]) == \
            float(aux_d["dropped_fraction"]) == float(dropped)
    # gradients through the pvary dispatch and the psum combine: the
    # router's and the tokens' whole on every rank, the experts' per slice
    tpg = {k: v.requires_grad_(True) for k, v in tp.items()}
    xr = torch.from_numpy(x).requires_grad_(True)
    y, _ = dense.apply(tpg, xr)
    names = sorted(tpg)
    gs = dict(zip(names + ["x"], torch.autograd.grad(
        (y ** 2).sum(), [tpg[n] for n in names] + [xr])))
    jg = jax.grad(lambda p: jnp.sum(run(p, jnp.asarray(x))[0] ** 2))(jparams)
    el = E // EP
    for n in names + ["x"]:
        mine = np.concatenate([r[f"g{top_k}_{n}"] for r in got]) \
            if n not in ("router", "x") else None
        for r in got:
            if n in ("router", "x"):
                np.testing.assert_allclose(r[f"g{top_k}_{n}"],
                                           gs[n].numpy(), rtol=rtol,
                                           atol=atol, err_msg=n)
        if mine is not None:
            np.testing.assert_allclose(mine, gs[n].numpy(), rtol=rtol,
                                       atol=atol, err_msg=n)
            # across the packages: another order of fp32 sums, held at
            # the oracle tolerance of tests/test_moe.py
            np.testing.assert_allclose(mine, np.asarray(jg[n]), rtol=1e-4,
                                       atol=1e-5, err_msg=n)
            assert mine.shape[0] == el * EP
    np.testing.assert_allclose(got[0][f"g{top_k}_router"],
                               np.asarray(jg["router"]), rtol=1e-4,
                               atol=1e-5)


def test_lm_expert_parallel_matches_dense(ep_ranks):
    """tests/test_transformer.py's expert-parallel LM: the loss (rtol 2e-5
    / atol 2e-5) and, in the port, its gradients — the replicated ones
    whole on every rank, the experts' per slice."""
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.ops import flat as F
    inputs, got = ep_ranks
    jlm = JLM(**LM_KW)
    toks = inputs["toks"]
    loss_j = float(jlm.loss(jax.tree.map(jnp.asarray, inputs["params_lm"]),
                            jnp.asarray(toks, jnp.int32)))
    lm = TransformerLM(**LM_KW, device="cpu")
    p = params_from_jax(inputs["params_lm"], device="cpu")
    leaves = F.tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    loss = lm.loss(p, torch.from_numpy(toks))
    gs = torch.autograd.grad(loss, leaves)
    moe_ids = {id(t) for t in F.tree_leaves(p["layer_1"]["moe"])
               if t is not p["layer_1"]["moe"]["router"]}
    el = 4 // EP
    for r in got:
        np.testing.assert_allclose(float(r["lm_loss"]), loss_j, rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(float(r["lm_loss"]), float(loss),
                                   rtol=2e-5, atol=2e-5)
    for i, (t, g) in enumerate(zip(leaves, gs)):
        if id(t) in moe_ids:
            mine = np.concatenate([r[f"lm_g{i}"] for r in got])
            assert mine.shape[0] == el * EP
            np.testing.assert_allclose(mine, g.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=str(i))
        else:
            for r in got:
                np.testing.assert_allclose(r[f"lm_g{i}"], g.numpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=str(i))


# -- the engine serving an MoE LM ---------------------------------------------

SERVE_KW = dict(vocab_size=50, max_seq_len=64, embed_dim=32, num_heads=4,
                num_layers=2, moe_experts=4, moe_every=2)
ENGINE = dict(slots=3, max_len=32, prefill_chunk=4)


@pytest.fixture(scope="module")
def moe_serving():
    from apex_tpu.serve import ContinuousBatchingEngine as JEngine
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.serve import poisson_requests
    jm = JLM(**SERVE_KW)
    jp = jm.init(jax.random.key(0))
    tm = TransformerLM(**SERVE_KW, device="cpu")
    tp = params_from_jax(_np(jp), device="cpu")
    reqs = poisson_requests(8, rate=0.0, prompt_dist="uniform:3,10",
                            new_dist="uniform:2,8", vocab_size=50, seed=11,
                            max_len=32, prefill_chunk=4)
    jres, _ = JEngine(jm, jp, **ENGINE).run(reqs)
    return tm, tp, reqs, [r.tokens for r in jres]


@pytest.mark.parametrize("name", ["dense", "paged", "serial", "spec"])
def test_engine_serves_an_moe_lm(moe_serving, name):
    """The engine's programs run MoEMLP.decode in MoE layers: after
    warmup, greedy streams equal the JAX engine's on the same MoE model
    and generate's, paged and serialized equal dense."""
    from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                      draft_from_prefix)
    tm, tp, reqs, jtoks = moe_serving
    kw = {"dense": {}, "paged": dict(paged=True, page_size=8, kv_pages=8),
          "serial": dict(fused=False), "spec": dict(spec_k=2)}[name]
    if name == "spec":
        # a draft of both layers: a 1-layer prefix has no MoE layer, which
        # the model refuses (as JAX's does)
        kw["draft"] = draft_from_prefix(tm, tp, 2)
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", **ENGINE, **kw)
    eng.warmup()
    got, _ = eng.run(reqs)
    toks = [r.tokens for r in got]
    assert toks == jtoks
    for req, t in zip(reqs, toks):
        want = tm.generate(tp, torch.as_tensor(req.prompt)[None],
                           max_new_tokens=len(t))[0, len(req.prompt):]
        assert want.tolist() == list(t)
    assert all(p.captures == 0 for p in eng.programs.values())
