"""Port parity: ``TransformerLM`` under sequence parallelism and with MoE
layers against ``apex_tpu.models.TransformerLM``.

The counterparts of ``tests/test_transformer.py:93-199`` and
``:347-400`` and of ``TestMoETransformer`` (the expert-parallel LM is in
``tests/test_torch_moe.py``): the port's ranks are 4 gloo child
processes over a ``"seq"`` axis (``_torch_dist.seq_lm_ops``, one run for
the module), each with its shard of the time axis; the JAX side runs
``shard_map`` over 4 of the conftest's 8 CPU devices on the same JAX
init (``convert.params_from_jax``) and tokens. Logits and losses rtol
2e-4, grads rtol 5e-3 / atol 1e-5, the JAX tests' tolerances. The port's
grads are each rank's partial of the replicated loss summed over the
axis (``parallel.collectives``' rule), which is what JAX's ``pmean``
over ``check_vma=False`` grads gives; held against both the
single-device oracle and JAX's in-shard_map grads. ``SeqParallelTrainer``
(train_ring's step) is held against ``LMTrainer`` on the whole sequence.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu.models import TransformerLM as JLM
from apex_tpu.parallel import make_mesh
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM
from apex_tpu_torch.ops import flat as F
from apex_tpu_torch.train import LMTrainer

V, T, B = 50, 32, 2
N = 4
CFG = dict(vocab_size=V, max_seq_len=64, embed_dim=32, num_heads=4,
           num_layers=2)


def _jmodel(**kw):
    return JLM(**CFG, **kw)


def _tokens(key=0):
    return jax.random.randint(jax.random.key(key), (B, T), 0, V)


def _mesh():
    return make_mesh({"seq": N}, devices=jax.devices()[:N])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """JAX leaves in the port's order (``ops.flat.tree_leaves``: sorted
    keys, as jax.tree's dict order)."""
    return jax.tree.leaves(tree)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params = _np(_jmodel().init(jax.random.key(0)))
    toks = np.asarray(_tokens(), np.int64)
    rs = np.random.RandomState(0)
    base = rs.randint(0, V, (4, T // 8))
    steps_toks = np.repeat(base, 8, axis=1).astype(np.int64)
    got = D.run_ranks(D.seq_lm_ops, N, tmp_path_factory.mktemp("seq"),
                      timeout=180, mesh_axes={"seq": N}, cfg=CFG,
                      params=params, toks=toks, steps_toks=steps_toks)
    return params, toks, steps_toks, got


def _oracle(single, toks):
    def f(q):
        logits = single.apply(q, toks)[:, :-1]
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, toks[:, 1:, None], -1))
    return f


def _sp_loss(sp):
    @jax.jit
    @partial(shard_map, mesh=_mesh(), in_specs=(P(), P(None, "seq")),
             out_specs=P(), check_vma=False)
    def f(p, toks):
        return sp.loss(p, toks, is_training=False)
    return f


def _check_grads(got, prefix, want, rtol=5e-3, atol=1e-5):
    want = _leaves(want)
    for r in got:
        for i, w in enumerate(want):
            np.testing.assert_allclose(r[f"{prefix}{i}"], np.asarray(w),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{prefix}{i}")


def test_sequence_parallel_matches_single_device(ranks):
    params, toks, _, got = ranks
    sp = _jmodel(seq_axis="seq", seq_axis_size=N)

    @jax.jit
    @partial(shard_map, mesh=_mesh(), in_specs=(P(), P(None, "seq")),
             out_specs=P(None, "seq"), check_vma=False)
    def run_sp(p, toks):
        return sp.apply(p, toks)

    mine = np.concatenate([r["logits"] for r in got], axis=1)
    np.testing.assert_allclose(mine, np.asarray(run_sp(params, toks)),
                               rtol=2e-4, atol=2e-4)
    single = TransformerLM(**CFG, device="cpu")
    np.testing.assert_allclose(
        mine, single.apply(params_from_jax(params, device="cpu"),
                           torch.from_numpy(toks)).numpy(),
        rtol=2e-4, atol=2e-4)


def test_sequence_parallel_loss_matches_single_device(ranks):
    params, toks, _, got = ranks
    jp = jax.tree.map(jnp.asarray, params)
    oracle = _oracle(_jmodel(), jnp.asarray(toks))
    want = float(oracle(jp))
    jsp = float(_sp_loss(_jmodel(seq_axis="seq", seq_axis_size=N))(
        jp, jnp.asarray(toks)))
    for r in got:      # the global mean, the same on every rank
        np.testing.assert_allclose(float(r["dense_loss"]), want, rtol=2e-4)
        np.testing.assert_allclose(float(r["dense_loss"]), jsp, rtol=2e-4)
    _check_grads(got, "dense_g", jax.grad(oracle)(jp))


def test_sequence_parallel_grads_inside_shard_map(ranks):
    """train_ring.py's pattern: JAX's grads inside shard_map, pmean'd
    (check_vma=False: each shard's raw grad is n x its partial); the
    port's partials summed. Both equal the global gradient."""
    params, toks, _, got = ranks
    sp = _jmodel(seq_axis="seq", seq_axis_size=N)

    @jax.jit
    @partial(shard_map, mesh=_mesh(), in_specs=(P(), P(None, "seq")),
             out_specs=P(), check_vma=False)
    def sp_grads(p, toks):
        g = jax.grad(lambda q: sp.loss(q, toks, is_training=False))(p)
        return jax.tree.map(lambda x: jax.lax.pmean(x, "seq"), g)

    jg = sp_grads(jax.tree.map(jnp.asarray, params), jnp.asarray(toks))
    _check_grads(got, "dense_g", jg)
    # a rank's own grad is a partial, not the whole: the sum is the rule
    whole = _leaves(jg)
    assert any(not np.allclose(got[0]["partial_g" + str(i)],
                               np.asarray(w), rtol=5e-3, atol=1e-5)
               for i, w in enumerate(whole))


def test_sequence_parallel_grads_match(ranks):
    params, toks, _, got = ranks
    single = _jmodel()
    jp = jax.tree.map(jnp.asarray, params)
    g1 = jax.grad(lambda q: jnp.mean(single.apply(q, jnp.asarray(toks))
                                     ** 2))(jp)
    _check_grads(got, "sq_g", g1)


def test_head_chunk_sequence_parallel_matches(ranks):
    params, toks, _, got = ranks
    jp = jax.tree.map(jnp.asarray, params)
    want = float(_oracle(_jmodel(head_chunk=10), jnp.asarray(toks))(jp))
    jsp = float(_sp_loss(_jmodel(seq_axis="seq", seq_axis_size=N,
                                 head_chunk=10))(jp, jnp.asarray(toks)))
    for r in got:
        np.testing.assert_allclose(float(r["chunk_loss"]), want, rtol=2e-4)
        np.testing.assert_allclose(float(r["chunk_loss"]), jsp, rtol=2e-4)


def test_head_chunk_sequence_parallel_grads_match(ranks):
    params, toks, _, got = ranks
    jp = jax.tree.map(jnp.asarray, params)
    _check_grads(got, "chunk_g",
                 jax.grad(_oracle(_jmodel(), jnp.asarray(toks)))(jp))


@pytest.mark.parametrize("arm", ["plain", "accum"])
def test_seq_parallel_trainer_matches_whole_sequence(ranks, arm):
    """train_ring's step (grads summed over seq, FusedAdam replicated) on
    4 shards against LMTrainer on the whole sequence, fp32: step 1's
    reduced grad (before any update) at the grads' tolerance, 3 steps'
    losses at the losses', and the masters in mean (Adam moves a weight
    by about lr whatever its grad's size, so a grad near zero whose
    rounding differs moves it by up to 2 lr: elementwise the masters are
    a reading); the ranks agree bit for bit."""
    params, _, steps_toks, got = ranks
    kw = {} if arm == "plain" else {"microbatches": 2,
                                    "loss_scale": "dynamic"}
    lm = TransformerLM(**CFG, device="cpu")
    tr = LMTrainer(lm, params_from_jax(params, device="cpu"), lr=3e-3,
                   dtype=None, device="cpu", **kw)
    toks = torch.from_numpy(steps_toks)
    grad1 = tr.loss_and_grad(toks)[0] if arm == "plain" else \
        tr.accumulate_grads(toks)[0]
    losses = [float(tr.step(toks)) for _ in range(3)]
    for r in got:
        for k in ("grad1", "losses", "master"):
            np.testing.assert_array_equal(r[f"{arm}_{k}"],
                                          got[0][f"{arm}_{k}"])
    np.testing.assert_allclose(got[0][f"{arm}_grad1"], grad1.numpy(),
                               rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(got[0][f"{arm}_losses"], losses, rtol=2e-4)
    assert losses[-1] < losses[0]
    gap = np.abs(got[0][f"{arm}_master"] - tr.opt.state[0].master.numpy())
    assert gap.mean() < 1e-5 and gap.max() <= 2 * 3 * 3e-3, \
        (gap.mean(), gap.max())
    # the step's collectives: 3 rotations of K/V a layer each way and the
    # targets' shift, the loss's sum (per microbatch) and the grad's
    micro = 1 if arm == "plain" else 2
    want = {"ppermute[seq]": micro * (2 * 3 * 2 + 1),
            "psum[seq]": micro + 1}
    if arm == "accum":
        want["pmax[seq]"] = 1
    assert {k: int(v) for k, v in got[0][f"{arm}_tally"].tolist()} == want


# -- MoE layers ---------------------------------------------------------------

class TestMoETransformer:
    """TransformerLM with Switch-MoE FFN layers (moe_experts set)."""

    KW = dict(vocab_size=512, max_seq_len=32, embed_dim=32, num_heads=2,
              num_layers=2, moe_experts=4, moe_every=2,
              moe_capacity_factor=2.0)

    def test_init_puts_moe_in_moe_layers(self):
        lm = TransformerLM(**self.KW, device="cpu")
        p = lm.init(0)
        assert "moe" in p["layer_1"] and "mlp" in p["layer_0"]
        assert "mlp" not in p["layer_1"]
        jp = JLM(**self.KW).init(jax.random.key(0))
        assert jax.tree.structure(jp) == jax.tree.structure(
            jax.tree.map(lambda t: 0, {k: v for k, v in p.items()}))
        for a, b in zip(_leaves(jp), F.tree_leaves(p)):
            assert tuple(a.shape) == tuple(b.shape)

    @pytest.mark.parametrize("top_k", [1, 2])
    def test_moe_loss_and_grads_match_jax(self, top_k):
        kw = dict(self.KW, moe_top_k=top_k)
        jlm = JLM(**kw)
        jp = jlm.init(jax.random.key(1))
        toks = jax.random.randint(jax.random.key(2), (4, 17), 0, 512)
        lm = TransformerLM(**kw, device="cpu")
        p = params_from_jax(_np(jp), device="cpu")
        leaves = F.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = lm.loss(p, torch.from_numpy(np.asarray(toks, np.int64)))
        gs = torch.autograd.grad(loss, leaves)
        jl, jg = jax.value_and_grad(lambda q: jlm.loss(q, toks))(jp)
        np.testing.assert_allclose(float(loss), float(jl), rtol=2e-5,
                                   atol=2e-5)
        for i, (a, b) in enumerate(zip(gs, _leaves(jg))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-3,
                                       atol=1e-5, err_msg=str(i))
        out, aux = lm.apply(p, torch.from_numpy(np.asarray(toks, np.int64)),
                            return_aux=True)
        jout, jaux = jlm.apply(jp, toks, return_aux=True)
        for k in jaux:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)

    def test_moe_lm_trains(self):
        lm = TransformerLM(**self.KW, device="cpu")
        params = lm.init(0)
        rs = np.random.RandomState(0)
        toks = torch.from_numpy(np.repeat(rs.randint(0, 512, (4, 4)), 4,
                                          axis=1))
        leaves = F.tree_leaves(params)
        losses = []
        for _ in range(10):
            for t in leaves:
                t.requires_grad_(True)
            loss = lm.loss(params, toks)
            gs = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for t, g in zip(leaves, gs):
                    t.sub_(0.5 * g)
            losses.append(float(loss))
        assert losses[-1] < losses[0] - 0.5, losses

    def test_remat_with_moe(self):
        lm = TransformerLM(vocab_size=128, max_seq_len=16, embed_dim=32,
                           num_heads=2, num_layers=2, moe_experts=4,
                           moe_every=2, device="cpu")
        lm_r = dataclasses.replace(lm, remat=True)
        params = lm.init(0)
        toks = torch.from_numpy(np.random.RandomState(1).randint(
            0, 128, (2, 9)))
        leaves = F.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        l0 = lm.loss(params, toks)
        g0 = torch.autograd.grad(l0, leaves)
        l1 = lm_r.loss(params, toks)
        g1 = torch.autograd.grad(l1, leaves)
        assert float(l0) == float(l1)
        for a, b in zip(g0, g1):
            assert torch.isfinite(b).all()
            assert torch.equal(a, b)

    def test_generate_moe_matches_full_recompute(self):
        kw = dict(CFG, moe_experts=4, moe_every=2, moe_capacity_factor=4.0)
        jlm = JLM(**kw)
        jp = jlm.init(jax.random.key(2))
        prompt = jax.random.randint(jax.random.key(3), (2, 4), 0, V)
        lm = TransformerLM(**kw, device="cpu")
        p = params_from_jax(_np(jp), device="cpu")
        out = lm.generate(p, torch.from_numpy(np.asarray(prompt)),
                          max_new_tokens=4)
        buf = np.asarray(prompt)
        for _ in range(4):
            logits = lm.apply(p, torch.from_numpy(buf))
            nxt = logits[:, -1].argmax(-1).numpy().astype(np.int32)
            buf = np.concatenate([buf, nxt[:, None]], axis=1)
        np.testing.assert_array_equal(out.numpy(), buf)
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jlm.generate(jp, prompt,
                                                 max_new_tokens=4)))

    def test_decode_slots_matches_decode_one(self):
        """The fused slot-batched decode step of an MoE stack equals
        ``_decode_one`` slot by slot (hidden states and cache writes) and
        JAX's ``_decode_slots``."""
        kw = dict(CFG, moe_experts=2, moe_every=2)
        jlm = JLM(**kw)
        jp = jlm.init(jax.random.key(0))
        lm = TransformerLM(**kw, device="cpu")
        p = params_from_jax(_np(jp), device="cpu")
        s, max_len = 3, 32
        h, hd = lm.num_heads, lm.embed_dim // lm.num_heads
        rs = np.random.RandomState(1)
        caches = {f"layer_{i}": tuple(
            rs.randn(s, h, max_len, hd).astype(np.float32) for _ in range(2))
            for i in range(lm.num_layers)}
        toks = np.asarray([3, 11, 42], np.int32)
        pos = np.asarray([0, 5, 17], np.int32)

        def tcaches():
            return {k: tuple(torch.from_numpy(a.copy()) for a in v)
                    for k, v in caches.items()}

        hid_f, c_f = lm._decode_slots(p, torch.from_numpy(toks),
                                      torch.from_numpy(pos), tcaches())
        for j in range(s):
            cj = {k: tuple(a[j:j + 1].clone() for a in v)
                  for k, v in tcaches().items()}
            hid, cj = lm._decode_one(p, torch.from_numpy(toks[j:j + 1]),
                                     int(pos[j]), cj)
            np.testing.assert_allclose(hid[0].numpy(), hid_f[j].numpy(),
                                       rtol=1e-5, atol=1e-6)
            for k in cj:
                for a, b in zip(cj[k], c_f[k]):
                    np.testing.assert_allclose(a[0].numpy(), b[j].numpy(),
                                               rtol=1e-5, atol=1e-6)
        jh, _ = jlm._decode_slots(jp, jnp.asarray(toks), jnp.asarray(pos),
                                  jax.tree.map(jnp.asarray, caches))
        np.testing.assert_allclose(hid_f.numpy(), np.asarray(jh), rtol=1e-4,
                                   atol=1e-5)


def test_config_validation_and_refusals(monkeypatch):
    with pytest.raises(ValueError, match="seq_axis_size >= 2"):
        TransformerLM(**CFG, seq_axis="seq", device="cpu")
    with pytest.raises(ValueError, match="moe_every"):
        TransformerLM(**CFG, moe_experts=4, moe_every=0, device="cpu")
    with pytest.raises(ValueError, match="silently dense"):
        TransformerLM(**CFG, moe_experts=4, moe_every=3, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        TransformerLM(**CFG, moe_experts=2, moe_top_k=3, device="cpu")
    sp = TransformerLM(**CFG, seq_axis="seq", seq_axis_size=2, device="cpu")
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        sp.generate(sp.init(0), torch.zeros((1, 2), dtype=torch.int32),
                    max_new_tokens=1)
    # the guard on the global length: 2 shards of 40 pass max_seq_len 64
    from apex_tpu_torch.parallel import collectives as C
    monkeypatch.setattr(C, "axis_index", lambda name: 0)
    with pytest.raises(ValueError, match="sequence length 80"):
        sp.apply(sp.init(0), torch.zeros((1, 40), dtype=torch.long))
