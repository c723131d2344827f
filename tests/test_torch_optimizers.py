"""Port parity: FusedSGD, LARC and FusedNovoGrad against the JAX package's
classes (``apex_tpu.optimizers``).

Both packages build the same flat buffers from the same numpy params (two
param groups, the second with its own lr and weight decay); three updates
from the same numpy grads must leave the masters and every slot within
rtol 1e-5 (atol 1e-6 for values near 0). Also pinned: an overflow step
leaves every slot bit for bit as it was (NovoGrad's NaN-seeded norms
included), a ``state_dict`` round trip, LARC giving back the inner
optimizer's weight decay even when the update raises, LARC's functional
``apply_update`` reading the state it is given, ``torch.optim.SGD``
parity as tests/test_optimizers.py:58-70 has it, and the conversion of
the JAX state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import optimizers as J
from apex_tpu_torch import optimizers as T
from apex_tpu_torch.convert import opt_state_from_jax

RTOL, ATOL = 1e-5, 1e-6


def _groups(seed=0, lr2=0.05, wd2=1e-3):
    rs = np.random.RandomState(seed)
    trees = [{"w": rs.randn(7, 11).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)},
             {"e": rs.randn(300).astype(np.float32)}]
    return [{"params": trees[0]},
            {"params": trees[1], "lr": lr2, "weight_decay": wd2}]


def _build(jcls, tcls, groups, **kw):
    jopt = jcls([dict(g, params={k: jnp.asarray(v) for k, v in
                                 g["params"].items()}) for g in groups], **kw)
    topt = tcls([dict(g, params={k: torch.from_numpy(v) for k, v in
                                 g["params"].items()}) for g in groups],
                device="cpu", **kw)
    return jopt, topt


def _grads(tables, rs, scale=1.0):
    return [(rs.randn(t.total) * scale).astype(np.float32)
            * t.valid_mask().numpy() for t in tables]


def _close_states(ts, js):
    for a, b in zip(ts, js):
        assert int(a.step) == int(np.asarray(b.step))
        np.testing.assert_allclose(a.master.numpy(), np.asarray(b.master),
                                   rtol=RTOL, atol=ATOL)
        assert set(a.slots) == set(b.slots)
        for k in a.slots:
            np.testing.assert_allclose(a.slots[k].numpy(),
                                       np.asarray(b.slots[k]), rtol=RTOL,
                                       atol=ATOL)


def _three_steps(jopt, topt, seed=1, scale=1.0):
    """Three functional updates from the JAX state, converted."""
    js = jopt.init_state()
    ts = opt_state_from_jax(js, device="cpu")
    for a, b in zip(ts, topt.state):      # both packages lay buffers alike
        assert torch.equal(a.master, b.master)
    rs = np.random.RandomState(seed)
    for _ in range(3):
        grads = _grads(topt._tables, rs, scale)
        js = jopt.apply_update(js, [jnp.asarray(g) for g in grads])
        ts = topt.apply_update(ts, [torch.from_numpy(g) for g in grads])
    return ts, js


@pytest.mark.parametrize("kw", [
    dict(lr=0.1, momentum=0.9, weight_decay=1e-4),      # main_amp's
    dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-4),
    dict(lr=0.1, momentum=0.9, dampening=0.1, wd_after_momentum=True,
         weight_decay=1e-4),
    dict(lr=0.1),                                       # plain SGD
], ids=["main_amp", "nesterov", "dampening_wd_after", "no_momentum"])
def test_fused_sgd_matches_jax_over_three_steps(kw):
    ts, js = _three_steps(*_build(J.FusedSGD, T.FusedSGD, _groups(), **kw))
    _close_states(ts, js)


@pytest.mark.parametrize("norm_type", [0, 2])
@pytest.mark.parametrize("init_zero", [False, True])
def test_fused_novograd_matches_jax_over_three_steps(norm_type, init_zero):
    jopt, topt = _build(J.FusedNovoGrad, T.FusedNovoGrad, _groups(2),
                        lr=1e-2, weight_decay=1e-3, norm_type=norm_type,
                        init_zero=init_zero)
    v0 = topt.state[0].slots["exp_avg_sq"]
    assert v0.shape == (topt._tables[0].num_segments,)
    assert bool(torch.isnan(v0).all()) != init_zero
    ts, js = _three_steps(jopt, topt, seed=3)
    _close_states(ts, js)
    assert not torch.isnan(ts[0].slots["exp_avg_sq"]).any()


def test_fused_novograd_reg_inside_moment_matches_jax():
    ts, js = _three_steps(*_build(J.FusedNovoGrad, T.FusedNovoGrad,
                                  _groups(4), lr=1e-2, weight_decay=1e-2,
                                  reg_inside_moment=True,
                                  betas=(0.95, 0.98)), seed=5)
    _close_states(ts, js)


@pytest.mark.parametrize("clip", [True, False])
def test_larc_over_fused_sgd_matches_jax(clip):
    """The stateful facade on both sides: LARC's step flattens the grads
    trees, scales them per tensor and runs the inner FusedSGD with weight
    decay 0."""
    groups = _groups(6)
    jsgd, tsgd = _build(J.FusedSGD, T.FusedSGD, groups, lr=0.1,
                        momentum=0.9, weight_decay=1e-4)
    jl = J.LARC(jsgd, trust_coefficient=0.02, clip=clip)
    tl = T.LARC(tsgd, trust_coefficient=0.02, clip=clip)
    rs = np.random.RandomState(7)
    for _ in range(3):
        grads = _grads(tsgd._tables, rs)
        trees = [{k: g[o:o + n].reshape(s) for k, s, o, n in zip(
            ("b", "w") if i == 0 else ("e",), t.shapes, t.offsets, t.sizes)}
            for i, (g, t) in enumerate(zip(grads, tsgd._tables))]
        jl.step([{k: jnp.asarray(v) for k, v in t.items()} for t in trees])
        out = tl.step([{k: torch.from_numpy(v) for k, v in t.items()}
                       for t in trees])
    _close_states(tl.state, jl.state)
    assert out[1]["e"].shape == (300,)
    assert [hp["weight_decay"] for hp in tl.param_groups] == [1e-4, 1e-3]


def test_larc_apply_update_reads_the_state_it_is_given():
    groups = _groups(8)
    tl = T.LARC(T.FusedSGD([dict(g, params={k: torch.from_numpy(v) for k, v
                                            in g["params"].items()})
                            for g in groups], lr=0.1, momentum=0.9,
                           weight_decay=1e-4, device="cpu"))
    rs = np.random.RandomState(9)
    tl.step_flat([torch.from_numpy(g) for g in _grads(tl.optim._tables,
                                                      rs)])
    moved = tl.init_state()
    fresh = T.FusedSGD([dict(g, params={k: torch.from_numpy(v) for k, v in
                                        g["params"].items()})
                        for g in groups], lr=0.1, momentum=0.9,
                       weight_decay=1e-4, device="cpu")
    tl2 = T.LARC(fresh)
    grads = [torch.from_numpy(g) for g in _grads(tl.optim._tables, rs)]
    # the functional update of the fresh state through tl equals tl2's
    # stateful step on that state; tl's own state is left alone
    got = tl.apply_update(tl2.init_state(), grads)
    tl2.step_flat(grads)
    for a, b, c, d in zip(got, tl2.state, tl.state, moved):
        assert torch.equal(a.master, b.master)
        assert torch.equal(c.master, d.master)
        assert not torch.equal(a.master, d.master)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("kind", ["sgd", "larc", "novograd_l2",
                                  "novograd_linf"])
def test_overflow_step_leaves_every_slot_unchanged(kind):
    groups = [dict(g, params={k: torch.from_numpy(v) for k, v in
                              g["params"].items()}) for g in _groups(10)]
    if kind.startswith("novograd"):
        opt = T.FusedNovoGrad(groups, lr=1e-2, norm_type=0 if kind.endswith(
            "linf") else 2, device="cpu")
    else:
        opt = T.FusedSGD(groups, lr=0.1, momentum=0.9, weight_decay=1e-4,
                         device="cpu")
        if kind == "larc":
            opt = T.LARC(opt)
    tables = (opt.optim if kind == "larc" else opt)._tables
    rs = np.random.RandomState(11)
    bad = [torch.from_numpy(g) for g in _grads(tables, rs)]
    bad[0][3] = float("inf")
    s0 = opt.init_state()
    s1 = opt.apply_update(s0, bad, found_inf=torch.tensor(True))
    for a, b in zip(s0, s1):
        assert torch.equal(_bits(a.master), _bits(b.master))
        assert int(a.step) == int(b.step) == 0
        for k in a.slots:   # NovoGrad's norms are still NaN: compare bits
            assert torch.equal(_bits(a.slots[k]), _bits(b.slots[k])), k
    # a clean step afterwards seeds and moves as a first step
    good = [torch.from_numpy(g) for g in _grads(tables, rs)]
    s2 = opt.apply_update(s1, good, found_inf=torch.tensor(False))
    s3 = opt.apply_update(s0, good)
    for a, b in zip(s2, s3):
        assert int(a.step) == 1 and torch.equal(a.master, b.master)
        for k in a.slots:
            assert torch.equal(a.slots[k], b.slots[k])


@pytest.mark.parametrize("kind", ["sgd", "larc", "novograd"])
def test_state_dict_round_trip(kind):
    def make():
        groups = [dict(g, params={k: torch.from_numpy(v) for k, v in
                                  g["params"].items()})
                  for g in _groups(12)]
        if kind == "novograd":
            return T.FusedNovoGrad(groups, lr=1e-2, device="cpu")
        opt = T.FusedSGD(groups, lr=0.1, momentum=0.9, weight_decay=1e-4,
                         device="cpu")
        return T.LARC(opt) if kind == "larc" else opt

    a, b = make(), make()
    tables = (a.optim if kind == "larc" else a)._tables
    rs = np.random.RandomState(13)
    for _ in range(2):
        a.step_flat([torch.from_numpy(g) for g in _grads(tables, rs)])
    b.load_state_dict(a.state_dict())
    grads = [torch.from_numpy(g) for g in _grads(tables, rs)]
    a.step_flat(grads)
    b.step_flat(grads)
    for x, y in zip(a.state, b.state):
        assert int(x.step) == int(y.step) == 3
        assert torch.equal(x.master, y.master)
        for k in x.slots:
            assert torch.equal(x.slots[k], y.slots[k])
    assert a.param_groups == b.param_groups


def test_larc_restores_weight_decay_even_when_the_update_raises(
        monkeypatch):
    groups = [dict(g, params={k: torch.from_numpy(v) for k, v in
                              g["params"].items()}) for g in _groups(14)]
    sgd = T.FusedSGD(groups, lr=0.1, weight_decay=0.01, device="cpu")
    larc = T.LARC(sgd)
    rs = np.random.RandomState(15)
    grads = [torch.from_numpy(g) for g in _grads(sgd._tables, rs)]
    seen = []
    real = sgd.apply_update

    def spy(state, flat_grads, **kw):
        seen.append([hp["weight_decay"] for hp in sgd.param_groups])
        return real(state, flat_grads, **kw)

    monkeypatch.setattr(sgd, "apply_update", spy)
    larc.step_flat(grads)
    assert seen == [[0.0, 0.0]]              # the inner update ran without
    assert [hp["weight_decay"] for hp in sgd.param_groups] == [0.01, 1e-3]

    def boom(*a, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(sgd, "apply_update", boom)
    with pytest.raises(RuntimeError, match="boom"):
        larc.step_flat(grads)
    assert [hp["weight_decay"] for hp in sgd.param_groups] == [0.01, 1e-3]


@pytest.mark.parametrize("nesterov", [False, True])
def test_fused_sgd_vs_torch_optim_sgd(nesterov):
    """tests/test_optimizers.py:58-70 on the port: seven steps, one group."""
    rs = np.random.RandomState(16)
    w, b = rs.randn(33, 7).astype(np.float32), rs.randn(7).astype(np.float32)
    opt = T.FusedSGD({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                     lr=0.05, momentum=0.9, weight_decay=1e-4,
                     nesterov=nesterov, device="cpu")
    tp = [torch.nn.Parameter(torch.from_numpy(b.copy())),
          torch.nn.Parameter(torch.from_numpy(w.copy()))]
    topt = torch.optim.SGD(tp, lr=0.05, momentum=0.9, weight_decay=1e-4,
                           nesterov=nesterov)
    for _ in range(7):
        gb, gw = rs.randn(7).astype(np.float32), rs.randn(33, 7).astype(
            np.float32)
        tp[0].grad, tp[1].grad = torch.from_numpy(gb), torch.from_numpy(gw)
        topt.step()
        out = opt.step({"w": torch.from_numpy(gw), "b": torch.from_numpy(gb)})
    torch.testing.assert_close(out["b"], tp[0].detach(), atol=1e-6, rtol=0)
    torch.testing.assert_close(out["w"], tp[1].detach(), atol=1e-6, rtol=0)


def test_constructor_refusals_match_jax():
    p = {"w": torch.zeros(4)}
    with pytest.raises(ValueError, match="Nesterov"):
        T.FusedSGD(p, lr=0.1, nesterov=True, device="cpu")
    with pytest.raises(ValueError, match="Nesterov"):
        J.FusedSGD({"w": jnp.zeros(4)}, lr=0.1, nesterov=True)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        T.FusedNovoGrad(p, amsgrad=True, device="cpu")
    with pytest.raises(RuntimeError, match="l2/inf"):
        T.FusedNovoGrad(p, norm_type=1, device="cpu")
    # accepted for drop-in parity
    T.FusedSGD(p, lr=0.1, materialize_master_grads=False, device="cpu")


@pytest.mark.parametrize("jcls,tcls,kw,slot,shape", [
    (J.FusedSGD, T.FusedSGD, dict(lr=0.1, momentum=0.9), "momentum_buffer",
     "flat"),
    (J.FusedNovoGrad, T.FusedNovoGrad, {}, "exp_avg_sq", "segments")])
def test_opt_state_from_jax_carries_the_slots(jcls, tcls, kw, slot, shape):
    jopt, topt = _build(jcls, tcls, _groups(17), **kw)
    rs = np.random.RandomState(18)
    js = jopt.apply_update(jopt.init_state(), [
        jnp.asarray(g) for g in _grads(topt._tables, rs)])
    ts = opt_state_from_jax(js, device="cpu")
    for a, b, t in zip(ts, js, topt._tables):
        assert a.slots[slot].dtype == torch.float32
        assert a.slots[slot].shape == ((t.total,) if shape == "flat"
                                       else (t.num_segments,))
        np.testing.assert_array_equal(a.slots[slot].numpy(),
                                      np.asarray(b.slots[slot]))
        assert int(a.step) == 1
    # the initial NovoGrad state's NaN marks survive the conversion
    if slot == "exp_avg_sq":
        v = opt_state_from_jax(jopt.init_state(), device="cpu")[0].slots[slot]
        assert bool(torch.isnan(v).all())
