"""Port parity: the legacy mixed-precision API (``apex_tpu_torch.
fp16_utils``), ``optimizers.FusedAdagrad`` and the overflow census
(``apex_tpu_torch.prof``) against the JAX package's.

Every input is made with numpy from a seed and fed to both packages:
FusedAdagrad over three steps in both weight-decay modes;
``FP16_Optimizer`` with a static and a dynamic scale, ``clip_master_grads``
in its clipped, unclipped and nonfinite cases (tests/test_fp16_utils.py:
121-190), an overflowing step's ``last_culprits`` and ``amp_overflow``
note; the legacy scalers; the ``fp16util`` helpers; the census and
``update_with_census``; the state carried over by ``convert``. Tolerance
rtol 1e-5 / atol 1e-7 in fp32 (the frameworks round alike; sums in other
orders), exact where both are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fp16_utils as JF16
from apex_tpu.amp.scaler import LossScaler as JScaler
from apex_tpu.ops import flat as JFL
from apex_tpu.optimizers import FusedAdagrad as JAdagrad
from apex_tpu.prof import metrics as JM
from apex_tpu.prof import numerics as JN
from apex_tpu_torch import convert
from apex_tpu_torch import fp16_utils as F16
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.ops import flat as FL
from apex_tpu_torch.optimizers import FusedAdagrad
from apex_tpu_torch.prof import metrics as M
from apex_tpu_torch.prof import numerics as N

TOL = dict(rtol=1e-5, atol=1e-7)


def _np_params(seed=0):
    rs = np.random.RandomState(seed)
    return {"dense": {"w": rs.randn(8, 8).astype(np.float32),
                      "b": (rs.randn(8) * 0.1).astype(np.float32)},
            "batchnorm": {"scale": np.ones(8, np.float32),
                          "bias": np.zeros(8, np.float32)},
            "layers": [{"w": rs.randn(4, 8).astype(np.float32)},
                       {"w": rs.randn(3).astype(np.float32)}]}


def _np_grads(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (rs.randn(*a.shape) * scale)
                        .astype(np.float32), _np_params())


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return FL.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _same_tree(got, want, **tol):
    gl, wl = FL.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, np.float32)
        if tol:
            np.testing.assert_allclose(g, w, **tol)
        else:
            np.testing.assert_array_equal(g, w)


# -- FusedAdagrad -------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("w_mode", [False, True])
def test_fused_adagrad_three_steps_match_jax(w_mode, weight_decay):
    p = _np_params()
    kw = dict(lr=1e-2, weight_decay=weight_decay, adagrad_w_mode=w_mode)
    jopt = JAdagrad(_j(p), **kw)
    topt = FusedAdagrad(_t(p), device="cpu", **kw)
    assert topt.set_grad_none and "sum" in topt.state[0].slots
    for s in range(3):
        g = _np_grads(10 + s)
        want = jopt.step(_j(g))
        got = topt.step(_t(g))
        _same_tree(got, want, **TOL)
    np.testing.assert_allclose(topt.state[0].slots["sum"].numpy(),
                               np.asarray(jopt.state[0].slots["sum"]), **TOL)
    assert int(topt.state[0].step) == int(jopt.state[0].step) == 3


def test_fused_adagrad_state_carries_over_from_jax():
    p = _np_params()
    jopt = JAdagrad(_j(p), lr=1e-2, weight_decay=0.01)
    jopt.step(_j(_np_grads(1)))
    topt = FusedAdagrad(_t(p), lr=1e-2, weight_decay=0.01, device="cpu")
    topt.state = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jopt.state), device="cpu")
    topt2 = FusedAdagrad(_t(p), lr=1e-2, weight_decay=0.01, device="cpu")
    topt2.load_state_dict(convert.optimizer_state_dict_from_jax(
        jopt.state_dict(), device="cpu"))
    g = _np_grads(2)
    want = jopt.step(_j(g))
    _same_tree(topt.step(_t(g)), want, **TOL)
    _same_tree(topt2.step(_t(g)), want, **TOL)


# -- FP16_Optimizer -----------------------------------------------------------

def _fp16_pair(dynamic, **kw):
    p = _np_params()
    args = dict(dynamic_loss_scale=True) if dynamic \
        else dict(static_loss_scale=128.0)
    j = JF16.FP16_Optimizer(JAdagrad(_j(p), lr=1e-2, **kw), **args)
    t = F16.FP16_Optimizer(FusedAdagrad(_t(p), lr=1e-2, device="cpu", **kw),
                           **args)
    return j, t


@pytest.mark.parametrize("dynamic", [False, True])
def test_fp16_optimizer_steps_match_jax(dynamic):
    j, t = _fp16_pair(dynamic, weight_decay=0.01)
    assert t.loss_scale == j.loss_scale
    for s in range(3):
        g = _np_grads(20 + s, scale=j.loss_scale)
        _same_tree(t.step(_t(g)), j.step(_j(g)), **TOL)
        assert t.overflow == j.overflow is False
    np.testing.assert_allclose(
        float(t.scale_loss(torch.tensor(0.5))),
        float(j.scale_loss(jnp.float32(0.5))))
    td, jd = t.state_dict(), j.state_dict()
    assert td["loss_scaler"] == jd["loss_scaler"]
    assert (td["dynamic"], td["overflow"]) == (jd["dynamic"], jd["overflow"])


@pytest.mark.parametrize("case", ["clipped", "unclipped"])
def test_clip_master_grads_matches_jax(case):
    j, t = _fp16_pair(False)
    max_norm = 1.5 if case == "clipped" else 1e6
    g = _np_grads(3, scale=128.0 * (3.0 if case == "clipped" else 0.01))
    jc, jn = j.clip_master_grads(max_norm, _j(g))
    tc, tn = t.clip_master_grads(max_norm, _t(g))
    assert tn.dtype == torch.float32 and tn.dim() == 0
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    assert (float(tn) > max_norm) == (case == "clipped")
    _same_tree(tc, jc, rtol=1e-5, atol=1e-6)
    if case == "unclipped":
        _same_tree(tc, _j(g), rtol=1e-6)
    # the clipped grads step alike
    _same_tree(t.step(tc), j.step(jc), **TOL)


def test_clip_of_nonfinite_grads_passes_through_and_the_step_skips():
    j, t = _fp16_pair(True)
    g = jax.tree.map(lambda a: np.full_like(a, np.inf), _np_params())
    jc, jn = j.clip_master_grads(1.0, _j(g))
    tc, tn = t.clip_master_grads(1.0, _t(g))
    assert not np.isfinite(float(tn)) and not np.isfinite(float(jn))
    assert torch.isinf(tc["dense"]["w"]).all()
    before = FL.flatten(t.master_params_tree())[0].clone()
    t.step(tc)
    j.step(jc)
    assert t.overflow and j.overflow
    assert torch.equal(FL.flatten(t.master_params_tree())[0], before)
    assert t.loss_scale == j.loss_scale == 2.0 ** 15


def test_overflow_names_the_culprit_leaf_like_jax():
    j, t = _fp16_pair(True)
    g = _np_grads(4, scale=2.0 ** 16)
    g["layers"][1]["w"][1] = np.nan
    g["dense"]["w"][2, 3] = np.inf
    g["dense"]["w"][0, 0] = -np.inf
    JM._PENDING_NOTES.clear()
    M._PENDING_NOTES.clear()
    j.step(_j(g))
    t.step(_t(g))
    assert t.overflow and t.last_culprits == j.last_culprits
    assert [c["path"] for c in t.last_culprits] == ["dense/w", "layers/1/w"]
    (_, kind, _, fields), = M._PENDING_NOTES
    (_, jkind, _, jfields), = JM._PENDING_NOTES
    assert kind == jkind == "amp_overflow" and fields == jfields
    # the census stays off with track_numerics=False
    t2 = F16.FP16_Optimizer(FusedAdagrad(_t(_np_params()), device="cpu"),
                            dynamic_loss_scale=True, track_numerics=False)
    t2.step(_t(g))
    assert t2.overflow and t2.last_culprits == []


def test_fp16_optimizer_state_carries_over_from_jax():
    j, _ = _fp16_pair(True)
    j.step(_j(jax.tree.map(lambda a: np.full_like(a, np.nan),
                           _np_params())))
    j.step(_j(_np_grads(5, scale=j.loss_scale)))
    t = F16.FP16_Optimizer(FusedAdagrad(_t(_np_params()), lr=1e-2,
                                        device="cpu"),
                           dynamic_loss_scale=True)
    t.load_state_dict(convert.fp16_optimizer_state_from_jax(
        j.state_dict(), device="cpu"))
    assert t.loss_scale == j.loss_scale == 2.0 ** 15
    assert t.state_dict()["loss_scaler"] == j.state_dict()["loss_scaler"]
    g = _np_grads(6, scale=j.loss_scale)
    _same_tree(t.step(_t(g)), j.step(_j(g)), **TOL)


def test_fp16_optimizer_refusals_and_delegation():
    _, t = _fp16_pair(False)
    with pytest.raises(TypeError, match="pass the"):
        t.clip_master_grads(1.0)
    with pytest.raises(NotImplementedError):
        t.clip_master_grads(1.0, _t(_np_grads(1)), norm_type=1)
    with pytest.raises(NotImplementedError):
        t.step(_t(_np_grads(1)), closure=lambda: 0.0)
    assert t.param_groups is t.optimizer.param_groups
    assert t.state is t.optimizer.state
    assert t.backward(torch.tensor(2.0)).item() == 256.0
    t.zero_grad()
    t.update_master_grads()


# -- the legacy scalers -------------------------------------------------------

def test_dynamic_loss_scaler_sequence_matches_jax():
    js = JF16.DynamicLossScaler(init_scale=2.0 ** 8, scale_window=2)
    ts = F16.DynamicLossScaler(init_scale=2.0 ** 8, scale_window=2,
                               device="cpu")
    g = np.ones(128, np.float32)
    for bad in (True, False, False, True, False):
        x = g * (np.inf if bad else 1.0)
        np.testing.assert_array_equal(ts.unscale(torch.from_numpy(x)).numpy(),
                                      np.asarray(js.unscale(jnp.asarray(x))))
        js.update_scale()
        ts.update_scale()
        assert ts.loss_scale == js.loss_scale
    assert ts.state_dict() == js.state_dict()
    st = F16.LossScaler(scale=128.0, device="cpu")
    st.update_scale(overflow=True)
    assert st.loss_scale == JF16.LossScaler(scale=128.0).loss_scale == 128.0


def test_legacy_scaler_overflow_census_matches_jax():
    g = _np_grads(7)
    g["layers"][0]["w"][1, 2] = np.nan
    js, ts = JF16.DynamicLossScaler(), F16.DynamicLossScaler(device="cpu")
    assert ts.has_overflow(_t(g)) and js.has_overflow(_j(g))
    assert not ts.has_overflow(_t(_np_grads(8)))
    ts.update_scale(grads=_t(g))
    js.update_scale(grads=_j(g))
    assert ts.last_culprits == js.last_culprits
    assert ts.last_culprits[0]["path"] == "layers/0/w"
    assert ts.loss_scale == js.loss_scale == 2.0 ** 31
    ts2 = F16.DynamicLossScaler(device="cpu")
    ts2.load_state_dict(ts.state_dict())
    assert ts2.loss_scale == ts.loss_scale


# -- fp16util -----------------------------------------------------------------

def test_fp16util_helpers_match_jax():
    p = _np_params()
    for fn, args in ((F16.convert_network, (torch.bfloat16,)),
                     (F16.network_to_half, ()),
                     (F16.tofp16, (torch.bfloat16,))):
        got = fn(_t(p), *args)
        jfn = getattr(JF16, fn.__name__)
        want = jfn(_j(p), *[jnp.bfloat16 for _ in args])
        assert [str(x.dtype).split(".")[-1] for x in FL.tree_leaves(got)] \
            == [str(x.dtype) for x in jax.tree.leaves(want)]
    fixed = F16.bn_convert_float(F16.tofp16(_t(p), torch.bfloat16))
    jfixed = JF16.bn_convert_float(JF16.tofp16(_j(p), jnp.bfloat16))
    assert [x.dtype for x in FL.tree_leaves(fixed)] == [
        torch.float32 if str(x.dtype) == "float32" else torch.bfloat16
        for x in jax.tree.leaves(jfixed)]
    assert F16.BN_convert_float is F16.bn_convert_float
    assert F16.convert_module is F16.tofp16
    model, master, table = F16.prep_param_lists(_t(p))
    jmodel, jmaster, jtable = JF16.prep_param_lists(_j(p))
    np.testing.assert_array_equal(master.numpy(), np.asarray(jmaster))
    assert table.offsets == jtable.offsets
    _same_tree(model, jmodel)
    _same_tree(F16.prep_param_lists(_t(p), flat_master=False)[1], _j(p))
    g = FL.tree_map(lambda x: torch.ones_like(x, dtype=torch.bfloat16),
                    _t(p))
    fg = F16.model_grads_to_master_grads(g, table)
    jfg = JF16.model_grads_to_master_grads(
        jax.tree.map(lambda x: jnp.ones_like(x, jnp.bfloat16), _j(p)),
        jtable)
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jfg))
    _same_tree(F16.master_params_to_model_params(master, table),
               JF16.master_params_to_model_params(jmaster, jtable))
    assert F16.to_python_float(torch.tensor([2.5])) == 2.5


# -- the census ---------------------------------------------------------------

def _poisoned_grads():
    g = _np_grads(9)
    g["batchnorm"]["bias"][3] = np.inf
    g["layers"][1]["w"][:2] = np.nan
    g["dense"]["b"][0] = -np.inf
    return g


def test_census_matches_jax_on_a_tree_and_a_flat_buffer():
    g = _poisoned_grads()
    tmeta, jmeta = N.tree_meta(_t(g)), JN.tree_meta(_j(g))
    assert tmeta == N.TreeMeta(paths=jmeta.paths, sizes=jmeta.sizes)
    flat, table = FL.flatten(_t(g))
    jflat, jtable = JFL.flatten(_j(g))
    assert N.tree_meta(table).paths == JN.tree_meta(jtable).paths
    for got, want in ((N.grad_census(_t(g), step=4),
                       JN.grad_census(_j(g), step=4)),
                      (N.grad_census(flat, table=table),
                       JN.grad_census(jflat, table=jtable))):
        for f in ("inf_count", "nan_count", "abs_max", "step"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        assert N.culprit_table(tmeta, got) == JN.culprit_table(jmeta, want)
    empty = N.empty_census(tmeta.n, device="cpu")
    assert int(empty.step) == -1 and not empty.inf_count.any()
    kept = N.select_census(torch.tensor(False), N.grad_census(_t(g)), empty)
    assert N.culprit_table(tmeta, kept) == []


def test_update_with_census_matches_jax():
    jsc = JScaler(dynamic=True)
    tsc = LossScaler(dynamic=True)
    jst, tst = jsc.init(), tsc.init("cpu")
    jcar = tcar = None
    for s, bad in enumerate((False, True, False)):
        g = _poisoned_grads() if bad else _np_grads(30 + s)
        jflat, jtable = JFL.flatten(_j(g))
        tflat, ttable = FL.flatten(_t(g))
        jst, jcar = jsc.update_with_census(jst, jnp.asarray(bad), jflat,
                                           jcar, table=jtable)
        tst, tcar = tsc.update_with_census(tst, torch.tensor(bad), tflat,
                                           tcar, table=ttable)
        assert tsc.state_dict(tst) == jsc.state_dict(jst)
        assert int(tcar.step) == int(jcar.step)
        assert N.culprit_table(N.tree_meta(ttable), tcar) == \
            JN.culprit_table(JN.tree_meta(jtable), jcar)
    assert int(tcar.step) == 1
