"""Port parity: AMP (``apex_tpu_torch.amp``) and the optimizer skip.

Policy presets and ``AmpError`` cases against the JAX package's; the
dynamic loss scaler driven through one found_inf pattern in both packages
(scale, unskipped and the event counters equal at every step); an
injected inf that skips a FusedLAMB step (masters and slots bitwise
unchanged, ``step`` not advanced, the scale halved) and a clean step
after it; the O2 wrapper's casts against JAX's ``cast_model_params``; the
handle's accumulation and census ops against the JAX handle's; O1's
autocast, left to a later slice, raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.amp import frontend as jfront
from apex_tpu.amp.policy import AmpError as JAmpError
from apex_tpu.amp.scaler import LossScaler as JScaler
from apex_tpu_torch import amp
from apex_tpu_torch.amp import frontend as tfront
from apex_tpu_torch.amp.policy import AmpError
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.optimizers import FusedLAMB

LEVELS = ["O0", "O1", "O2", "O3"]


def _dtname(d):
    if d is None:
        return None
    if isinstance(d, torch.dtype):
        return str(d).rsplit(".", 1)[-1]
    return jnp.dtype(d).name


def _fields(p):
    return (p.opt_level, _dtname(p.cast_model_dtype), p.autocast,
            p.keep_batchnorm_fp32, p.master_weights, p.loss_scale,
            _dtname(p.half_dtype), _dtname(p.compute_dtype), p.is_dynamic,
            p.static_scale)


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", LEVELS)
def test_presets_match_jax(level, half):
    want = jamp.make_policy(level, half_dtype=getattr(jnp, half))
    got = amp.make_policy(level, half_dtype=getattr(torch, half))
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("kw", [
    dict(loss_scale="128.0"), dict(keep_batchnorm_fp32="False"),
    dict(master_weights="True"), dict(cast_model_dtype="float16"),
])
def test_overrides_match_jax(kw):
    want = jamp.make_policy("O2", **kw)
    got = amp.make_policy("O2", **kw)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("level,kw", [
    ("O4", {}), ("O0", dict(half_dtype="float32")),
    ("O1", dict(cast_model_dtype="float16")),
    ("O1", dict(master_weights=True)),
    ("O1", dict(keep_batchnorm_fp32=True)),
    ("O2", dict(loss_scale="lots")),
    ("O2", dict(keep_batchnorm_fp32="yes")),
])
def test_amp_errors_match_jax(level, kw):
    with pytest.raises(JAmpError) as want:
        jamp.make_policy(level, **kw)
    with pytest.raises(AmpError) as got:
        amp.make_policy(level, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mls", [0.0, -1.0, "x", 2.0 ** 30])
def test_min_loss_scale_errors_match_jax(mls):
    jp = jamp.make_policy("O2", half_dtype=jnp.float16)
    tp = amp.make_policy("O2", half_dtype=torch.float16)
    with pytest.raises(JAmpError) as want:
        JScaler.from_policy(jp, min_loss_scale=mls)
    with pytest.raises(AmpError) as got:
        LossScaler.from_policy(tp, min_loss_scale=mls)
    assert str(got.value) == str(want.value)


def _state_tuple(st):
    return (float(st.scale), int(st.unskipped), int(st.step_count),
            int(st.overflow_count), int(st.growth_count))


@pytest.mark.parametrize("min_scale", [None, 2.0 ** 14])
def test_scaler_sequence_matches_jax(min_scale):
    cfg = dict(dynamic=True, scale_window=3, min_loss_scale=min_scale,
               max_loss_scale=2.0 ** 17)
    js, ts = JScaler(**cfg), LossScaler(**cfg)
    jst, tst = js.init(), ts.init("cpu")
    pattern = [0, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1]
    for i, f in enumerate(pattern):
        jst = js.update(jst, jnp.asarray(bool(f)))
        tst = ts.update(tst, torch.tensor(bool(f)))
        assert _state_tuple(tst) == _state_tuple(jst), f"step {i}"
    assert ts.state_dict(tst) == js.state_dict(jst)
    back = ts.load_state_dict(ts.state_dict(tst), device="cpu")
    assert _state_tuple(back) == _state_tuple(tst)


def test_static_scaler_only_counts():
    jp = jamp.make_policy("O2")
    tp = amp.make_policy("O2")
    js, ts = JScaler.from_policy(jp), LossScaler.from_policy(tp)
    jst, tst = js.init(), ts.init("cpu")
    for f in (True, False, True):
        jst = js.update(jst, jnp.asarray(f))
        tst = ts.update(tst, torch.tensor(f))
    assert _state_tuple(tst) == _state_tuple(jst)
    assert float(ts.scale_loss(torch.tensor(2.0), tst)) == 2.0


def _lamb(device="cpu"):
    rs = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rs.randn(40, 7).astype(np.float32)),
              "b": torch.from_numpy(rs.randn(7).astype(np.float32))}
    return FusedLAMB(params, lr=1e-2, device=device)


def test_injected_inf_skips_the_optimizer_step():
    _, handle = amp.initialize(opt_level="O2", half_dtype=torch.float16,
                               loss_scale="dynamic", verbosity=0)
    amp_state = handle.init_state("cpu")
    opt = _lamb()
    gs0 = opt.state[0]
    for _ in range(2):                               # slots become nonzero
        grad = torch.randn(opt._tables[0].total) * 65536.0
        grad, found = handle.unscale(grad, amp_state)
        opt.state = opt.apply_update(opt.state, [grad], found_inf=found)
        amp_state = handle.update(amp_state, found)
    gs1 = opt.state[0]
    assert int(gs1.step) == 2 and not torch.equal(gs1.master, gs0.master)
    grad = torch.randn(opt._tables[0].total) * 65536.0
    grad[5] = float("inf")
    grad, found = handle.unscale(grad, amp_state)
    assert bool(found)
    opt.state = opt.apply_update(opt.state, [grad], found_inf=found)
    amp_state = handle.update(amp_state, found)
    gs2 = opt.state[0]
    assert torch.equal(gs2.master, gs1.master)
    for k in gs1.slots:
        assert torch.equal(gs2.slots[k], gs1.slots[k])
    assert int(gs2.step) == 2
    assert float(handle.loss_scale(amp_state)) == 32768.0
    assert handle.state_dict(amp_state)["loss_scaler0"]["overflow_count"] == 1
    # the facade: a clean step advances
    opt.step_flat([torch.randn(opt._tables[0].total)],
                  found_inf=torch.tensor(False))
    assert int(opt.state[0].step) == 3


def _bn_tree(rs):
    return {"conv": rs.randn(3, 3, 2, 4).astype(np.float32),
            "bn_stem": {"weight": rs.rand(4).astype(np.float32),
                        "bias": rs.randn(4).astype(np.float32)},
            "fc": {"w": rs.randn(4, 3).astype(np.float32),
                   "b": rs.randn(3).astype(np.float32)},
            "count": np.arange(3, dtype=np.int32)}


@pytest.mark.parametrize("pred", [None, "bn"])
def test_cast_model_params_matches_jax(pred):
    tree = _bn_tree(np.random.RandomState(3))
    jpred = jfront._default_bn_predicate if pred else None
    tpred = tfront._default_bn_predicate if pred else None
    want = jfront.cast_model_params(jax_tree(tree), jnp.bfloat16, jpred)
    got = tfront.cast_model_params(torch_tree(tree), torch.bfloat16, tpred)
    for path in (("conv",), ("bn_stem", "weight"), ("fc", "w"), ("count",)):
        w, g = want, got
        for k in path:
            w, g = w[k], g[k]
        assert _dtname(g.dtype) == jnp.dtype(w.dtype).name, path
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def torch_tree(tree):
    return {k: torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def test_initialize_o2_wraps_casts_and_o1_raises():
    seen = {}

    def apply_fn(params, x):
        seen["w"], seen["bn"], seen["x"] = (params["fc"]["w"].dtype,
                                            params["bn_stem"]["weight"].dtype,
                                            x.dtype)
        return x.sum() * params["fc"]["w"].sum()

    tree = torch_tree(_bn_tree(np.random.RandomState(4)))
    wrapped, handle = amp.initialize(apply_fn, opt_level="O2", verbosity=0)
    out = wrapped(tree, torch.ones(2))
    assert seen == {"w": torch.bfloat16, "bn": torch.float32,
                    "x": torch.bfloat16}
    assert out.dtype == torch.float32
    assert handle.policy.loss_scale == 1.0 and not handle.scalers[0].dynamic
    wrapped0, _ = amp.initialize(apply_fn, opt_level="O0", verbosity=0)
    wrapped0(tree, torch.ones(2, dtype=torch.float64))
    assert seen["x"] == torch.float32
    # O1 runs the function under the per-op policy: params and input stay
    # fp32 (tests/test_torch_autocast.py holds the policy against JAX's)
    wrapped1, _ = amp.initialize(apply_fn, opt_level="O1", verbosity=0)
    assert wrapped1(tree, torch.ones(2)).dtype == torch.float32
    assert seen == {"w": torch.float32, "bn": torch.float32,
                    "x": torch.float32}
    # the handle's scaler ops are ported: the accumulation and the census
    # agree with the JAX handle's (tests/test_torch_accumulate.py holds
    # them case by case)
    _, h1 = amp.initialize(opt_level="O1", verbosity=0)   # no apply_fn
    _, jh1 = jamp.initialize(opt_level="O1", verbosity=0)
    st, jst = h1.init_state("cpu"), jh1.init_state()
    new = np.arange(128, dtype=np.float32) * 3.0
    got, fi = h1.unscale_with_stashed(torch.from_numpy(new),
                                      torch.ones(128), st)
    want, jfi = jh1.unscale_with_stashed(jnp.asarray(new), jnp.ones(128),
                                         jst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert not bool(fi) and not bool(jfi)
    acc, afi, loss = h1.accumulate_grads(
        lambda m, mb: torch.sum(m * mb), torch.ones(128),
        torch.full((2, 128), 2.0), st)
    assert float(afi) == 0.0 and float(loss) == 256.0
    assert torch.equal(acc, torch.full((128,), 2.0))
    new_st, carry = h1.update_with_census(st, torch.tensor(True),
                                          torch.from_numpy(new))
    jnew, jcarry = jh1.update_with_census(jst, jnp.asarray(True),
                                          jnp.asarray(new))
    assert h1.state_dict(new_st) == jh1.state_dict(jnew)
    assert int(carry.step) == int(jcarry.step) == 0
