"""Port parity: the ZeRO optimizers (``contrib.optimizers.distributed``:
``DistributedFusedAdam``, ``DistributedFusedLAMB``, ``ShardedState``)
on gloo ranks.

At 2 ranks, each rank with its own grads: ZeRO-Adam's masters equal, bit
for bit, the replicated ``FusedAdam`` fed DDP's average of the same grads
(the update is elementwise, and g0/2 + g1/2 == (g0 + g1)/2 exactly);
ZeRO-LAMB's within 1e-5 of ``FusedLAMB``'s (its per-tensor norms are
sums of the shards' rows); the e5m2 gather; a forced overflow keeps every
shard and the step; each rank holds half the state. At 4 ranks, against
``apex_tpu.contrib.optimizers`` under ``shard_map`` over 4 of the
conftest's 8 CPU devices on the same grads (the JAX tests' ``_run_dist``):
Adam within rtol 1e-5, atol 1e-6, LAMB within rtol 1e-4, atol 1e-5 (the
JAX tests' bars); the ``state_dict`` saved at 4 shards loads at 2, equal
to JAX's own 4→2 restore bit for bit, and through
``convert.zero_state_dict_from_jax``; the two-level mode (dcn 2 × ici 2)
against JAX's on 2 × 2 devices.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu.contrib.optimizers import DistributedFusedAdam as JZA
from apex_tpu.contrib.optimizers import DistributedFusedLAMB as JZL
from apex_tpu.ops import flat as JF
from apex_tpu.parallel import make_mesh as j_make_mesh
from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                               DistributedFusedLAMB,
                                               ShardedState)
from apex_tpu_torch.convert import (sharded_state_from_jax,
                                    zero_state_dict_from_jax)
from apex_tpu_torch.ops import flat as F


def _params():
    k1, k2 = jax.random.split(jax.random.key(0))
    return {"w": np.asarray(jax.random.normal(k1, (32, 16), jnp.float32)),
            "b": np.zeros((16,), np.float32),
            "emb": np.asarray(jax.random.normal(k2, (64, 8), jnp.float32))}


def _grads(key):
    return {k: np.asarray(jax.random.normal(jax.random.key(key), v.shape)
                          * 0.1) for k, v in _params().items()}


def _leaves(r, prefix):
    return [r[k] for k in sorted((k for k in r if k.startswith(prefix)
                                  and k[len(prefix):].isdigit()),
                                 key=lambda k: int(k[len(prefix):]))]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    steps = [[_grads(10 * s + r) for r in range(2)] for s in range(1, 4)]
    return D.run_ranks(D.zero_pairs, 2, tmp_path_factory.mktemp("zp"),
                       params=_params(), grads_steps=steps)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    steps = [_grads(k) for k in range(1, 4)]
    return steps, D.run_ranks(D.zero_jax, 4, tmp_path_factory.mktemp("z4"),
                              params=_params(), grads_steps=steps)


def test_zero_adam_is_bit_equal_to_replicated_fused_adam(pairs):
    for r in pairs:
        for a, b in zip(_leaves(r, "adam_zero"), _leaves(r, "adam_ref"),
                        strict=True):
            np.testing.assert_array_equal(a, b)
        assert int(r["adam_step"]) == 3
    for a, b in zip(_leaves(pairs[0], "adam_zero"),
                    _leaves(pairs[1], "adam_zero")):
        np.testing.assert_array_equal(a, b)


def test_zero_lamb_is_close_to_fused_lamb(pairs):
    for r in pairs:
        for a, b in zip(_leaves(r, "lamb_zero"), _leaves(r, "lamb_ref"),
                        strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_each_rank_holds_half_the_state(pairs):
    for name in ("adam", "lamb"):
        for r in pairs:
            assert int(r[f"{name}_bytes"]) == 3 * 4 * int(r[f"{name}_total"]) \
                // 2


def test_e5m2_gather_and_forced_overflow(pairs):
    for r in pairs:
        assert str(r["e5m2_dtype"]) == "torch.bfloat16"
        for a, b in zip(_leaves(r, "e5m2_params"), _leaves(r, "e5m2_want"),
                        strict=True):
            np.testing.assert_array_equal(a, b)
        assert int(r["skip_step"]) == 0 and bool(r["skip_same"])


def _jmesh(n=4):
    return j_make_mesh({"data": n}, devices=jax.devices()[:n])


def _jax_run(opt, steps, mesh=None):
    mesh = mesh or _jmesh()
    state = opt.init_state()

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(opt.state_pspec(), P()),
             out_specs=(opt.state_pspec(), P()), check_vma=False)
    def step(state, grads):
        return opt.shard_step(state, grads)

    out = None
    for g in steps:
        state, out = step(state, g)
    return state, out


@pytest.mark.parametrize("name,cls,kw,tol", [
    ("adam", JZA, dict(weight_decay=0.01), (1e-5, 1e-6)),
    ("lamb0", JZL, dict(weight_decay=0.01, max_grad_norm=0.0), (1e-4, 1e-5)),
    ("lamb5", JZL, dict(weight_decay=0.01, max_grad_norm=0.05),
     (1e-4, 1e-5)),
    ("nvlamb", JZL, dict(weight_decay=0.0, use_nvlamb=True), (1e-4, 1e-5))])
def test_four_shards_match_jax(four, name, cls, kw, tol):
    steps, got = four
    opt = cls(_params(), lr=1e-2, axis_name="data", num_shards=4, **kw)
    state, _ = _jax_run(opt, steps)
    want = jax.tree.leaves(JF.unflatten(state.master, opt.table))
    for r in got:
        for a, b in zip(_leaves(r, f"{name}_"), want, strict=True):
            np.testing.assert_allclose(a, np.asarray(b), rtol=tol[0],
                                       atol=tol[1])


def test_no_predivide_with_a_scale_matches_jax(four):
    """``gradient_predivide=False``: the shards' sum, times ``scale``."""
    steps, got = four
    opt = JZA(_params(), lr=1e-2, weight_decay=0.01, axis_name="data",
              num_shards=4, gradient_predivide=False)
    mesh = _jmesh()
    state = opt.init_state()
    f = jax.jit(jax.shard_map(
        lambda st, g: opt.shard_step(st, g, scale=0.25), mesh=mesh,
        in_specs=(opt.state_pspec(), P()),
        out_specs=(opt.state_pspec(), P()), check_vma=False))
    for g in steps:
        state, _ = f(state, g)
    want = jax.tree.leaves(JF.unflatten(state.master, opt.table))
    for r in got:
        for a, b in zip(_leaves(r, "nopre_"), want, strict=True):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_state_dict_reshards_four_to_two_like_jax(four):
    steps, got = four
    r = got[0]
    for other in got[1:]:
        for k in r:
            if k.startswith("sd_"):
                np.testing.assert_array_equal(r[k], other[k])
    names = sorted(_params())              # the trees' leaf order
    sd = {"format": "apex_tpu.zero_state/1",
          "master": dict(zip(names, _leaves(r, "sd_master"))),
          "slots": {"m": dict(zip(names, _leaves(r, "sd_m"))),
                    "v": dict(zip(names, _leaves(r, "sd_v")))},
          "step": int(r["sd_step"]), "hp": {}, "num_shards": 4}
    two = DistributedFusedAdam(_params(), lr=1e-2, weight_decay=0.01,
                               num_shards=2, device="cpu")
    st2 = two.load_state_dict(sd)
    assert isinstance(st2, ShardedState) and int(st2.step) == 3
    assert st2.master.numel() == two.total and two.total % 256 == 0
    # JAX's own 4 -> 2 restore
    j4 = JZA(_params(), lr=1e-2, weight_decay=0.01, axis_name="data",
             num_shards=4)
    jstate, _ = _jax_run(j4, steps)
    jsd = j4.state_dict(jstate)
    j2 = JZA(_params(), lr=1e-2, weight_decay=0.01, axis_name="data",
             num_shards=2)
    jst2 = j2.load_state_dict(jsd)
    np.testing.assert_allclose(st2.master.numpy(), np.asarray(jst2.master),
                               rtol=1e-5, atol=1e-6)
    # the JAX checkpoint through the converter, and the round trip
    st2j = two.load_state_dict(zero_state_dict_from_jax(jsd, device="cpu"))
    np.testing.assert_array_equal(st2j.master.numpy(),
                                  np.asarray(jst2.master))
    for k in ("m", "v"):
        np.testing.assert_array_equal(st2j.slots[k].numpy(),
                                      np.asarray(jst2.slots[k]))
    back = two.state_dict(st2j)
    for a, b in zip(F.tree_leaves(back["master"]),
                    jax.tree.leaves(jsd["master"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    full = sharded_state_from_jax(jst2, device="cpu")
    assert torch.equal(full.master, st2j.master)
    assert torch.equal(two.local_state(full, 1).slots["v"],
                       st2j.slots["v"][two.shard_size:])
    with pytest.raises(ValueError, match="not a ZeRO"):
        two.load_state_dict({"format": "other"})


@pytest.mark.parametrize("name,cls,kw", [
    ("two_adam", JZA, dict(weight_decay=0.01, adam_w_mode=True)),
    ("two_lamb", JZL, dict(weight_decay=0.01, use_nvlamb=False))])
def test_two_level_matches_jax(four, name, cls, kw):
    steps, got = four
    mesh = j_make_mesh({"dcn": 2, "ici": 2}, devices=jax.devices()[:4])
    opt = cls(_params(), lr=1e-2, axis_name="ici", num_shards=2,
              replica_axis_name="dcn", **kw)
    state, params = _jax_run(opt, steps, mesh)
    want = jax.tree.leaves(JF.unflatten(state.master, opt.table))
    for r in got:
        for a, b in zip(_leaves(r, f"{name}_"), want, strict=True):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        for a, b in zip(_leaves(r, f"{name}_params"),
                        jax.tree.leaves(params), strict=True):
            np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                       rtol=1e-2, atol=1e-3)


def test_layout_and_placements():
    opt = DistributedFusedLAMB(_params(), num_shards=4, device="cpu")
    jopt = JZL(_params(), num_shards=4)
    assert (opt.total, opt.shard_size) == (jopt.total, jopt.shard_size)
    assert opt.table.offsets == jopt.table.offsets
    spec = opt.state_pspec()
    assert type(spec.master[0]).__name__ == "Shard" and \
        type(spec.step[0]).__name__ == "Replicate"
    assert set(spec.slots) == {"m", "v"}
    assert opt.state_dict_specs()["num_shards"] == 4


def test_init_state_hands_over_the_initial_masters():
    """After ``init_state`` the optimizer holds no full-size buffer: the
    state is all a rank keeps, and a second call raises."""
    opt = DistributedFusedAdam(_params(), num_shards=4, device="cpu")
    jopt = JZA(_params(), num_shards=4)
    state = opt.init_state()
    np.testing.assert_array_equal(state.master.numpy(),
                                  np.asarray(jopt.init_state().master))
    held = [v for v in vars(opt).values() if isinstance(v, torch.Tensor)]
    assert not any(t.numel() >= opt.total for t in held)
    with pytest.raises(RuntimeError, match="load_state_dict"):
        opt.init_state()
