"""Port parity: ``apex_tpu_torch.parallel.pipeline`` (GPipe) against
``apex_tpu.parallel.pipeline``.

The counterparts of every case of ``tests/test_pipeline.py``: the port's
ranks are gloo child processes over a ``"pipe"`` axis of 4 stages
(``_torch_dist.pipe_ops``), and over a ``"data"`` axis of 2 outside 2
stages for the composition; the JAX side runs ``shard_map`` over the
conftest's CPU devices on the same layers and batch. Outputs and losses
rtol 1e-5 / atol 1e-5 (losses atol 1e-6), grads rtol 1e-4 / atol 1e-5,
the JAX tests' tolerances. The grads are taken on each rank (JAX's
"inside shard_map" pattern): by ``parallel.collectives``' rule a stage's
layer grads are exact on the rank that holds them, not ``num_stages``
times over, and the input's grad, held on rank 0, sums over the axis to
the serial one.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu.parallel import gpipe as j_gpipe
from apex_tpu.parallel import make_mesh
from apex_tpu.parallel import stack_layers as j_stack
from apex_tpu.parallel import unstack_layers as j_unstack
from apex_tpu_torch.parallel import stack_layers, unstack_layers

S = 4          # pipeline stages
LPS = 2        # layers per stage
B, T, E = 8, 16, 32


def _block_fn(lp, h):
    mu = jnp.mean(h, -1, keepdims=True)
    var = jnp.mean((h - mu) ** 2, -1, keepdims=True)
    hn = (h - mu) * jax.lax.rsqrt(var + 1e-5)
    return h + jnp.tanh(hn @ lp["w1"] + lp["b1"]) @ lp["w2"]


def _layers(key, n):
    ks = jax.random.split(key, n)
    return [{"w1": np.asarray(jax.random.normal(k, (E, 2 * E)) * 0.1),
             "b1": np.zeros((2 * E,), np.float32),
             "w2": np.asarray(jax.random.normal(jax.random.fold_in(k, 1),
                                                (2 * E, E)) * 0.1)}
            for k in ks]


def _serial(layers, x):
    for lp in layers:
        x = _block_fn(lp, x)
    return x


def _data(kx, ky):
    return (np.asarray(jax.random.normal(jax.random.key(kx), (B, T, E))),
            np.asarray(jax.random.normal(jax.random.key(ky), (B, T, E))))


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    layers = _layers(jax.random.key(2), S * LPS)
    x, y = _data(3, 4)
    got = D.run_ranks(D.pipe_ops, S, tmp_path_factory.mktemp("pipe"),
                      timeout=120, mesh_axes={"pipe": S}, layers=layers,
                      x=x, y=y, stages=S)
    return layers, x, y, got


@pytest.fixture(scope="module")
def data_pipe(tmp_path_factory):
    layers = _layers(jax.random.key(10), 2 * LPS)
    x, y = _data(11, 12)
    got = D.run_ranks(D.pipe_ops, 4, tmp_path_factory.mktemp("dpipe"),
                      timeout=120, mesh_axes={"data": 2, "pipe": 2},
                      layers=layers, x=x, y=y, stages=2, data=2)
    return layers, x, y, got


def _jfwd(stages, m, mesh):
    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P("pipe"), P()),
             out_specs=P())
    def fwd(stacked_local, x):
        return j_gpipe(_block_fn, stacked_local, x, axis_name="pipe",
                       num_stages=stages, num_microbatches=m)
    return fwd


def _loss_serial(stacked, x, y):
    return jnp.mean((_serial(j_unstack(stacked), x) - y) ** 2)


@pytest.mark.parametrize("m", [4, 8])
def test_gpipe_matches_serial(pipe, m):
    layers, x, _, got = pipe
    out_j = _jfwd(S, m, make_mesh({"pipe": S}, devices=jax.devices()[:S]))(
        j_stack(layers), jnp.asarray(x))
    ref = np.asarray(_serial(layers, jnp.asarray(x)))
    for r in got:         # valid on every rank
        np.testing.assert_allclose(r[f"out{m}"], ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[f"out{m}"], np.asarray(out_j),
                                   rtol=1e-5, atol=1e-5)


def _check_stage_grads(got, grads_s, stages):
    """Each rank's stage grads (LPS layers) against its slice of the
    serial grads; rank i is stage i % stages."""
    for i, r in enumerate(got):
        st = i % stages
        for n in ("w1", "b1", "w2"):
            want = np.asarray(grads_s[n])[st * LPS:(st + 1) * LPS]
            np.testing.assert_allclose(r[f"g_{n}"], want, rtol=1e-4,
                                       atol=1e-5, err_msg=f"rank {i} {n}")


def test_gpipe_grads_match_serial(pipe):
    layers, x, y, got = pipe
    stacked = j_stack(layers)
    loss_s, grads_s = jax.value_and_grad(
        lambda s, x: _loss_serial(s, x, jnp.asarray(y)))(stacked,
                                                         jnp.asarray(x))
    for r in got:
        np.testing.assert_allclose(float(r["loss"]), float(loss_s),
                                   rtol=1e-5, atol=1e-6)
    _check_stage_grads(got, grads_s, S)
    gx = jax.grad(lambda x: _loss_serial(stacked, x, jnp.asarray(y)))(
        jnp.asarray(x))
    for r in got:
        np.testing.assert_allclose(r["g_x"], np.asarray(gx), rtol=1e-4,
                                   atol=1e-5)


def test_gpipe_grads_inside_shard_map(pipe):
    """JAX's grads taken inside shard_map (exact under vma) against the
    port's per-rank grads: the same stage grads, not num_stages x."""
    layers, x, y, got = pipe
    mesh = make_mesh({"pipe": S}, devices=jax.devices()[:S])

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P("pipe"), P(), P()),
             out_specs=(P(), P("pipe")))
    def loss_and_grads(stacked_local, x, y):
        def loss_fn(sp, x):
            out = j_gpipe(_block_fn, sp, x, axis_name="pipe", num_stages=S,
                          num_microbatches=4)
            return jnp.mean((out - y) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(stacked_local, x)
        return jax.lax.pmean(loss, "pipe"), g

    _, grads_p = loss_and_grads(j_stack(layers), jnp.asarray(x),
                                jnp.asarray(y))
    _check_stage_grads(got, grads_p, S)


def test_gpipe_composes_with_data_axis(data_pipe):
    """dp=2 x pp=2: the batch split over data, each stage's grads
    averaged over data, against the serial global-batch gradient and
    JAX's shard_map."""
    layers, x, y, got = data_pipe
    stacked = j_stack(layers)
    mesh = make_mesh({"data": 2, "pipe": 2}, devices=jax.devices()[:4])

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("pipe"), P("data"), P("data")),
             out_specs=(P(), P("pipe")))
    def loss_and_grads(stacked_local, xb, yb):
        def loss_fn(sp, xb):
            out = j_gpipe(_block_fn, sp, xb, axis_name="pipe",
                          num_stages=2, num_microbatches=4)
            return jnp.mean((out - yb) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(stacked_local, xb)
        g = jax.tree.map(lambda a: a / jax.lax.axis_size("data"), g)
        return jax.lax.pmean(loss, "data"), g

    loss_p, grads_p = loss_and_grads(stacked, jnp.asarray(x),
                                     jnp.asarray(y))
    loss_s, grads_s = jax.value_and_grad(
        lambda s: _loss_serial(s, jnp.asarray(x), jnp.asarray(y)))(stacked)
    np.testing.assert_allclose(float(loss_p), float(loss_s), rtol=1e-5,
                               atol=1e-6)
    # each data half's loss; their mean is the global one
    mean_loss = np.mean([float(got[i]["loss"]) for i in (0, 2)])
    np.testing.assert_allclose(mean_loss, float(loss_s), rtol=1e-5,
                               atol=1e-6)
    for want in (grads_s, grads_p):
        _check_stage_grads(got, want, 2)


def test_gpipe_rejects_bad_microbatching_and_stages(pipe):
    layers, _, _, got = pipe
    mesh = make_mesh({"pipe": S}, devices=jax.devices()[:S])

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("pipe"), P()),
             out_specs=P())
    def run(sl, x):
        return j_gpipe(_block_fn, sl, x, axis_name="pipe", num_stages=S,
                       num_microbatches=3)

    with pytest.raises(ValueError, match="divisible") as e:
        run(j_stack(layers), jnp.zeros((B, T, E)))
    for r in got:
        assert str(r[f"bad_{S}"]) == str(e.value)
        assert "num_stages=5 != size of mesh axis 'pipe' (4)" in \
            str(r[f"bad_{S + 1}"])


def test_stack_and_unstack_layers():
    layers = _layers(jax.random.key(0), 3)
    tl = [{k: torch.from_numpy(v) for k, v in lay.items()} for lay in layers]
    st = stack_layers(tl)
    js = j_stack(layers)
    for k in js:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(js[k]))
    back = unstack_layers(st)
    assert len(back) == 3
    for a, b in zip(back, layers):
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), b[k])
    # a JAX stacked tree converts leaf for leaf
    from apex_tpu_torch.convert import params_from_jax
    conv = params_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for k in js:
        assert torch.equal(conv[k], st[k])
    # nested trees, as a transformer layer's
    nested = stack_layers([{"ln": {"g": torch.ones(2) * i}} for i in
                           range(2)])
    assert nested["ln"]["g"].shape == (2, 2)
    assert float(unstack_layers(nested)[1]["ln"]["g"][0]) == 1.0
