"""Port parity: ``apex_tpu_torch.parallel.plan`` (``Plan``,
``compile_step_with_plan``, ``place_with_specs``) and the distributed
sidecar records, against ``apex_tpu.parallel.plan`` on 2 of the
conftest's 8 CPU devices; the port on 2 gloo ranks.

The per-rank lowering (``"shard_map"``) runs a body with an explicit
all-reduce on each rank's shard, as JAX's ``shard_map`` does; the
global-view lowering (``"pjit"``) runs DTensors, whose matmul and sum
insert the collectives, as GSPMD does; a bare Plan (``"jit"``) runs the
body. Values within 1e-5 of JAX's; the errors' messages and hints equal
JAX's; the ``mesh_created``, ``plan_compiled`` and ``collectives``
records carry the JAX logger's keys and values.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu.parallel import collectives as JC
from apex_tpu.parallel import make_mesh as j_make_mesh
from apex_tpu.parallel import plan as JPL
from apex_tpu.prof import metrics as JM
from apex_tpu_torch.parallel import plan as PL
from apex_tpu_torch.prof import metrics as M

WORLD = 2


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rs = np.random.RandomState(0)
    inp = dict(x=rs.randn(8, 4).astype(np.float32),
               w=rs.randn(4, 3).astype(np.float32),
               params={"a": rs.randn(40).astype(np.float32),
                       "b": rs.randn(3, 5).astype(np.float32)})
    return inp, D.run_ranks(D.plan_ops, WORLD,
                            tmp_path_factory.mktemp("plan"), **inp)


def _jmesh():
    return j_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])


def test_per_rank_lowering_matches_shard_map(case):
    inp, got = case
    x, w = jnp.asarray(inp["x"]), jnp.asarray(inp["w"])
    f = JPL.compile_step_with_plan(
        lambda w, x: jax.lax.psum(x @ w, "data"),
        JPL.Plan(mesh=_jmesh(), in_specs=(P(), P("data")), out_specs=P()))
    want = np.asarray(f(w, x))
    for r, row in enumerate(got):
        # the sum of the ranks' [4, 3] products, on every rank
        np.testing.assert_allclose(row["shard_map"], want, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_array_equal(row["shard_map_local"],
                                      D.shard(inp["x"], r, WORLD) * 2)
        np.testing.assert_array_equal(row["shard_map_full"], inp["x"] * 2)


def test_global_view_lowering_matches_pjit(case):
    inp, got = case
    x, w = jnp.asarray(inp["x"]), jnp.asarray(inp["w"])
    mesh = _jmesh()
    f = JPL.compile_step_with_plan(
        lambda x, w: (x @ w, (x @ w).sum(0)),
        JPL.Plan(mesh=mesh, in_shardings=(P("data"), P()),
                 out_shardings=(P("data"), P())))
    assert JPL.Plan(mesh=mesh, in_shardings=P(), out_shardings=P()) \
        .lowering() == PL.Plan(mesh=object(), in_shardings=(),
                               out_shardings=()).lowering() == "pjit"
    prod, total = (np.asarray(a) for a in f(x, w))
    for r, row in enumerate(got):
        np.testing.assert_allclose(row["pjit_local"], D.shard(prod, r, WORLD),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(row["pjit_total"], total, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_array_equal(row["jit"], inp["x"] * 2)


def test_place_with_specs_shards_the_zero_state(case):
    inp, got = case
    from apex_tpu.contrib.optimizers import DistributedFusedAdam as JZA
    jopt = JZA(inp["params"], lr=1e-2, num_shards=WORLD)
    placed = JPL.place_with_specs(jopt.init_state(), _jmesh(),
                                  jopt.state_pspec())
    shards = [np.asarray(s.data) for s in
              placed.master.addressable_shards]
    for r, row in enumerate(got):
        np.testing.assert_array_equal(row["placed_master"], shards[r])
        assert row["placed_m"].shape == shards[r].shape
        assert bool(row["placed_equal"])
        assert int(row["placed_step"]) == 0


def test_a_zero_step_on_placed_state_through_the_plan(case):
    """The JAX usage: the state placed by ``state_pspec()``, one
    ``shard_step`` per rank, the new state back as sharded DTensors."""
    inp, got = case
    from apex_tpu.contrib.optimizers import DistributedFusedAdam as JZA
    jopt = JZA(inp["params"], lr=1e-2, num_shards=WORLD)
    f = JPL.compile_step_with_plan(
        lambda st, g: jopt.shard_step(st, g),
        JPL.Plan(mesh=_jmesh(), in_specs=(jopt.state_pspec(), P()),
                 out_specs=(jopt.state_pspec(), P()), check_vma=False))
    grads = {k: jnp.asarray(v) * 0.1 for k, v in inp["params"].items()}
    state, params = f(jopt.init_state(), grads)
    for row in got:
        np.testing.assert_allclose(row["plan_zero_master"],
                                   np.asarray(state.master), rtol=1e-6,
                                   atol=1e-7)
        assert int(row["plan_zero_step"]) == 1
        np.testing.assert_allclose(row["plan_zero_b"],
                                   np.asarray(params["b"], np.float32),
                                   rtol=1e-2, atol=1e-3)


def test_ddp_compile_step_goes_through_the_plan(case):
    inp, got = case
    x, w = inp["x"], inp["w"]
    want = jax.grad(lambda w: jnp.mean((x @ w) ** 2))(jnp.asarray(w))
    for row in got:
        np.testing.assert_allclose(row["ddp_step"], want, atol=1e-5,
                                   rtol=1e-5)


def _jax_records(tmp_path):
    JM._PENDING_NOTES.clear()      # notes of this module's earlier plans
    JC.reset_collective_bytes()
    JC.reset_collective_latency()
    log = JM.MetricsLogger(str(tmp_path / "jax.jsonl"), run="plan",
                           track_compiles=False, process_index=0,
                           process_count=1)
    mesh = _jmesh()
    f = JPL.compile_step_with_plan(
        lambda w, x: JC.grouped_psum(x @ w, "data", None),
        JPL.Plan(mesh=mesh, in_specs=(P(), P("data")), out_specs=P(),
                 donate_argnums=(0,)))
    f.__name__ = "per_rank"
    JC.reset_collective_bytes()
    g = JPL.compile_step_with_plan(
        lambda v: JC.grouped_psum(v, "data", None),
        JPL.Plan(mesh=mesh, in_specs=P(), out_specs=P()))
    g(jnp.ones(4))
    log.close()
    JC.reset_collective_bytes()
    return JM.read_sidecar(log.path)


def test_sidecar_records_carry_the_jax_keys(case, tmp_path):
    _, got = case
    jrecs = _jax_records(tmp_path)
    trecs = M.read_sidecar(str(got[0]["sidecar"]))
    for r in trecs:
        JM.validate_record(r)

    def events(recs, name):
        return [r for r in recs if r.get("name") == name]

    jm, tm = events(jrecs, "mesh_created"), events(trecs, "mesh_created")
    assert tm and set(tm[-1]) == set(jm[-1])
    assert {k: tm[-1][k] for k in ("axes", "devices", "platform")} == \
        {k: jm[-1][k] for k in ("axes", "devices", "platform")}
    jp, tp = events(jrecs, "plan_compiled"), events(trecs, "plan_compiled")
    assert set(tp[0]) == set(jp[0])
    assert [(r["lowering"], r["axes"]) for r in tp] == [
        ("shard_map", {"data": 2}), ("shard_map", {"data": 2}),
        ("pjit", {"data": 2}), ("jit", {}), ("shard_map", {"data": 2}),
        ("shard_map", {"data": 2})]
    assert (tp[0]["body"], tp[0]["donate_argnums"]) == ("per_rank", [0])
    assert jp[0]["donate_argnums"] == [0]
    jc = [r for r in jrecs if r["kind"] == "collectives"]
    tc = [r for r in trecs if r["kind"] == "collectives"]
    assert len(tc) == len(jc) == 1
    assert set(tc[0]) == set(jc[0])
    assert tc[0]["ops"] == jc[0]["ops"] == {
        "psum[data]": {"calls": 1, "bytes": 16}}
    assert (tc[0]["total_bytes"], tc[0]["total_calls"]) == (16, 1)


def test_plan_errors_and_hints_match_jax():
    mesh = types.SimpleNamespace(mesh_dim_names=("data",), shape=(2,))
    jmesh = _jmesh()
    cases = [
        (dict(in_specs=(None,), out_specs=None), dict(in_specs=(P(),))),
        (dict(mesh=mesh, in_specs=(None,)),
         dict(mesh=jmesh, in_specs=(P(),))),
        (dict(mesh=mesh, in_shardings=(None,)),
         dict(mesh=jmesh, in_shardings=(P(),))),
    ]
    for tkw, jkw in cases:
        with pytest.raises(JPL.PlanCompilationError) as want:
            JPL.compile_step_with_plan(lambda x: x, JPL.Plan(**jkw))
        with pytest.raises(PL.PlanCompilationError) as got:
            PL.compile_step_with_plan(lambda x: x, PL.Plan(**tkw))
        assert str(got.value).split("\n")[0] == \
            str(want.value).split("\n")[0]
        assert got.value.hint
    with pytest.raises(PL.PlanCompilationError, match="no mesh"):
        PL.compile_step_with_plan(lambda x: x, PL.Plan(
            in_shardings=(None,), out_shardings=(None,)))
    assert PL.Plan().lowering() == JPL.Plan().lowering() == "jit"
    assert PL.Plan(mesh=mesh).axes() == {"data": 2}
    assert isinstance(PL.PlanCompilationError("m", "h"), ValueError)
