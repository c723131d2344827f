"""Port parity: ``apex_tpu_torch.parallel`` — collectives, mesh, launch,
DDP, Reducer — against ``apex_tpu.parallel``.

The port's ranks are 4 gloo child processes (``_torch_dist.run_ranks``);
the JAX side runs ``shard_map`` over 4 of the conftest's 8 CPU devices
on the same numpy inputs. Tolerances are the JAX tests'
(``tests/test_parallel.py``): the averaged grad 1e-6; exact where the
values are small integers.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_dist as D
from apex_tpu import parallel as JP
from apex_tpu_torch import parallel as TP
from apex_tpu_torch.models import ResNet
from apex_tpu_torch.parallel import collectives as C
from apex_tpu_torch.parallel import launch, mesh as M

WORLD = 4


def _jmesh():
    return JP.make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])


def _smap(f, in_specs, out_specs):
    return jax.jit(jax.shard_map(f, mesh=_jmesh(), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rs = np.random.RandomState(0)
    inputs = dict(w=rs.randn(4).astype(np.float32),
                  x=np.random.RandomState(1).randn(16, 4).astype(np.float32),
                  y=np.random.RandomState(2).randn(16).astype(np.float32),
                  vals=np.arange(8.0, dtype=np.float32).reshape(8, 1))
    return inputs, D.run_ranks(D.parallel_ops, WORLD,
                               tmp_path_factory.mktemp("par"), **inputs)


def test_ddp_grad_average_matches_jax_and_the_global_batch(ranks):
    inputs, got = ranks
    w, x, y = (jnp.asarray(inputs[k]) for k in "wxy")
    ddp = JP.DistributedDataParallel(axis_name="data")

    def loss_fn(w, x, y):
        return jnp.mean((x @ w - y) ** 2)

    want = _smap(lambda w, x, y: ddp.grad(loss_fn)(w, x, y),
                 (P(), P("data"), P("data")), P())(w, x, y)
    for r in got:
        np.testing.assert_allclose(r["ddp_grad"], want, atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(r["ddp_grad"],
                                   jax.grad(loss_fn)(w, x, y), atol=1e-6,
                                   rtol=1e-6)


def test_predivide_fp32_allreduce_and_sum_only_match_jax(ranks):
    _, got = ranks
    pre = JP.DistributedDataParallel(axis_name="data",
                                     gradient_predivide_factor=4.0,
                                     allreduce_always_fp32=True)
    jpre = _smap(pre.average_gradients, P("data"), P("data"))(
        jnp.full((WORLD, 16), 3.0, jnp.bfloat16))
    summed = JP.DistributedDataParallel(axis_name="data",
                                        gradient_average=False)
    jsum = _smap(summed.average_gradients, P("data"), P("data"))(
        jnp.ones((WORLD, 4), jnp.float32))
    for r, row in enumerate(got):
        assert bool(row["pre_dtype_bf16"]) and jpre.dtype == jnp.bfloat16
        np.testing.assert_array_equal(row["pre"][0],
                                      np.asarray(jpre[r], np.float32))
        np.testing.assert_array_equal(row["sum"][0], np.asarray(jsum[r]))


def test_reducer_subgroups_match_jax(ranks):
    inputs, got = ranks
    groups = JP.create_syncbn_process_group(2, WORLD)
    red = JP.Reducer(axis_name="data",
                     axis_index_groups=tuple(tuple(g) for g in groups))
    want = np.asarray(_smap(red, P("data"), P("data"))(
        jnp.asarray(inputs["vals"])))
    for r, row in enumerate(got):
        assert row["groups"].tolist() == groups
        np.testing.assert_array_equal(row["reducer"], D.shard(want, r, WORLD))
        np.testing.assert_array_equal(row["reducer_tree"], row["reducer"])
    ddp = JP.DistributedDataParallel(
        axis_name="data", axis_index_groups=tuple(tuple(g) for g in groups),
        gradient_predivide_factor=2.0)
    want = np.asarray(_smap(ddp.average_gradients, P("data"), P("data"))(
        jnp.asarray(inputs["vals"])))
    for r, row in enumerate(got):
        np.testing.assert_array_equal(row["ddp_groups"],
                                      D.shard(want, r, WORLD))


def test_the_gloo_cuda_rules_compute_the_native_ops(ranks):
    """psum_scatter by all-reduce + slice and all_gather by one broadcast a
    rank give the native ops' values; the tally names what ran."""
    _, got = ranks
    n = 8 * WORLD
    total = np.arange(n, dtype=np.float32) * sum(range(1, WORLD + 1))
    for r, row in enumerate(got):
        np.testing.assert_array_equal(row["rs_data"],
                                      total[r * 8:(r + 1) * 8])
        np.testing.assert_array_equal(row["rs_data_rules"], row["rs_data"])
        np.testing.assert_array_equal(row["ag_data"], total)
        np.testing.assert_array_equal(row["ag_data_rules"], total)
        assert row["tally_data"].tolist() == [
            ["all_gather[data]", "1", "16"],
            ["psum_scatter[data]", "1", str(4 * n)]]
        assert row["tally_data_rules"].tolist() == [
            ["broadcast[data_rules]", str(WORLD), str(16 * WORLD)],
            ["psum[data_rules]", "1", str(4 * n)]]


def test_broadcast_flat_dist_call_index_and_size(ranks):
    _, got = ranks
    for r, row in enumerate(got):
        np.testing.assert_array_equal(row["bcast_w"], np.zeros(3))
        assert int(row["bcast_b"]) == 0
        np.testing.assert_array_equal(row["flat_dist"], [WORLD, WORLD])
        assert int(row["index"]) == r and int(row["size"]) == WORLD


def test_ddp_trainer_folds_the_rank_into_each_dropout_seed(ranks):
    """main_amp folds the rank into its step key (:264-267): each rank's
    per-layer seeds are the drawn seeds folded with its position."""
    import torch

    from apex_tpu_torch._stream import fold_key
    _, got = ranks
    drawn = torch.randint(-(1 << 31), 1 << 31, (2,),
                          generator=torch.Generator().manual_seed(5))
    for r, row in enumerate(got):
        want = [int(k) - (1 << 32) if int(k) >= 1 << 31 else int(k)
                for k in fold_key(drawn & 0xFFFFFFFF, r)]
        assert row["vit_seeds"].tolist() == want
    assert len({tuple(row["vit_seeds"]) for row in got}) == WORLD


def test_latency_tally_matches_jax():
    from apex_tpu.parallel import collectives as JC
    JC.reset_collective_latency()
    C.reset_collective_latency()
    for ms, nbytes in ((0.05, 4), (3.0, 64), (250.0, 0), (5000.0, 8)):
        JC.record_collective_latency("gather", ms, nbytes)
        C.record_collective_latency("gather", ms, nbytes)
    assert C.collective_latency() == JC.collective_latency()
    assert C.LATENCY_BINS_MS == JC.LATENCY_BINS_MS
    with C.time_collective("probe", 16):
        pass
    assert C.collective_latency()["ops"]["probe"]["calls"] == 1
    JC.reset_collective_latency()
    C.reset_collective_latency()
    assert C.collective_latency() == {}
    C.record_collective("psum", 8, "data")
    with C.step_scope():          # a step clears what came before it
        C.record_collective("psum", 4, "data")
        with C.step_scope():
            C.record_collective("all_gather", 2, "data")
    assert C.collective_bytes() == {
        "ops": {"psum[data]": {"calls": 1, "bytes": 4},
                "all_gather[data]": {"calls": 1, "bytes": 2}},
        "total_bytes": 6, "total_calls": 2}
    C.reset_collective_bytes()
    assert C.collective_bytes() == {}


@pytest.mark.parametrize("sizes,n", [
    ({"data": -1, "model": -1}, 8), ({"data": -1, "model": 3}, 8),
    ({"data": 4, "model": 4}, 8)])
def test_mesh_errors_match_jax(sizes, n):
    with pytest.raises(ValueError) as want:
        JP.make_mesh(sizes, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        TP.make_mesh(sizes, devices=list(range(n)), device="cpu")
    assert str(got.value) == str(want.value)


def test_mesh_sizes_subgroups_and_placements():
    assert M.resolve_axis_sizes({"data": -1, "model": 2}, 8) == \
        {"data": 4, "model": 2}
    assert M.resolve_axis_sizes(None, 8) == {"data": 8}
    assert TP.subgroups(8, 4) == JP.subgroups(8, 4)
    for bad in ((8, 3), (8, 0)):
        with pytest.raises(ValueError) as want:
            JP.subgroups(*bad)
        with pytest.raises(ValueError) as got:
            TP.subgroups(*bad)
        assert str(got.value) == str(want.value)
    assert TP.create_syncbn_process_group(2, 8) == \
        JP.create_syncbn_process_group(2, 8)
    assert TP.create_syncbn_process_group(0, 8) is None
    assert (TP.DATA_AXIS, TP.MODEL_AXIS, TP.SEQ_AXIS, TP.PIPE_AXIS) == \
        (JP.DATA_AXIS, JP.MODEL_AXIS, JP.SEQ_AXIS, JP.PIPE_AXIS)
    assert TP.local_device_count() == 0          # no card here
    with pytest.raises(RuntimeError, match="launch.initialize"):
        TP.make_mesh({"data": 2}, device="cpu")
    with pytest.raises(RuntimeError, match="not bound"):
        C.axis("nowhere")
    assert C.collective_rules("nccl", "cuda")["reduce_scatter"] == \
        "reduce_scatter"
    assert C.collective_rules("gloo", "cuda") == {
        "reduce_scatter": "all_reduce+slice", "all_gather": "broadcast_each",
        "ppermute": "host_send_recv", "all_to_all": "host_all_to_all"}


def test_convert_syncbn_and_reference_signatures():
    g = TP.create_syncbn_process_group(2, 8)
    m = ResNet(block_sizes=(1,), bottleneck=False, width=8, num_classes=4,
               device="cpu")
    m2 = TP.convert_syncbn_model(m, g, False)     # the reference's order
    assert m2.bn_axis_index_groups == g and m2.bn_axis_name == "data"
    assert m2._bn(8).axis_index_groups == ((0, 1), (2, 3), (4, 5), (6, 7))
    assert TP.convert_syncbn_model(m).bn_axis_index_groups is None
    with pytest.raises(TypeError, match="keyword-only"):
        TP.convert_syncbn_model(object(), "data")
    with pytest.raises(TypeError, match="replace"):
        TP.convert_syncbn_model(object())
    d = TP.DistributedDataParallel(
        axis_name="data", message_size=1 << 20, delay_allreduce=True,
        shared_param=None, allreduce_trigger_params=None,
        retain_allreduce_buffers=True, allreduce_always_fp32=True,
        num_allreduce_streams=2, allreduce_communicators=None,
        gradient_average=True, gradient_predivide_factor=2.0,
        gradient_average_split_factor=None, prof=False)
    assert d.gradient_predivide_factor == 2.0
    for name in ("DistributedDataParallel", "Reducer", "SyncBatchNorm",
                 "Plan", "compile_step_with_plan", "place_with_specs",
                 "make_mesh", "batch_sharded", "replicated",
                 "broadcast_params", "flat_dist_call", "LARC",
                 "convert_syncbn_model", "create_syncbn_process_group"):
        assert hasattr(JP, name) and hasattr(TP, name), name


WORKER = r'''
import sys
import torch
import torch.distributed as dist
from apex_tpu_torch.parallel import launch
import os
rank = int(os.environ["RANK"])
assert os.environ["LOCAL_RANK"] == str(rank)
launch.initialize(device="cpu", init_method="file://" + sys.argv[1])
t = torch.ones(1) * (rank + 1)
dist.all_reduce(t)
print("rank", rank, "sum", float(t))
open(sys.argv[2] + f".{rank}", "w").write(repr(float(t)))
dist.destroy_process_group()
'''


def test_multiproc_two_process_allreduce(tmp_path, monkeypatch):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    extra = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", repo + (os.pathsep + extra if extra
                                             else ""))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    rc = launch.multiproc(str(script), 2, str(tmp_path / "store"),
                          str(tmp_path / "out"), log_dir=str(tmp_path),
                          timeout=60)
    log = (tmp_path / "rank1.log").read_text()
    assert rc == 0, log
    assert "rank 1 sum 3.0" in log
    for r in range(2):
        assert float((tmp_path / f"out.{r}").read_text()) == 3.0


def test_multiproc_returns_the_first_failure(tmp_path):
    """The first nonzero exit status, through the function and the CLI;
    ranks still running at the timeout are killed."""
    fail = tmp_path / "fail.py"
    fail.write_text("import os, sys\n"
                    "sys.exit(3 if os.environ['RANK'] == '1' else 0)\n")
    assert launch.multiproc(str(fail), 2, log_dir=str(tmp_path)) == 3
    assert launch._main(["2", str(fail), "--log-dir", str(tmp_path)]) == 3
    slow = tmp_path / "slow.py"
    slow.write_text("import time\ntime.sleep(30)\n")
    assert launch.multiproc(str(slow), 2, log_dir=str(tmp_path),
                            timeout=1) != 0


def test_multiproc_timeout_counts_from_the_start(tmp_path):
    """The timeout is one deadline for all ranks: a rank that ends just
    before it gives the next rank no fresh timeout."""
    script = tmp_path / "staggered.py"
    script.write_text("import os, time\n"
                      "time.sleep(4 if os.environ['RANK'] == '0' else 60)\n")
    t0 = time.monotonic()
    rc = launch.multiproc(str(script), 2, log_dir=str(tmp_path), timeout=5)
    assert rc != 0 and time.monotonic() - t0 < 8
