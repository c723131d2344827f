"""Data parallelism on an NVIDIA card (marker ``cuda``).

An NCCL process group of world size 1 runs bench.py's ``ddp`` step
(``DDPTrainer``, BNs synced over ``"data"``) bit-equal to ``Trainer``'s
plain step, and ZeRO-Adam at one shard bit-equal to FusedAdam on the
Adam kernel; two gloo ranks on the one card (NCCL refuses two ranks on one
device) run ``SyncBatchNorm`` against BatchNorm over the global batch, and
the collectives by the gloo-on-CUDA rules (all-reduce + slice, a broadcast
a rank). Without a card every test here skips. On a machine with one::

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py -q
"""

import numpy as np
import pytest
import torch

import _torch_dist as D

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.cuda.init()


CI = dict(block_sizes=(1, 1), bottleneck=True, num_classes=10, width=8)


def test_nccl_world_one_ddp_step_is_bit_equal_to_the_plain_step(card,
                                                                 tmp_path):
    import torch.distributed as dist

    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.ops.flat import tree_leaves
    from apex_tpu_torch.parallel import (collectives, convert_syncbn_model,
                                         launch, make_mesh)
    from apex_tpu_torch.train import DDPTrainer, Trainer
    launch.initialize(device="cuda", init_method=f"file://{tmp_path / 's'}",
                      rank=0, world_size=1)
    try:
        make_mesh(device="cuda")
        model = ResNet(**CI)
        params, state = model.init(0)
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.randn(8, 32, 32, 3).astype(
            np.float32)).cuda().permute(0, 3, 1, 2)
        y = torch.from_numpy(rs.randint(0, 10, 8).astype(np.int32)).cuda()
        plain = Trainer(model, params, state)
        ddp = DDPTrainer(convert_syncbn_model(model), params, state)
        for _ in range(3):
            assert torch.equal(plain.step(x, y), ddp.step(x, y))
        assert torch.equal(plain.opt.state[0].master, ddp.opt.state[0].master)
        for a, b in zip(*(tree_leaves(t.bn_state)
                          for t in (plain, ddp))):
            assert torch.equal(a, b)
        assert collectives.collective_bytes()["ops"]["psum[data]"][
            "calls"] == 2 * 9 + 2
    finally:
        collectives.unbind_axes()
        dist.destroy_process_group()


def test_nccl_world_one_zero_adam_is_fused_adam_on_the_adam_kernel(
        card, tmp_path):
    """ZeRO-Adam's shard update is the Adam kernel: at one shard its
    masters equal FusedAdam's bit for bit."""
    import torch.distributed as dist

    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.ops import multi_tensor as MT
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import collectives, launch, make_mesh
    launch.initialize(device="cuda", init_method=f"file://{tmp_path / 's'}",
                      rank=0, world_size=1)
    try:
        make_mesh(device="cuda")
        g = torch.Generator().manual_seed(0)
        params = {"w": torch.randn(300, 70, generator=g),
                  "b": torch.randn(70, generator=g)}
        zero = DistributedFusedAdam(params, lr=1e-2, weight_decay=0.01,
                                    num_shards=1)
        ref = FusedAdam(params, lr=1e-2, weight_decay=0.01)
        state = zero.local_state(zero.init_state())
        MT.adam.launches = 0
        for _ in range(3):
            grads = {k: torch.randn(v.shape, generator=g).cuda()
                     for k, v in params.items()}
            state, _ = zero.shard_step(state, grads)
            ref.step(grads)
        assert MT.adam.launches == 6
        assert torch.equal(state.master, ref.state[0].master)
        assert torch.equal(state.slots["v"], ref.state[0].slots["exp_avg_sq"])
    finally:
        collectives.unbind_axes()
        dist.destroy_process_group()


def test_two_gloo_ranks_on_the_card_match_the_global_batch(card, tmp_path):
    from apex_tpu_torch.parallel import SyncBatchNorm
    rs = np.random.RandomState(0)
    x = rs.randn(8, 6, 10, 10).astype(np.float32)
    dy = rs.randn(*x.shape).astype(np.float32)
    got = D.run_ranks(D.cuda_gloo_ops, 2, tmp_path, device="cuda",
                      backend="gloo", x=x, dy=dy)
    bn = SyncBatchNorm(6, axis_name=None, channel_last=False,
                       fuse_relu=True)
    p, st = bn.init("cuda")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).cuda().requires_grad_(True)
    y, new = bn.apply(p, st, xt, training=True)
    gx, gw, gb = torch.autograd.grad(y, (xt, p["weight"], p["bias"]),
                                     torch.from_numpy(dy).cuda())
    cat = lambda k: np.concatenate([r[k] for r in got])
    np.testing.assert_allclose(cat("y"), y.detach().cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cat("gx"), gx.cpu().numpy(), atol=1e-5,
                               rtol=1e-5)
    for r in got:
        np.testing.assert_allclose(r["gw"], gw.cpu().numpy(), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(r["gb"], gb.cpu().numpy(), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(r["running_var"],
                                   new["running_var"].cpu().numpy(),
                                   atol=1e-5)


def test_a_gloo_group_on_cuda_tensors_runs_the_stated_rules(card, tmp_path):
    rs = np.random.RandomState(1)
    got = D.run_ranks(D.cuda_gloo_ops, 2, tmp_path, device="cuda",
                      backend="gloo",
                      x=rs.randn(4, 3, 4, 4).astype(np.float32),
                      dy=rs.randn(4, 3, 4, 4).astype(np.float32))
    total = np.arange(16, dtype=np.float32) * 3
    for r, row in enumerate(got):
        assert dict(row["rules"].tolist()) == {
            "all_gather": "broadcast_each", "all_to_all": "host_all_to_all",
            "ppermute": "host_send_recv",
            "reduce_scatter": "all_reduce+slice"}
        np.testing.assert_array_equal(row["rs"], total[r * 8:(r + 1) * 8])
        np.testing.assert_array_equal(
            row["ag"], np.concatenate([np.arange(8) * (k + 1)
                                       for k in range(2)]))
        assert row["tally"].tolist() == ["broadcast[data]", "psum[data]"]
