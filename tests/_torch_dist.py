"""Ranks of the port's distributed tests: gloo child processes.

``run_ranks(target, world, tmp_path, **kw)`` spawns ``world`` processes
(``torch.multiprocessing``, spawn) that join a gloo process group over a
``file://`` store under ``tmp_path`` (no TCP port to collide with another
test), bind a 1-D ``"data"`` mesh (``parallel.make_mesh(device="cpu")``),
or the named axes of ``mesh_axes`` (``{"seq": 4}``, ``{"data": 2, "pipe":
2}``), and call ``target(rank, world, out, **kw)``, which returns a dict of numpy
arrays; each rank's dict comes back from ``rank{r}.npz``. The join has its
own deadline: a rank that hangs fails the test that started it.

This module imports torch and the port only: the children import it by
name, and JAX must not load there.
"""

from __future__ import annotations

import os
import time
import traceback
from pathlib import Path

import numpy as np

TIMEOUT_S = 60


def _child(target, rank, world, store, out, kw, device, backend,
           mesh_axes=None):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        from apex_tpu_torch.parallel import launch, make_mesh
        launch.initialize(backend, device=device,
                          init_method=f"file://{store}", rank=rank,
                          world_size=world, timeout=TIMEOUT_S)
        make_mesh(mesh_axes, device=device)
        res = target(rank, world, out, **kw) or {}
        np.savez(os.path.join(out, f"rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in res.items()})
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        Path(out, f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def run_ranks(target, world: int, tmp_path, timeout: float = TIMEOUT_S,
              device: str = "cpu", backend: str = "gloo", mesh_axes=None,
              **kw) -> list:
    """Each rank's result dict, in rank order; fails the caller's test on a
    rank's error or when the ranks outlive ``timeout`` seconds. ``device``
    and ``backend`` go to ``launch.initialize`` (gloo over CUDA tensors:
    ``device="cuda"``), ``mesh_axes`` to ``make_mesh`` (None: a 1-D
    ``"data"`` mesh)."""
    import pytest
    import torch.multiprocessing as mp
    out = Path(tmp_path) / f"ranks_{target.__name__}_{world}"
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(target, r, world, str(store),
                                              str(out), kw, device, backend,
                                              mesh_axes))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = "".join(f"--- rank {r}\n{(out / f'err{r}.txt').read_text()}"
                   for r in range(world) if (out / f"err{r}.txt").exists())
    if hung:
        pytest.fail(f"ranks {hung} of {target.__name__} still running after "
                    f"{timeout} s\n{errs}")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        pytest.fail(f"ranks {bad} of {target.__name__} failed\n{errs}")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def shard(a, rank: int, world: int):
    """Rank ``rank``'s rows of ``a`` (dim 0 in ``world`` equal parts)."""
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


# -- the slice as a whole: bench.py's ddp and zero steps ---------------------

def bench_steps(rank, world, out, *, mode, params, state, x, y, steps=3,
                opt_level="O2"):
    """``steps`` of bench.py's ``mode`` arm ("ddp" or "zero"), or of
    main_amp's ``--data-parallel --sync_bn`` step ("sgd": FusedSGD on a
    uint8 batch), on this rank's share of the global batch ``x`` (NHWC),
    ``y``, from the JAX init ``params``/``state`` (numpy trees): the
    losses, the full masters per leaf, the BN state and the step's
    collectives tally; with "sgd" also the rank's ViT-style dropout
    seeds drawn by ``DDPTrainer``'s rule from the seeds 1, 2, 3."""
    import torch

    from apex_tpu_torch.convert import resnet_from_jax
    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.ops import flat as F
    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.parallel import convert_syncbn_model
    from apex_tpu_torch.train import DDPTrainer, ZeROTrainer
    model = convert_syncbn_model(
        ResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10,
               width=32, device="cpu"), axis_name="data")
    tp, ts = resnet_from_jax(params, state, device="cpu")
    if mode == "zero":
        tr = ZeROTrainer(model, tp, ts, opt_level=opt_level, device="cpu")
    else:
        tr = DDPTrainer(model, tp, ts, opt_level=opt_level, device="cpu",
                        **({"optimizer": "sgd"} if mode == "sgd" else {}))
    xs = torch.from_numpy(shard(x, rank, world))
    if xs.dtype != torch.uint8:          # float NHWC data as NCHW
        xs = xs.permute(0, 3, 1, 2)
    ys = torch.from_numpy(shard(y, rank, world))
    losses = [float(tr.step(xs, ys)) for _ in range(steps)]
    tally = C.collective_bytes()
    res = {"losses": np.array(losses), "tally_calls": tally["total_calls"],
           "tally_bytes": tally["total_bytes"]}
    master = tr.masters()
    for i, leaf in enumerate(F.tree_leaves(F.unflatten(master, tr.table))):
        res[f"master{i}"] = leaf.detach().numpy()
    for i, leaf in enumerate(F.tree_leaves(tr.bn_state)):
        res[f"bn{i}"] = leaf.detach().numpy()
    if mode == "zero":
        res["state_bytes"] = sum(t.numel() * t.element_size() for t in
                                 [tr.state.master, *tr.state.slots.values()])
    return res


def step1_grad(rank, world, out, *, params, state, x, y, sync=True):
    """Step 1 of ``DDPTrainer`` at O0 on this rank's share, before any
    update: the flat grad averaged over the ranks and the loss averaged
    likewise. The CI ResNet of ``bench_steps`` from the JAX init, its BNs
    synced over ``"data"``, or left local (``sync=False``, a control)."""
    import torch

    from apex_tpu_torch.convert import resnet_from_jax
    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.parallel import convert_syncbn_model
    from apex_tpu_torch.train import DDPTrainer
    model = ResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10,
                   width=32, device="cpu")
    if sync:
        model = convert_syncbn_model(model, axis_name="data")
    tp, ts = resnet_from_jax(params, state, device="cpu")
    tr = DDPTrainer(model, tp, ts, opt_level="O0", device="cpu")
    xs = torch.from_numpy(shard(x, rank, world)).permute(0, 3, 1, 2)
    ys = torch.from_numpy(shard(y, rank, world))
    grad, loss, _ = tr.loss_and_grad(xs, ys)
    return {"grad": tr.ddp.average_gradients(grad).numpy(),
            "loss": C.grouped_psum(loss.reshape(1), "data").numpy() / world}


# -- collectives, DDP, Reducer ------------------------------------------------

def parallel_ops(rank, world, out, *, w, x, y, vals):
    """DDP's average of a linear model's grad, predivide with an fp32
    all-reduce, sum-only, the Reducer over sub-groups, both collective
    rule sets, broadcast_params and the tally of one step scope."""
    import torch

    from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer,
                                         broadcast_params,
                                         create_syncbn_process_group,
                                         flat_dist_call)
    from apex_tpu_torch.parallel import collectives as C
    res = {}
    ddp = DistributedDataParallel(axis_name="data")

    def loss_fn(p, xs, ys):
        return torch.mean((xs @ p["w"] - ys) ** 2)

    g = ddp.grad(loss_fn)({"w": torch.from_numpy(w)},
                          torch.from_numpy(shard(x, rank, world)),
                          torch.from_numpy(shard(y, rank, world)))
    res["ddp_grad"] = g["w"].numpy()
    pre = DistributedDataParallel(axis_name="data",
                                  gradient_predivide_factor=4.0,
                                  allreduce_always_fp32=True)
    half = pre.average_gradients(torch.full((1, 16), 3.0,
                                            dtype=torch.bfloat16))
    res["pre_dtype_bf16"] = half.dtype == torch.bfloat16
    res["pre"] = half.float().numpy()
    summed = DistributedDataParallel(axis_name="data",
                                     gradient_average=False)
    res["sum"] = summed.average_gradients(torch.ones(1, 4)).numpy()
    groups = create_syncbn_process_group(2)
    res["groups"] = np.asarray(groups)
    red = Reducer(axis_name="data", axis_index_groups=tuple(
        tuple(gr) for gr in groups))
    res["reducer"] = red(torch.from_numpy(shard(vals, rank, world))).numpy()
    res["reducer_tree"] = red({"a": torch.from_numpy(
        shard(vals, rank, world))})["a"].numpy()
    res["ddp_groups"] = DistributedDataParallel(
        axis_name="data", axis_index_groups=groups,
        gradient_predivide_factor=2.0).average_gradients(
        torch.from_numpy(shard(vals, rank, world))).numpy()
    # the same ops by the gloo-on-CUDA rules, on the same group: the
    # rules are fixed from (backend, device), so bind with them forced
    ax = C.axis("data")
    own_rules = C.collective_rules
    C.collective_rules = lambda backend, device: own_rules("gloo", "cuda")
    try:
        C.bind_axis("data_rules", ax.group, device_type="cpu")
    finally:
        C.collective_rules = own_rules
    big = torch.arange(8 * world, dtype=torch.float32) * (rank + 1)
    for name in ("data", "data_rules"):
        with C.step_scope():
            rs = C.psum_scatter(big, name)
            ag = C.all_gather(rs.to(torch.bfloat16), name)
            res[f"rs_{name}"] = rs.numpy()
            res[f"ag_{name}"] = ag.float().numpy()
            res[f"tally_{name}"] = np.asarray(sorted(
                (k, v["calls"], v["bytes"])
                for k, v in C.collective_bytes()["ops"].items()),
                dtype=object).astype(str)
    own = {"w": torch.full((3,), float(rank)), "b": torch.tensor(rank)}
    rep = broadcast_params(own)
    res["bcast_w"] = rep["w"].numpy()
    res["bcast_b"] = rep["b"].numpy()
    res["flat_dist"] = flat_dist_call({"v": torch.ones(2)},
                                      C.grouped_psum)["v"].numpy()
    res["index"] = C.axis_index("data")
    res["size"] = C.group_size("data")
    # a ViT's dropout seeds under DDPTrainer: this rank's fold of the drawn
    from apex_tpu_torch.models import vit_tiny
    from apex_tpu_torch.train import DDPTrainer
    vit = vit_tiny(dropout=0.1, device="cpu")
    tr = DDPTrainer(vit, vit.init(0), optimizer="sgd", device="cpu",
                    generator=torch.Generator().manual_seed(5))
    res["vit_seeds"] = np.array(tr.draw_dropout_seeds())
    return res


# -- SyncBatchNorm over the axis ----------------------------------------------

def _grads_of(out, inputs, cot):
    import torch
    return torch.autograd.grad(out, inputs, cot, allow_unused=True)


def syncbn_ops(rank, world, out, *, fwd_x, bwd_x, grp_x, relu_x, relu_z,
               relu_dy, nchw_x, vma_x, vma_y):
    """SyncBatchNorm over the 1-D data axis: the forward and running stats
    against the global batch, the backward, sub-groups, the fused add +
    relu, NCHW, and grouped affine grads through DDP."""
    import torch

    from apex_tpu_torch.parallel import DistributedDataParallel, SyncBatchNorm
    from apex_tpu_torch.parallel import collectives as C

    def mine(a):
        return torch.from_numpy(shard(a, rank, world))

    res = {}
    # forward, then a second batch with momentum None (cumulative)
    bn = SyncBatchNorm(6, axis_name="data")
    p, st = bn.init("cpu")
    yv, st1 = bn.apply(p, st, mine(fwd_x), training=True)
    res["fwd_y"] = yv.numpy()
    for k, v in st1.items():
        res[f"fwd_{k}"] = v.numpy()
    cum = SyncBatchNorm(6, momentum=None, axis_name="data")
    _, stc = cum.apply(p, st, mine(fwd_x), training=True)
    _, stc = cum.apply(p, stc, mine(fwd_x) * 3.0, training=True)
    for k, v in stc.items():
        res[f"cum_{k}"] = v.numpy()
    # backward of sum(sin(y)): x grads local, param grads summed over ranks
    bn = SyncBatchNorm(4, axis_name="data", track_running_stats=False)
    p, st = bn.init("cpu")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    xb = mine(bwd_x).requires_grad_(True)
    yb, _ = bn.apply(p, st, xb, training=True)
    gx, gw, gb = torch.autograd.grad(torch.sin(yb).sum(),
                                     (xb, p["weight"], p["bias"]))
    res["bwd_gx"] = gx.numpy()
    res["bwd_gw_local"] = gw.numpy()
    res["bwd_gw"] = C.grouped_psum(gw, "data").numpy()
    res["bwd_gb"] = C.grouped_psum(gb, "data").numpy()
    # groups of 2: statistics within each pair
    groups = ((0, 1), (2, 3))
    bn = SyncBatchNorm(2, axis_name="data", axis_index_groups=groups,
                       affine=False, track_running_stats=False)
    res["grp_y"] = bn.apply({}, {}, mine(grp_x), training=True)[0].numpy()
    # fused add + relu, forward and backward
    bn = SyncBatchNorm(4, axis_name="data", fuse_relu=True,
                       track_running_stats=False)
    p, _ = bn.init("cpu")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    xr, zr = mine(relu_x).requires_grad_(True), \
        mine(relu_z).requires_grad_(True)
    yr, _ = bn.apply(p, {}, xr, z=zr, training=True)
    res["relu_y"] = yr.detach().numpy()
    gx, gz, gw, gb = torch.autograd.grad(
        yr, (xr, zr, p["weight"], p["bias"]), mine(relu_dy))
    res["relu_gx"], res["relu_gz"] = gx.numpy(), gz.numpy()
    res["relu_gw"] = C.grouped_psum(gw, "data").numpy()
    res["relu_gb"] = C.grouped_psum(gb, "data").numpy()
    # NCHW
    bn = SyncBatchNorm(5, axis_name="data", channel_last=False,
                       track_running_stats=False, affine=False)
    res["nchw_y"] = bn.apply({}, {}, mine(nchw_x), training=True)[0].numpy()
    # grouped BN's affine grads, averaged by DDP (the only reduction)
    bn = SyncBatchNorm(16, axis_name="data", axis_index_groups=groups)
    p, st = bn.init("cpu")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    ov, _ = bn.apply(p, st, mine(vma_x), training=True)
    loss = torch.mean((ov - mine(vma_y)) ** 2)
    gw, gb = torch.autograd.grad(loss, (p["weight"], p["bias"]))
    avg = DistributedDataParallel(axis_name="data").average_gradients(
        {"weight": gw, "bias": gb})
    res["vma_gw"], res["vma_gb"] = avg["weight"].numpy(), avg["bias"].numpy()
    return res


# -- groupbn ------------------------------------------------------------------

def groupbn_ops(rank, world, out, *, x, z, dy):
    """``BatchNorm2d_NHWC`` with ``bn_group`` 2 (and 1) on this rank's NHWC
    rows: the output, the running stats, and the grads of x, z and the
    params (the params' summed over the ranks)."""
    import torch

    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.parallel import collectives as C
    res = {}
    for g in (2, 1):
        bn = BatchNorm2d_NHWC(8, fuse_relu=True, bn_group=g,
                              world_size=world)
        p, st = bn.init("cpu")
        p = {k: v.requires_grad_(True) for k, v in p.items()}
        xs = torch.from_numpy(shard(x, rank, world)).requires_grad_(True)
        zs = torch.from_numpy(shard(z, rank, world)).requires_grad_(True)
        y, new = bn.apply(p, st, xs, z=zs, training=True)
        gx, gz, gw, gb = torch.autograd.grad(
            y, (xs, zs, p["weight"], p["bias"]),
            torch.from_numpy(shard(dy, rank, world)))
        res[f"y{g}"] = y.detach().numpy()
        res[f"mean{g}"] = new["running_mean"].numpy()
        res[f"gx{g}"], res[f"gz{g}"] = gx.numpy(), gz.numpy()
        res[f"gw{g}"] = C.grouped_psum(gw, "data").numpy()
        res[f"gb{g}"] = C.grouped_psum(gb, "data").numpy()
    return res


# -- the Plan -------------------------------------------------------------------

def plan_ops(rank, world, out, *, x, w, params):
    """The three lowerings, ``place_with_specs``, ``DDP.compile_step``,
    and a sidecar of this rank with the ``mesh_created``,
    ``plan_compiled`` and ``collectives`` records."""
    import torch

    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.parallel import (DistributedDataParallel, Plan,
                                         batch_sharded,
                                         compile_step_with_plan, make_mesh,
                                         place_with_specs, replicated)
    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.prof import metrics as M
    res = {}
    path = os.path.join(out, f"telem{rank}.jsonl")
    log = M.MetricsLogger(path, run="plan", track_compiles=False,
                          process_index=0, process_count=1)
    mesh = make_mesh({"data": world}, device="cpu")
    bs, rep = batch_sharded(mesh), replicated(mesh)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)

    def per_rank(w, x):
        return C.grouped_psum(x @ w, "data")

    f = compile_step_with_plan(per_rank, Plan(
        mesh=mesh, in_specs=(rep, bs), out_specs=rep, donate_argnums=(0,)))
    res["shard_map"] = f(wt, xt).numpy()

    def double(x):
        return x * 2

    g = compile_step_with_plan(double, Plan(mesh=mesh, in_specs=bs,
                                            out_specs=bs))
    d = g(xt)
    res["shard_map_local"] = d.to_local().numpy()
    res["shard_map_full"] = d.full_tensor().numpy()

    def global_view(x, w):
        return x @ w, (x @ w).sum(0)

    h = compile_step_with_plan(global_view, Plan(
        mesh=mesh, in_shardings=(bs, rep), out_shardings=(bs, rep)))
    prod, total = h(xt, wt)
    res["pjit_local"] = prod.to_local().numpy()
    res["pjit_total"] = total.to_local().numpy()
    res["jit"] = compile_step_with_plan(double, Plan())(xt).numpy()

    opt = DistributedFusedAdam(params, lr=1e-2, num_shards=world,
                               device="cpu")
    full = opt.init_state()
    placed = place_with_specs(full, mesh, opt.state_pspec())
    mine = opt.local_state(full)
    res["placed_master"] = placed.master.to_local().numpy()
    res["placed_m"] = placed.slots["m"].to_local().numpy()
    res["placed_equal"] = torch.equal(placed.master.to_local(), mine.master)
    res["placed_step"] = placed.step.to_local().numpy()

    ddp = DistributedDataParallel(axis_name="data")

    def ddp_body(w, x):
        return ddp.grad(lambda p, x: torch.mean((x @ p) ** 2))(w, x)

    step = ddp.compile_step(ddp_body, mesh, in_specs=(rep, bs),
                            out_specs=rep)
    res["ddp_step"] = step(wt, xt).numpy()
    # a ZeRO step through the per-rank lowering, on the placed state
    zstep = compile_step_with_plan(
        lambda st, g: opt.shard_step(st, g),
        Plan(mesh=mesh, in_specs=(opt.state_pspec(), rep),
             out_specs=(opt.state_pspec(), rep)))
    grads = {k: torch.from_numpy(v) * 0.1 for k, v in params.items()}
    new_state, out_params = zstep(placed, grads)
    res["plan_zero_master"] = new_state.master.full_tensor().numpy()
    res["plan_zero_step"] = new_state.step.numpy()
    res["plan_zero_b"] = out_params["b"].float().numpy()
    with C.step_scope():
        C.grouped_psum(torch.ones(4), "data")
    log.close()
    res["sidecar"] = path
    return res


# -- ZeRO ---------------------------------------------------------------------

def _tree_np(tree):
    from apex_tpu_torch.ops import flat as F
    return [t.detach().float().numpy() for t in F.tree_leaves(tree)]


def _leaves_into(res, prefix, tree):
    for i, a in enumerate(_tree_np(tree)):
        res[f"{prefix}{i}"] = a


def _zero_run(opt, grads_steps, rank, found_inf=None, scale=1.0):
    import torch
    from apex_tpu_torch.parallel import collectives as C
    state = opt.local_state(opt.init_state())
    out = None
    for g in grads_steps:
        g = g[rank] if isinstance(g, list) else g
        g = {k: torch.from_numpy(v) for k, v in g.items()}
        state, out = opt.shard_step(state, g, found_inf=found_inf,
                                    scale=scale)
    full = C.all_gather(state.master, opt.axis_name)
    from apex_tpu_torch.ops import flat as F
    return state, F.unflatten(full, opt.table), out


def zero_pairs(rank, world, out, *, params, grads_steps):
    """ZeRO-Adam against the replicated FusedAdam fed DDP's average of
    the same local grads, ZeRO-LAMB against FusedLAMB, the e5m2 gather,
    an overflow, and the bytes each rank holds."""
    import torch

    from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                                   DistributedFusedLAMB)
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
    from apex_tpu_torch.parallel import DistributedDataParallel
    res = {}
    ddp = DistributedDataParallel(axis_name="data")
    for name, zcls, rcls, kw in (
            ("adam", DistributedFusedAdam, FusedAdam,
             dict(lr=1e-2, weight_decay=0.01)),
            ("lamb", DistributedFusedLAMB, FusedLAMB,
             dict(lr=1e-2, weight_decay=0.01, max_grad_norm=0.05))):
        opt = zcls(params, num_shards=world, device="cpu", **kw)
        state, masters, _ = _zero_run(opt, grads_steps, rank)
        _leaves_into(res, f"{name}_zero", masters)
        ref = rcls(params, device="cpu", **kw)
        for g in grads_steps:
            local = ref.flatten_grads({k: torch.from_numpy(v)
                                       for k, v in g[rank].items()})
            ref.step_flat([ddp.average_gradients(local[0])])
        _leaves_into(res, f"{name}_ref", ref.master_params_tree())
        res[f"{name}_step"] = int(state.step)
        res[f"{name}_bytes"] = sum(t.numel() * t.element_size() for t in
                                   [state.master, *state.slots.values()])
        res[f"{name}_total"] = opt.total
    e5 = DistributedFusedAdam(params, lr=1e-2, num_shards=world,
                              gather_dtype=torch.float8_e5m2, device="cpu")
    _, masters, gathered = _zero_run(e5, grads_steps[:1], rank)
    _leaves_into(res, "e5m2_params", gathered)
    _leaves_into(res, "e5m2_want", {k: v.to(torch.float8_e5m2).to(
        torch.bfloat16) for k, v in masters.items()})
    res["e5m2_dtype"] = str(next(iter(gathered.values())).dtype)
    skip = DistributedFusedAdam(params, lr=1e-2, num_shards=world,
                                device="cpu")
    state, _, _ = _zero_run(skip, grads_steps[:1], rank,
                            found_inf=torch.tensor(True))
    res["skip_step"] = int(state.step)
    fresh = DistributedFusedAdam(params, lr=1e-2, num_shards=world,
                                 device="cpu")
    res["skip_same"] = torch.equal(
        state.master, fresh.local_state(fresh.init_state()).master) and \
        all(bool((v == 0).all()) for v in state.slots.values())
    return res


def zero_jax(rank, world, out, *, params, grads_steps):
    """ZeRO-Adam and -LAMB at ``world`` shards on the same grads at every
    rank (the JAX tests' ``_run_dist``), Adam's ``state_dict``, and the
    two-level mesh (dcn 2 × ici 2)."""
    import torch

    from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                                   DistributedFusedLAMB)
    from apex_tpu_torch.parallel import make_mesh
    res = {}
    opt = DistributedFusedAdam(params, lr=1e-2, num_shards=world,
                               weight_decay=0.01, gradient_predivide=False,
                               device="cpu")
    _, masters, _ = _zero_run(opt, grads_steps, rank, scale=1.0 / world)
    _leaves_into(res, "nopre_", masters)
    for name, cls, kw in (
            ("adam", DistributedFusedAdam, dict(weight_decay=0.01)),
            ("lamb0", DistributedFusedLAMB,
             dict(weight_decay=0.01, max_grad_norm=0.0)),
            ("lamb5", DistributedFusedLAMB,
             dict(weight_decay=0.01, max_grad_norm=0.05)),
            ("nvlamb", DistributedFusedLAMB,
             dict(weight_decay=0.0, use_nvlamb=True))):
        opt = cls(params, lr=1e-2, num_shards=world, device="cpu", **kw)
        state, masters, _ = _zero_run(opt, grads_steps, rank)
        _leaves_into(res, f"{name}_", masters)
        if name == "adam":
            sd = opt.state_dict(state)
            _leaves_into(res, "sd_master", sd["master"])
            _leaves_into(res, "sd_m", sd["slots"]["m"])
            _leaves_into(res, "sd_v", sd["slots"]["v"])
            res["sd_step"] = sd["step"]
    make_mesh({"dcn": 2, "ici": world // 2}, device="cpu")
    for name, cls, kw in (
            ("two_adam", DistributedFusedAdam,
             dict(weight_decay=0.01, adam_w_mode=True)),
            ("two_lamb", DistributedFusedLAMB,
             dict(weight_decay=0.01, use_nvlamb=False))):
        opt = cls(params, lr=1e-2, axis_name="ici", num_shards=world // 2,
                  replica_axis_name="dcn", device="cpu", **kw)
        _, masters, gathered = _zero_run(opt, grads_steps, rank)
        _leaves_into(res, f"{name}_", masters)
        _leaves_into(res, f"{name}_params", gathered)
    return res


# -- on the card: gloo over CUDA tensors ---------------------------------------

def cuda_gloo_ops(rank, world, out, *, x, dy):
    """SyncBatchNorm's forward and backward on this rank's share of an NCHW
    batch on the card, and the gloo-on-CUDA rules of the collectives."""
    import torch

    from apex_tpu_torch.parallel import SyncBatchNorm
    from apex_tpu_torch.parallel import collectives as C
    res = {"rules": np.asarray(sorted(C.axis("data").rules.items()))}
    bn = SyncBatchNorm(x.shape[1], axis_name="data", channel_last=False,
                       fuse_relu=True)
    p, st = bn.init("cuda")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    xs = torch.from_numpy(shard(x, rank, world)).cuda().requires_grad_(True)
    y, new = bn.apply(p, st, xs, training=True)
    gx, gw, gb = torch.autograd.grad(
        y, (xs, p["weight"], p["bias"]),
        torch.from_numpy(shard(dy, rank, world)).cuda())
    res["y"] = y.detach().cpu().numpy()
    res["gx"] = gx.cpu().numpy()
    res["gw"] = C.grouped_psum(gw, "data").cpu().numpy()
    res["gb"] = C.grouped_psum(gb, "data").cpu().numpy()
    res["running_var"] = new["running_var"].cpu().numpy()
    big = torch.arange(8 * world, dtype=torch.float32,
                       device="cuda") * (rank + 1)
    with C.step_scope():
        res["rs"] = C.psum_scatter(big, "data").cpu().numpy()
        res["ag"] = C.all_gather(big[:8].to(torch.bfloat16),
                                 "data").float().cpu().numpy()
        res["tally"] = np.asarray(sorted(C.collective_bytes()["ops"]))
    return res


# -- sequence, expert and pipeline parallelism --------------------------------

def _seq_shard(a, rank: int, world: int, dim: int):
    n = a.shape[dim] // world
    return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=dim)


def ring_ops(rank, world, out, *, q, k, v, q2, k2, v2, q3, k3, v3, q5, k5,
             v5, kvb, kvb_bh, kvb_shared):
    """Ring and Ulysses attention on this rank's sequence shard of the
    global [B, H, S, D] inputs (axis ``"seq"``): outputs, the grads of
    each rank's sum(out²) (a replicated loss over the ranks' sum), the
    kv_bias and dropout cases."""
    import torch

    from apex_tpu_torch.parallel.ring_attention import (ring_attention,
                                                        ulysses_attention)

    def mine(a, dim=2):
        return torch.from_numpy(_seq_shard(a, rank, world, dim))

    res = {}
    b, h, s, d = q.shape
    for causal in (False, True):
        ql, kl, vl = (mine(a).reshape(b * h, s // world, d)
                      for a in (q, k, v))
        res[f"ring_{causal}"] = ring_attention(
            ql, kl, vl, "seq", world, causal=causal).reshape(
            b, h, s // world, d).numpy()
        res[f"ulysses_{causal}"] = ulysses_attention(
            mine(q2), mine(k2), mine(v2), "seq", world,
            causal=causal).numpy()
        res[f"ulysses_ref_{causal}"] = ulysses_attention(
            mine(q2), mine(k2), mine(v2), "seq", world, causal=causal,
            impl="default").numpy()
    # grads of the ranks' summed sum(out^2): each rank seeds its own part
    for name, fn in (("ring", ring_attention), ("ulysses",
                                                ulysses_attention)):
        ts = [mine(a).requires_grad_(True) for a in (q3, k3, v3)]
        o = fn(*ts, "seq", world, causal=True)
        gs = torch.autograd.grad((o ** 2).sum(), ts)
        for g, nm in zip(gs, "qkv"):
            res[f"{name}_g{nm}"] = g.numpy()
    # key padding: a [B*H, S_local] bias rotating with its keys
    ql, kl, vl = (mine(a).reshape(b * h, s // world, d) for a in (q2, k2,
                                                                  v2))
    res["ring_kvb"] = ring_attention(
        ql, kl, vl, "seq", world,
        kv_bias=mine(kvb, 1)).reshape(b, h, s // world, d).numpy()
    for tag, bias in (("per_bh", kvb_bh), ("shared", kvb_shared)):
        for impl in ("flash", "default"):
            res[f"ulysses_kvb_{tag}_{impl}"] = ulysses_attention(
                mine(q5), mine(k5), mine(v5), "seq", world, causal=True,
                kv_bias=mine(bias, 1), impl=impl).numpy()
    res["ring_drop"] = ring_attention(
        mine(q3), mine(k3), mine(v3), "seq", world, causal=True,
        dropout_rate=0.2, dropout_seed=123).numpy()
    try:
        ulysses_attention(mine(q3)[:, :3], mine(k3)[:, :3],
                          mine(v3)[:, :3], "seq", world)
        res["indivisible"] = ""
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


def collective_grad_ops(rank, world, out, *, x, y, c, tensors="cpu"):
    """ppermute (a ring and a partial permutation), all_to_all, psum,
    pmean, pmax and pvary on this rank's rows of x: each term's value and
    the grad of its weighted sum — a varying value weighted by this rank's
    rows of y, a replicated one by ``c``, the same on every rank, or
    through ``pvary`` by this rank's rows — by the axis's own rules and by
    the gloo-on-CUDA rules forced onto the same group (bound as
    ``"seq_rules"``); with ``tensors="cuda"`` (a gloo group over CUDA
    tensors) by the axis's rules alone, which are those."""
    import torch

    from apex_tpu_torch.parallel import collectives as C
    names = ("seq",)
    device = tensors
    if device == "cpu":
        ax = C.axis("seq")
        own_rules = C.collective_rules
        C.collective_rules = lambda backend, dev: own_rules("gloo", "cuda")
        try:
            C.bind_axis("seq_rules", ax.group, device_type="cpu")
        finally:
            C.collective_rules = own_rules
        names = ("seq", "seq_rules")
    res = {"rules": np.asarray(sorted(C.axis(names[-1]).rules.items()))}
    ring = [(j, (j + 1) % world) for j in range(world)]
    w = torch.from_numpy(shard(y, rank, world)).to(device)
    rep = torch.from_numpy(c).to(device)
    terms = {       # name: (value, its weight)
        "ring": lambda xs, n: (C.ppermute(xs, n, ring), w),
        "half": lambda xs, n: (C.ppermute(xs.to(torch.bfloat16), n,
                                          [(0, 1)]).float(), w),
        "a2a": lambda xs, n: (C.all_to_all(xs, n, split_axis=1,
                                           concat_axis=0), 1.0),
        "psum": lambda xs, n: (C.psum(xs * w, n), rep),
        "psum_vary": lambda xs, n: (C.pvary(C.psum(xs * w, n), n), w),
        "pmean": lambda xs, n: (C.pmean(xs, n), rep),
        "pmax": lambda xs, n: (C.pmax(xs, n), rep),
        "pvary": lambda xs, n: (C.pvary(C.psum(xs.sum(), n), n),
                                float(rank + 1)),
    }
    for name in names:
        with C.step_scope():
            for t, fn in terms.items():
                xs = torch.from_numpy(shard(x, rank, world)).to(
                    device).requires_grad_(True)
                val, wt = fn(xs, name)
                (g,) = torch.autograd.grad((val * wt).sum(), xs)
                res[f"{t}_{name}"] = val.detach().cpu().numpy()
                res[f"g_{t}_{name}"] = g.cpu().numpy()
            tally = C.collective_bytes()
        res[f"tally_{name}"] = np.asarray(sorted(
            (k.split("[")[0], v["calls"]) for k, v in tally["ops"].items()),
            dtype=object).astype(str)
    return res


def _lm_from(cfg, params, **kw):
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import TransformerLM
    return (TransformerLM(**cfg, **kw, device="cpu"),
            params_from_jax(params, device="cpu"))


def seq_lm_ops(rank, world, out, *, cfg, params, toks, steps_toks):
    """TransformerLM over a ``"seq"`` axis on this rank's time shard: the
    logits, the loss and its grads summed over the axis (dense and
    chunked head), the logits-squared objective's grads, and
    SeqParallelTrainer's steps (plain and 2 microbatches with a dynamic
    scale) in fp32."""
    import torch

    from apex_tpu_torch.ops import flat as F
    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.train import SeqParallelTrainer
    res = {}
    mine = torch.from_numpy(_seq_shard(toks, rank, world, 1))
    for tag, kw in (("dense", {}), ("chunk", {"head_chunk": 10})):
        model, p = _lm_from(cfg, params, seq_axis="seq",
                            seq_axis_size=world, **kw)
        if tag == "dense":
            res["logits"] = model.apply(p, mine).numpy()
            leaves = F.tree_leaves(p)
            for t in leaves:
                t.requires_grad_(True)
            obj = C.pmean(torch.mean(model.apply(p, mine) ** 2), "seq")
            gs = torch.autograd.grad(obj, leaves)
            for i, g in enumerate(gs):
                res[f"sq_g{i}"] = C.psum(g, "seq").numpy()
            for t in leaves:
                t.requires_grad_(False)
        leaves = F.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(p, mine, is_training=False)
        gs = torch.autograd.grad(loss, leaves)
        res[f"{tag}_loss"] = loss.detach().numpy()
        for i, g in enumerate(gs):
            res[f"{tag}_g{i}"] = C.psum(g, "seq").numpy()
            if rank == 0 and tag == "dense":
                res[f"partial_g{i}"] = g.numpy()
    for tag, kw in (("plain", {}), ("accum", {"microbatches": 2,
                                              "loss_scale": "dynamic"})):
        model, p = _lm_from(cfg, params, seq_axis="seq",
                            seq_axis_size=world)
        tr = SeqParallelTrainer(model, p, lr=3e-3, dtype=None,
                                device="cpu", **kw)
        st = torch.from_numpy(_seq_shard(steps_toks, rank, world, 1))
        res[f"{tag}_grad1"] = tr.global_grad(st)[0].numpy()
        res[f"{tag}_losses"] = np.array([float(tr.step(st))
                                         for _ in range(3)])
        res[f"{tag}_tally"] = np.asarray(sorted(
            (k, v["calls"]) for k, v in C.collective_bytes()["ops"].items()),
            dtype=object).astype(str)
        res[f"{tag}_master"] = tr.opt.state[0].master.numpy()
    return res


def moe_ep_ops(rank, world, out, *, params, x, params_lm, cfg_lm, toks):
    """MoEMLP with ``expert_axis="expert"`` at top-1 and top-2 on the same
    (replicated) tokens, this rank's slice of the experts: y, the dropped
    fraction and the grads of sum(y²); and an LM with an MoE layer,
    expert parallel: the loss and its grads."""
    import torch

    from apex_tpu_torch.contrib.moe import MoEMLP
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.ops import flat as F
    res = {}

    def local(tree):
        el = tree["w1"].shape[0] // world
        return {k: (v[rank * el:(rank + 1) * el] if k != "router" else v)
                for k, v in tree.items()}

    xs = torch.from_numpy(x)
    for k in (1, 2):
        moe = MoEMLP(hidden=x.shape[1], ffn=params["w1"].shape[2],
                     num_experts=params["w1"].shape[0], top_k=k,
                     capacity_factor=1.5, expert_axis="expert",
                     expert_axis_size=world, device="cpu")
        p = {n: t.requires_grad_(True) for n, t in params_from_jax(
            local(params), device="cpu").items()}
        xr = xs.clone().requires_grad_(True)
        y, aux = moe.apply(p, xr)
        res[f"y{k}"] = y.detach().numpy()
        res[f"dropped{k}"] = aux["dropped_fraction"].numpy()
        names = sorted(p)
        gs = torch.autograd.grad((y ** 2).sum(), [p[n] for n in names]
                                 + [xr])
        for n, g in zip(names + ["x"], gs):
            res[f"g{k}_{n}"] = g.numpy()
    from apex_tpu_torch.models import TransformerLM
    lm = TransformerLM(**cfg_lm, expert_axis="expert",
                       expert_axis_size=world, device="cpu")
    tree = dict(params_lm)
    tree["layer_1"] = dict(tree["layer_1"], moe=local(tree["layer_1"]["moe"]))
    p = params_from_jax(tree, device="cpu")
    leaves = F.tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    loss = lm.loss(p, torch.from_numpy(toks))
    gs = torch.autograd.grad(loss, leaves)
    res["lm_loss"] = loss.detach().numpy()
    for i, g in enumerate(gs):
        res[f"lm_g{i}"] = g.numpy()
    return res


def _block_fn(lp, h):
    """tests/test_pipeline.py's block: LN -> tanh MLP -> residual."""
    import torch
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    hn = (h - mu) * torch.rsqrt(var + 1e-5)
    return h + torch.tanh(hn @ lp["w1"] + lp["b1"]) @ lp["w2"]


def pipe_ops(rank, world, out, *, layers, x, y, stages, data=1):
    """gpipe over the ``"pipe"`` axis (``data`` > 1: a ``"data"`` axis
    outside, the batch split over it): this rank's stage layers from the
    stacked ``layers``, the outputs at 4 and 8 microbatches, the loss
    mean((out - y)²) and the grads of the stage's layers and of x taken
    on each rank (the data axis's averaged over it)."""
    import torch

    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.parallel.pipeline import gpipe, stack_layers
    res = {}
    p_idx = C.axis_index("pipe")
    d_idx = C.axis_index("data") if data > 1 else 0
    n_layers = len(layers)
    per = n_layers // stages
    local = stack_layers([{k: torch.from_numpy(v) for k, v in lay.items()}
                          for lay in layers[p_idx * per:(p_idx + 1) * per]])
    xs, ys = (torch.from_numpy(shard(a, d_idx, data)) for a in (x, y))
    if data == 1:
        for m in (4, 8):
            res[f"out{m}"] = gpipe(_block_fn, local, xs, axis_name="pipe",
                                   num_stages=stages,
                                   num_microbatches=m).numpy()
    local = {k: v.requires_grad_(True) for k, v in local.items()}
    xr = xs.clone().requires_grad_(True)
    o = gpipe(_block_fn, local, xr, axis_name="pipe", num_stages=stages,
              num_microbatches=4)
    loss = torch.mean((o - ys) ** 2)
    names = sorted(local)
    gs = torch.autograd.grad(loss, [local[n] for n in names] + [xr])
    res["loss"] = loss.detach().numpy()
    for n, g in zip(names, gs):
        res[f"g_{n}"] = (C.grouped_psum(g, "data") / data).numpy() \
            if data > 1 else g.numpy()
    res["g_x"] = C.grouped_psum(gs[-1], "pipe").numpy()
    for bad in (dict(num_stages=stages, num_microbatches=3),
                dict(num_stages=stages + 1, num_microbatches=4)):
        try:
            gpipe(_block_fn, local, xs, axis_name="pipe", **bad)
            res[f"bad_{bad['num_stages']}"] = ""
        except ValueError as e:
            res[f"bad_{bad['num_stages']}"] = str(e)
    return res
