"""Data-parallel gradient averaging — counterpart of
``apex_tpu/parallel/distributed.py``.

The semantics are the JAX package's (and the reference's,
apex/parallel/distributed.py:129-639), without its bucketing machinery:

- gradients averaged over the replica axis (all-reduce, then ``/world``);
- ``gradient_predivide_factor`` f: divided by f before the all-reduce and
  by world/f after (distributed.py:153-155, 461-466);
- ``allreduce_always_fp32``: upcast before the reduce, downcast after;
- ``axis_index_groups``: the average over this rank's sub-group;
- the scheduling knobs (``message_size``, ``delay_allreduce``, ...) are
  accepted and ignored, as in the JAX package.

Every rank's gradient is local in torch (there is no autodiff over a
replicated value that would sum it already, as JAX's vma tracking does),
so :meth:`DistributedDataParallel.average_gradients` always reduces, and
is the one place the gradients are reduced: ``SyncBatchNorm`` leaves its
weight and bias gradients local. The flat master grad is one buffer, so
averaging it is one all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.ops.flat import tree_leaves, tree_map
from apex_tpu_torch.parallel import collectives as _C

__all__ = ["Reducer", "DistributedDataParallel", "broadcast_params",
           "flat_dist_call"]


def _over(fn, tree):
    """``fn`` on a tensor, or on every leaf of a tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree_map(fn, tree)


@dataclasses.dataclass(frozen=True)
class Reducer:
    """Manual all-reduce-mean of a tensor or tree over an axis (the
    reference's ``Reducer``, distributed.py:89-127); ``axis_index_groups``
    restricts it to sub-groups."""

    axis_name: str = "data"
    axis_index_groups: Optional[tuple] = None

    def reduce(self, tree: Any) -> Any:
        n = _C.group_size(self.axis_name, self.axis_index_groups)
        return _over(lambda g: _C.grouped_psum(
            g, self.axis_name, self.axis_index_groups) / n, tree)

    def __call__(self, tree: Any) -> Any:
        return self.reduce(tree)


@dataclasses.dataclass(frozen=True)
class DistributedDataParallel:
    """Gradient-averaging policy over an axis (the reference's
    ``DistributedDataParallel``, distributed.py:129): the numeric knobs
    act, the scheduling knobs are accepted and ignored."""

    axis_name: str = "data"
    gradient_average: bool = True
    allreduce_always_fp32: bool = False
    gradient_predivide_factor: float = 1.0
    axis_index_groups: Optional[tuple] = None
    # accepted and ignored (distributed.py:162-175)
    message_size: int = 10_000_000
    delay_allreduce: bool = False
    shared_param: Optional[Any] = None
    allreduce_trigger_params: Optional[Any] = None
    num_allreduce_streams: int = 1
    allreduce_communicators: Optional[Any] = None
    retain_allreduce_buffers: bool = False
    gradient_average_split_factor: Optional[float] = None
    prof: bool = False

    def average_gradients(self, grads: Any) -> Any:
        """All-reduce-average a tensor or a tree of local gradients."""
        world = _C.group_size(self.axis_name, self.axis_index_groups)
        f = self.gradient_predivide_factor

        def reduce_one(g):
            dtype = g.dtype
            if self.allreduce_always_fp32:
                g = g.float()
            if f != 1.0:
                g = g / f
            g = _C.grouped_psum(g, self.axis_name, self.axis_index_groups)
            if self.gradient_average:
                g = g / (world / f)
            elif f != 1.0:
                g = g * f
            return g.to(dtype)

        return _over(reduce_one, grads)

    def value_and_grad(self, loss_fn: Callable) -> Callable:
        """``loss_fn(params, *args)`` -> ``(loss, averaged grads of
        params)``, the grads a tree like ``params`` (autograd against
        detached copies of its leaves)."""
        def wrapped(params, *args, **kwargs):
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(params)]
            it = iter(leaves)
            p = tree_map(lambda _: next(it), params)
            loss = loss_fn(p, *args, **kwargs)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            git = iter([torch.zeros_like(x) if g is None else g
                        for x, g in zip(leaves, gs)])
            grads = tree_map(lambda _: next(git), params)
            return loss.detach(), self.average_gradients(grads)

        return wrapped

    def grad(self, loss_fn: Callable) -> Callable:
        vg = self.value_and_grad(loss_fn)

        def wrapped(*args, **kwargs):
            return vg(*args, **kwargs)[1]

        return wrapped

    def compile_step(self, body: Callable, mesh, *, in_specs, out_specs,
                     donate_argnums=(), static_argnums=(),
                     check_vma=False) -> Callable:
        """A per-rank train-step body through the Plan
        (``plan.compile_step_with_plan``, lowering ``"shard_map"``)."""
        from apex_tpu_torch.parallel.plan import Plan, compile_step_with_plan
        plan = Plan(mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                    donate_argnums=tuple(donate_argnums),
                    static_argnums=tuple(static_argnums),
                    check_vma=check_vma)
        return compile_step_with_plan(body, plan)


def broadcast_params(params: Any, mesh=None, axis_name: str = "data") -> Any:
    """Rank 0's params on every rank (the reference's ctor-time
    ``dist.broadcast``, distributed.py:253): one broadcast a leaf from
    position 0 of ``axis_name``."""
    del mesh
    return _over(lambda t: _C.broadcast(t, axis_name, 0), params)


def flat_dist_call(tree: Any, op: Callable, axis_name: str = "data") -> Any:
    """``op(leaf, axis_name)`` on every leaf (distributed.py:70-87)."""
    return _over(lambda x: op(x, axis_name), tree)
