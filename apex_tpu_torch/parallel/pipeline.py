"""Pipeline parallelism: the GPipe schedule over a ``pipe`` axis —
counterpart of ``apex_tpu/parallel/pipeline.py``.

Every rank of the axis holds its stage's layers (its slice of the layers
stacked by :func:`stack_layers`) and runs the same program:
``num_microbatches + num_stages - 1`` ticks, each computing the local
stage and handing its activation to the next rank by one neighbour
``collectives.ppermute``; rank 0 injects microbatch t at tick t, the
last rank collects microbatch t - (stages - 1), and a masked ``psum``
gives every rank the collected outputs.

The backward needs no code of its own: ``ppermute``'s backward sends the
cotangents back stage by stage, and ``psum``'s is the identity
(``collectives``' rule), so each stage's layer gradients come out exact
on the rank that holds them, not ``num_stages`` times over. The input's
gradient arrives on rank 0 (the other ranks' is zero): sum it over the
axis if the input is replicated. As in the JAX schedule every rank runs
its stage on every tick, the bubble ticks on values that are never
collected; that keeps every rotation's result on the path to each rank's
loss, so every rank runs every backward rotation. The last tick's
rotation, which JAX issues and discards, is not sent.

The schedule is plain GPipe (bubble fraction (S-1)/(M+S-1)).
"""

from __future__ import annotations

from typing import Callable

import torch

from apex_tpu_torch.parallel import collectives as _C

__all__ = ["gpipe", "stack_layers", "unstack_layers"]


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def stack_layers(layer_params: list) -> dict:
    """Stack per-layer param trees (nested dicts of tensors) into one tree
    with a leading ``num_layers`` axis; rank r of S stages holds layers
    ``r·L/S`` to ``(r+1)·L/S`` of it."""
    return _map(lambda *ls: torch.stack(ls), *layer_params)


def unstack_layers(stacked: dict) -> list:
    """Inverse of :func:`stack_layers`: a list of per-layer trees (views
    of the stacked leaves)."""
    n = _first_leaf(stacked).shape[0]
    return [_map(lambda leaf, i=i: leaf[i], stacked) for i in range(n)]


def gpipe(layer_fn: Callable, local_layers: dict, x: torch.Tensor, *,
          axis_name: str, num_stages: int,
          num_microbatches: int) -> torch.Tensor:
    """Run ``x`` through all stages' layers, pipelined over ``axis_name``
    (pipeline.py:65-126); every rank of the axis calls it.

    layer_fn : (layer_params, h) -> h, one layer; the output has the
        input's shape and dtype (transformer blocks do).
    local_layers : this rank's stacked layer params (leading axis the
        stage's layers).
    x : [B, ...] the whole (replicated) batch; B must divide by
        ``num_microbatches``.

    Returns the [B, ...] outputs, on every rank."""
    s, m = num_stages, num_microbatches
    b = x.shape[0]
    axis = _C.group_size(axis_name)
    if axis != s:
        raise ValueError(
            f"num_stages={s} != size of mesh axis {axis_name!r} ({axis}); "
            f"a smaller ring would silently skip the extra ranks' layers")
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    micro = x.reshape(m, b // m, *x.shape[1:])
    rank = _C.axis_index(axis_name)
    last = s - 1
    fwd_perm = [(i, (i + 1) % s) for i in range(s)]
    layers = unstack_layers(local_layers)
    first = torch.tensor(rank == 0, device=x.device)

    def stage(h):
        for lp in layers:
            h = layer_fn(lp, h)
        return h

    h_in = torch.zeros_like(micro[0])
    outs = []
    ticks = m + s - 1
    for t in range(ticks):
        # fill: rank 0 reads microbatch t (clamped in the drain, where its
        # output is never collected); the where keeps h_in on the path
        h = torch.where(first, micro[min(t, m - 1)], h_in)
        h_out = stage(h)
        # drain: the last rank owns microbatch t - (s - 1) at tick t;
        # every rank keeps its drain outputs, weighted 0 but the last's
        if t >= last:
            outs.append(h_out)
        if t < ticks - 1:
            h_in = _C.ppermute(h_out, axis_name, fwd_perm)
    own = torch.stack(outs) * (1.0 if rank == last else 0.0)
    out = _C.psum(own, axis_name)
    return out.reshape(b, *x.shape[1:])
