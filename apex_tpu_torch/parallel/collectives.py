"""Collectives over named axes — counterpart of
``apex_tpu/parallel/collectives.py``, and the only module of the port that
calls ``torch.distributed``.

A JAX axis name is bound by ``shard_map``; here an axis is a
``torch.distributed`` process group bound to a name by
:func:`bind_axis` (``parallel.make_mesh`` binds every dimension of its
mesh). :func:`grouped_psum` sums over the axis, or over the sub-group of
``groups`` (``axis_index_groups``: lists of positions along the axis) that
holds this rank; :func:`psum_scatter` and :func:`all_gather` are ZeRO's
tiled reduce-scatter and gather along dim 0.

**The form each op takes** is chosen when the axis is bound, from its
backend and the device type of its tensors (:func:`collective_rules`),
and written into the :class:`Axis`; a tensor of another device type is
refused. gloo on CUDA tensors has no reduce-scatter or gather of its own,
so there a reduce-scatter is an all-reduce followed by this rank's slice
and a gather is one broadcast per rank into that rank's slice (both
exact). Nothing is chosen by catching an error. A gather moves bytes: the
tensor travels as ``uint8`` (an 8-bit float or bf16 has no gloo type, and
a copy does not depend on it).

**The byte tally** keeps the JAX keys (``"psum[data]"``, ``calls``,
``bytes``; :func:`collective_bytes`). The JAX tally is counted at trace
time, once for each compiled program, so it holds the collectives of one
step. An eager port counts at every call, so the port scopes the tally to
a step: :func:`step_scope` clears it on entry (the trainers wrap each step
in it), and after a step it holds that step's collectives. It is tallied
as what ran: a reduce-scatter by the all-reduce rule is a ``psum`` of the
whole buffer. The latency tally (:func:`time_collective`,
:func:`collective_latency`, ``LATENCY_BINS_MS``) is the JAX one, copied.

Not ported: ``varies_over`` and ``vma_tracking_active``, JAX autodiff
plumbing (whether a gradient arrives already summed over the axis). In
torch every rank's gradient is local, so ``DistributedDataParallel`` is
the one place it is reduced.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional, Sequence

import torch

__all__ = ["Axis", "bind_axis", "unbind_axes", "axis",
           "collective_rules", "grouped_psum", "group_size", "axis_index",
           "psum_scatter", "all_gather", "broadcast", "sub_axis",
           "record_collective", "collective_bytes", "reset_collective_bytes",
           "step_scope", "LATENCY_BINS_MS", "record_collective_latency",
           "time_collective", "collective_latency",
           "reset_collective_latency"]


def _dist():
    import torch.distributed as dist
    return dist


# -- the byte tally -----------------------------------------------------------

_TALLY: dict = {}
_TALLY_LOCK = threading.Lock()
_SCOPE = {"depth": 0}


def record_collective(op: str, nbytes: int, axis_name=None) -> None:
    """Tally one collective. ``nbytes`` is the per-rank input payload."""
    key = f"{op}[{axis_name}]" if axis_name is not None else op
    with _TALLY_LOCK:
        e = _TALLY.setdefault(key, {"calls": 0, "bytes": 0})
        e["calls"] += 1
        e["bytes"] += int(nbytes)


def collective_bytes() -> dict:
    """Snapshot of the tally: ``{"ops": {name: {"calls", "bytes"}},
    "total_bytes", "total_calls"}``; empty when nothing ran."""
    with _TALLY_LOCK:
        ops = {k: dict(v) for k, v in _TALLY.items()}
    if not ops:
        return {}
    return {"ops": ops,
            "total_bytes": sum(v["bytes"] for v in ops.values()),
            "total_calls": sum(v["calls"] for v in ops.values())}


def reset_collective_bytes() -> None:
    with _TALLY_LOCK:
        _TALLY.clear()


@contextlib.contextmanager
def step_scope():
    """One step's collectives: the outermost scope clears the tally on
    entry, so after it the tally holds what the step ran (the JAX tally of
    a compiled step). Nested scopes add to the outer one."""
    with _TALLY_LOCK:
        if _SCOPE["depth"] == 0:
            _TALLY.clear()
        _SCOPE["depth"] += 1
    try:
        yield
    finally:
        with _TALLY_LOCK:
            _SCOPE["depth"] -= 1


# -- the latency tally (copied from the JAX module) ---------------------------

LATENCY_BINS_MS = (0.1, 1.0, 10.0, 100.0, 1000.0)

_LAT_TALLY: dict = {}


def record_collective_latency(op: str, ms: float, nbytes: int = 0) -> None:
    """Tally one host-observed collective round-trip (dispatch + fetch)."""
    idx = 0
    for hi in LATENCY_BINS_MS:
        if ms < hi:
            break
        idx += 1
    with _TALLY_LOCK:
        e = _LAT_TALLY.setdefault(op, {
            "calls": 0, "ms_total": 0.0, "ms_max": 0.0, "bytes": 0,
            "hist": [0] * (len(LATENCY_BINS_MS) + 1)})
        e["calls"] += 1
        e["ms_total"] += float(ms)
        e["ms_max"] = max(e["ms_max"], float(ms))
        e["bytes"] += int(nbytes)
        e["hist"][idx] += 1


@contextlib.contextmanager
def time_collective(op: str, nbytes: int = 0):
    """Time a host-blocking collective round-trip into the latency
    histogram; wrap the dispatch and the fetch of its value."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_collective_latency(
            op, (time.perf_counter() - t0) * 1e3, nbytes)


def collective_latency() -> dict:
    """``{"ops": {name: {calls, ms_total, ms_max, bytes, hist}},
    "bins_ms": [...]}``; empty when nothing was timed."""
    with _TALLY_LOCK:
        ops = {k: dict(v, hist=list(v["hist"]),
                       ms_total=round(v["ms_total"], 3),
                       ms_max=round(v["ms_max"], 3))
               for k, v in _LAT_TALLY.items()}
    if not ops:
        return {}
    return {"ops": ops, "bins_ms": list(LATENCY_BINS_MS)}


def reset_collective_latency() -> None:
    with _TALLY_LOCK:
        _LAT_TALLY.clear()


# -- axes ---------------------------------------------------------------------

def collective_rules(backend: str, device_type: str) -> dict:
    """How the reduce-scatter and the gather run on a group of ``backend``
    over tensors of ``device_type``: the op itself, or the stated rewrite
    (every backend has the all-reduce and the broadcast)."""
    if backend == "gloo" and device_type == "cuda":
        return {"reduce_scatter": "all_reduce+slice",
                "all_gather": "broadcast_each"}
    return {"reduce_scatter": "reduce_scatter", "all_gather": "all_gather"}


class Axis:
    """A named axis: this rank's process group along it, the global ranks
    of that group in axis order, every instance of the axis across the
    mesh (``rows``, for sub-groups), and the rules of
    :func:`collective_rules`."""

    def __init__(self, name: str, group, ranks: Sequence[int],
                 rows: Sequence[Sequence[int]], backend: str,
                 device_type: str, rules: Optional[dict] = None):
        self.name = name
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.rows = tuple(tuple(int(r) for r in row) for row in rows)
        self.backend = backend
        self.device_type = device_type
        self.rules = dict(rules) if rules is not None else \
            collective_rules(backend, device_type)
        rank = _dist().get_rank()
        self.index = self.ranks.index(rank)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return (f"Axis({self.name!r}, ranks={self.ranks}, "
                f"backend={self.backend!r}, device={self.device_type!r})")


_AXES: dict = {}
_SUB: dict = {}


def bind_axis(name: str, group, *, device_type: str,
              rows: Optional[Sequence[Sequence[int]]] = None) -> Axis:
    """Bind ``name`` to ``group`` (a process group, or None for the
    world). ``rows``: the global ranks of every instance of the axis, one
    list each (default: the group's own ranks). The rules are
    :func:`collective_rules`' for the group's backend and ``device_type``."""
    dist = _dist()
    if group is None:
        group = dist.group.WORLD
    ranks = dist.get_process_group_ranks(group)
    ax = Axis(name, group, ranks, rows if rows is not None else [ranks],
              dist.get_backend(group), device_type)
    _AXES[name] = ax
    for key in [k for k in _SUB if k[0] == name]:
        del _SUB[key]
    return ax


def unbind_axes() -> None:
    """Forget every bound axis and sub-group (before a process group is
    destroyed)."""
    _AXES.clear()
    _SUB.clear()


def axis(name: str) -> Axis:
    if name not in _AXES:
        raise RuntimeError(
            f"axis {name!r} is not bound to a process group; call "
            f"apex_tpu_torch.parallel.launch.initialize(...) and then "
            f"parallel.make_mesh({{{name!r}: -1}}) on every rank")
    return _AXES[name]


def _canon_groups(groups) -> Optional[tuple]:
    if groups is None:
        return None
    return tuple(tuple(int(i) for i in g) for g in groups)


def sub_axis(axis_name: str, groups) -> Axis:
    """The sub-group of ``groups`` (positions along the axis) that holds
    this rank. Made on first use on every rank, in the same order: one
    ``new_group`` for each group of each instance of the axis."""
    ax = axis(axis_name)
    groups = _canon_groups(groups)
    if groups is None:
        return ax
    key = (axis_name, groups)
    if key not in _SUB:
        dist = _dist()
        rank = dist.get_rank()
        mine = None
        for row in ax.rows:
            for g in groups:
                ranks = [row[i] for i in g]
                pg = dist.new_group(ranks, backend=ax.backend)
                if rank in ranks:
                    mine = (pg, ranks, [[row[i] for i in gg]
                                        for gg in groups])
        if mine is None:
            raise ValueError(f"rank {rank} is in no group of {groups}")
        pg, ranks, rows = mine
        sub = Axis(axis_name, pg, ranks, rows, ax.backend, ax.device_type,
                   ax.rules)
        _SUB[key] = sub
    return _SUB[key]


def _check_device(ax: Axis, x: torch.Tensor, op: str) -> None:
    if x.device.type != ax.device_type:
        raise ValueError(
            f"{op} over axis {ax.name!r}: the axis was bound for "
            f"{ax.device_type} tensors, got a {x.device.type} tensor")


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# -- ops ----------------------------------------------------------------------

def grouped_psum(x: torch.Tensor, axis_name, groups=None) -> torch.Tensor:
    """Sum of ``x`` over the axis (or this rank's group of ``groups``);
    ``axis_name=None`` returns ``x``. One all-reduce of a copy."""
    if axis_name is None:
        return x
    ax = sub_axis(axis_name, groups)
    _check_device(ax, x, "psum")
    out = x.detach().clone()
    record_collective("psum", _nbytes(out), axis_name)
    _dist().all_reduce(out, group=ax.group)
    return out


def group_size(axis_name, groups=None) -> int:
    """Participants in this rank's reduction group (a host number)."""
    if groups is None:
        return axis(axis_name).size
    return len(_canon_groups(groups)[0])


def axis_index(axis_name) -> int:
    """This rank's position along the axis."""
    return axis(axis_name).index


def psum_scatter(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Tiled reduce-scatter along dim 0: this rank's ``1/n`` slice of the
    sum over the axis (``lax.psum_scatter(..., tiled=True)``)."""
    ax = axis(axis_name)
    _check_device(ax, x, "psum_scatter")
    n = ax.size
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter: dim 0 of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    k = x.shape[0] // n
    x = x.detach().contiguous()
    if ax.rules["reduce_scatter"] == "all_reduce+slice":
        full = x.clone()
        record_collective("psum", _nbytes(full), axis_name)
        _dist().all_reduce(full, group=ax.group)
        return full[ax.index * k:(ax.index + 1) * k].clone()
    dist = _dist()
    out = torch.empty((k, *x.shape[1:]), dtype=x.dtype, device=x.device)
    record_collective("psum_scatter", _nbytes(x), axis_name)
    rs = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    rs(out, x, group=ax.group)
    return out


def all_gather(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Tiled gather along dim 0 over the axis (``lax.all_gather(...,
    tiled=True)``), as bytes."""
    ax = axis(axis_name)
    _check_device(ax, x, "all_gather")
    n = ax.size
    src = x.detach().contiguous()
    raw = src.reshape(-1).view(torch.uint8)
    k = raw.numel()
    out = torch.empty(n * k, dtype=torch.uint8, device=x.device)
    dist = _dist()
    if ax.rules["all_gather"] == "broadcast_each":
        out[ax.index * k:(ax.index + 1) * k] = raw
        for i, r in enumerate(ax.ranks):
            record_collective("broadcast", k, axis_name)
            dist.broadcast(out[i * k:(i + 1) * k], src=r, group=ax.group)
    else:
        record_collective("all_gather", k, axis_name)
        ag = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        ag(out, raw, group=ax.group)
    return out.view(x.dtype).reshape(n * x.shape[0], *x.shape[1:])


def broadcast(x: torch.Tensor, axis_name, src_index: int = 0) -> torch.Tensor:
    """A copy of the tensor of the rank at ``src_index`` along the axis."""
    ax = axis(axis_name)
    _check_device(ax, x, "broadcast")
    out = x.detach().clone().contiguous()
    record_collective("broadcast", _nbytes(out), axis_name)
    _dist().broadcast(out, src=ax.ranks[src_index], group=ax.group)
    return out
