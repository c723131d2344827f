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
refused. gloo on CUDA tensors has no reduce-scatter, gather, send/recv or
all-to-all of its own, so there a reduce-scatter is an all-reduce
followed by this rank's slice, a gather is one broadcast per rank into
that rank's slice, and a ``ppermute`` or an ``all_to_all`` stages its
bytes through pinned host buffers and runs gloo's CPU send/recv or
all-to-all on the same group (all exact). Nothing is chosen by catching
an error. A gather, a ``ppermute`` and an ``all_to_all`` move bytes: the
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

**Differentiable collectives** (:func:`ppermute`, :func:`all_to_all`,
:func:`psum`, :func:`pmean`, :func:`pmax`, :func:`pvary`) are
``autograd.Function``s with JAX's vma semantics, one rule for every
caller. A value is *replicated* over an axis (the same on every rank) or
*varying*. Every rank seeds the backward of its own copy of a replicated
loss, and those copies count as one loss:

- ``psum`` (and ``pmean``, ``pmax``) turn a varying value into a
  replicated one; the backward of ``psum`` is the identity: the
  cotangent of the replicated sum, replicated too, is the cotangent of
  each rank's summand (``pmean`` divides it by the size, ``pmax`` gives
  it to the ranks that hold the maximum, split evenly among ties);
- ``pvary`` marks a replicated value that enters a varying computation
  (JAX's implicit replicated-to-varying cast): the identity forward, a
  ``psum`` of the cotangent backward, so the value's gradient is
  replicated again. A replicated value that a rank-dependent
  computation consumes must pass through it, or its cotangent is not
  replicated and the identity backward above is wrong; every caller in
  the port consumes its sums replicated (a loss, GPipe's outputs, the
  MoE's combined tokens);
- ``ppermute``'s backward is the inverse permutation of the cotangent,
  ``all_to_all``'s the inverse ``all_to_all``.

Under this rule the gradient a rank holds for a replicated parameter
used in a varying computation without ``pvary`` is that rank's partial:
the gradient of the whole loss is the **sum** of the partials over the
axis. That is the sequence-parallel step's reduction
(``train.SeqParallelTrainer``: every parameter of the LM meets the
sharded sequence, so its flat grad is summed over ``seq`` once); GPipe's
stage layers are varying and their grads exact; the MoE's expert
parallelism marks its dispatch buffer with ``pvary``, so the replicated
parameters' grads come out whole on every rank. JAX's
``train_ring.py`` takes a ``pmean`` instead because it runs with
``check_vma=False``, where ``psum``'s transpose is another ``psum`` and
each partial arrives n times over.

Every rank must run the same collectives in the same order, the backward
ones too: a differentiable collective's output must reach the rank's own
loss (a zero-weighted use counts), or its backward would not run there.
The ring and GPipe keep every rotation connected that way.

Not ported: ``varies_over`` and ``vma_tracking_active``, JAX autodiff
plumbing (whether a gradient arrives already summed over the axis); the
rule above fixes it here.
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
           "ppermute", "all_to_all", "psum", "pmean", "pmax", "pvary",
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
    """How the reduce-scatter, the gather, ``ppermute`` and ``all_to_all``
    run on a group of ``backend`` over tensors of ``device_type``: the op
    itself, or the stated rewrite (every backend has the all-reduce and
    the broadcast; gloo has send/recv and all-to-all for CPU tensors)."""
    if backend == "gloo" and device_type == "cuda":
        return {"reduce_scatter": "all_reduce+slice",
                "all_gather": "broadcast_each",
                "ppermute": "host_send_recv",
                "all_to_all": "host_all_to_all"}
    return {"reduce_scatter": "reduce_scatter", "all_gather": "all_gather",
            "ppermute": "send_recv", "all_to_all": "all_to_all"}


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


# -- differentiable collectives (the vma rule of the module docstring) -------

def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _host_empty(n: int) -> torch.Tensor:
    """A host byte buffer for gloo's CPU ops, pinned where there is a card
    (the rules can be forced onto CPU tensors, as the tests do)."""
    return torch.empty(n, dtype=torch.uint8,
                       pin_memory=torch.cuda.is_available())


def _host(raw: torch.Tensor) -> torch.Tensor:
    """A host copy of a device byte buffer."""
    buf = _host_empty(raw.numel())
    buf.copy_(raw)
    return buf


def _canon_perm(perm, n: int) -> tuple:
    perm = tuple((int(s), int(d)) for s, d in perm)
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            not all(0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a partial permutation "
                         f"of {n} axis positions")
    return perm


def _ppermute_raw(x: torch.Tensor, axis_name, perm) -> torch.Tensor:
    """``lax.ppermute``: this rank's tensor to the position ``perm`` maps
    it to, the tensor of the position mapped here back (zeros where none
    is)."""
    ax = axis(axis_name)
    _check_device(ax, x, "ppermute")
    perm = _canon_perm(perm, ax.size)
    i = ax.index
    dst = [d for s, d in perm if s == i]
    src = [s for s, d in perm if d == i]
    raw = _as_bytes(x)
    record_collective("ppermute", raw.numel(), axis_name)
    if src and src[0] == i:                       # a fixed point
        return x.detach().clone()
    out = torch.zeros_like(raw)
    host = ax.rules["ppermute"] == "host_send_recv"
    send = _host(raw) if host else raw
    recv = _host_empty(raw.numel()) if host else out
    dist = _dist()
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, send, ax.ranks[dst[0]], ax.group))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv, ax.ranks[src[0]], ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if src and host:
        out.copy_(recv)
    return out.view(x.dtype).reshape(x.shape)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, perm):
        ctx.axis_name, ctx.perm = axis_name, perm
        return _ppermute_raw(x, axis_name, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return _ppermute_raw(g, ctx.axis_name, inv), None, None


def ppermute(x: torch.Tensor, axis_name, perm) -> torch.Tensor:
    """``lax.ppermute(x, axis_name, perm)``: ``perm`` a list of (source,
    destination) axis positions; a position no pair sends to gets zeros.
    The backward sends the cotangent back by the inverse permutation."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if x.requires_grad and torch.is_grad_enabled():
        return _PPermute.apply(x, axis_name, perm)
    return _ppermute_raw(x, axis_name, perm)


def _all_to_all_raw(x: torch.Tensor, axis_name, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` split along
    ``split_axis`` into one chunk a rank, chunk j to position j, and the
    chunks received concatenated along ``concat_axis`` in position
    order."""
    ax = axis(axis_name)
    _check_device(ax, x, "all_to_all")
    n = ax.size
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    chunk = list(x.shape)
    chunk[split_axis] //= n
    # [n, *chunk]: chunk j leads, contiguous, as bytes
    parts = x.detach().reshape(*x.shape[:split_axis], n,
                               chunk[split_axis], *x.shape[split_axis + 1:])
    parts = parts.movedim(split_axis, 0).contiguous()
    raw = parts.reshape(-1).view(torch.uint8)
    record_collective("all_to_all", raw.numel(), axis_name)
    dist = _dist()
    if ax.rules["all_to_all"] == "host_all_to_all":
        send = _host(raw)
        recv = _host_empty(raw.numel())
        dist.all_to_all_single(recv, send, group=ax.group)
        got = recv.to(x.device)
    else:
        got = torch.empty_like(raw)
        dist.all_to_all_single(got, raw, group=ax.group)
    got = got.view(x.dtype).reshape(n, *chunk)
    return torch.cat(list(got.unbind(0)), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis):
        ctx.args = (axis_name, split_axis, concat_axis)
        return _all_to_all_raw(x, axis_name, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis_name, split_axis, concat_axis = ctx.args
        return (_all_to_all_raw(g, axis_name, concat_axis, split_axis),
                None, None, None)


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled ``lax.all_to_all``; its backward is the inverse all-to-all
    (``split_axis`` and ``concat_axis`` exchanged)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _AllToAll.apply(x, axis_name, int(split_axis),
                               int(concat_axis))
    return _all_to_all_raw(x, axis_name, int(split_axis), int(concat_axis))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, groups):
        return grouped_psum(x, axis_name, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, axis_name, groups=None) -> torch.Tensor:
    """The replicated sum over the axis (or this rank's group of
    ``groups``); its backward is the identity (module docstring)."""
    if axis_name is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _PSum.apply(x, axis_name, _canon_groups(groups))
    return grouped_psum(x, axis_name, groups)


def pmean(x: torch.Tensor, axis_name, groups=None) -> torch.Tensor:
    """``psum / size``; the cotangent divided by the size."""
    if axis_name is None:
        return x
    return psum(x, axis_name, groups) / group_size(axis_name, groups)


def _pmax_raw(x: torch.Tensor, axis_name) -> torch.Tensor:
    ax = axis(axis_name)
    _check_device(ax, x, "pmax")
    out = x.detach().clone()
    record_collective("pmax", _nbytes(out), axis_name)
    dist = _dist()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ax.group)
    return out


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        out = _pmax_raw(x, axis_name)
        ctx.axis_name = axis_name
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        hold = (x == out).to(g.dtype)
        ties = grouped_psum(hold, ctx.axis_name)
        return g * hold / torch.clamp(ties, min=1.0), None


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The replicated elementwise maximum over the axis; the cotangent goes
    to the ranks holding the maximum, split evenly among ties."""
    if x.requires_grad and torch.is_grad_enabled():
        return _PMax.apply(x, axis_name)
    return _pmax_raw(x, axis_name)


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return grouped_psum(g, ctx.axis_name), None


def pvary(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Mark a replicated value entering a varying computation: the
    identity forward, a ``psum`` of the cotangent backward (JAX's
    replicated-to-varying cast)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _PVary.apply(x, axis_name)
    return x
