"""The sharding Plan — counterpart of ``apex_tpu/parallel/plan.py``.

A :class:`Plan` holds what each distributed entry point would otherwise
decide at its call site: the mesh, the per-argument placements and the
donation set; :func:`compile_step_with_plan` is the one place that turns
``(body, plan)`` into a step. Specs are DTensor placements (a tuple of
``Shard``/``Replicate``, one a mesh dimension, as ``mesh.replicated`` and
``mesh.batch_sharded`` give them, or None for replicated), in trees that
may be prefixes of the arguments' trees, as shard_map's specs are.

The three lowerings keep the JAX package's names, so a sidecar's
``plan_compiled`` record reads the same:

- ``"shard_map"`` (``in_specs``/``out_specs``): a per-rank body with
  explicit collectives. An argument that is a ``DTensor`` enters as its
  local shard; a plain tensor is the global value, of which the body gets
  this rank's chunk where its spec shards it. An output with a sharded
  spec comes back as a ``DTensor`` over the local results (no data
  moves); a replicated one as the rank's tensor.
- ``"pjit"`` (``in_shardings``/``out_shardings``): a global-view body on
  ``DTensor`` arguments, whose operators insert the collectives as GSPMD
  does; outputs are redistributed to ``out_shardings``.
- ``"jit"`` (neither): the body as it is, a single-device plan.

Steps run eagerly: there is nothing to compile, so ``donate_argnums`` and
``static_argnums`` are recorded and have no effect, and ``check_vma`` (JAX
autodiff plumbing) is accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

__all__ = ["Plan", "PlanCompilationError", "compile_step_with_plan",
           "place_with_specs"]


class PlanCompilationError(ValueError):
    """A Plan that cannot be lowered, with a remediation hint."""

    def __init__(self, msg: str, hint: str = ""):
        super().__init__(f"{msg}\n  hint: {hint}" if hint else msg)
        self.hint = hint


@dataclasses.dataclass(frozen=True)
class Plan:
    """Mesh + per-argument placements + donation for one step body; one
    spec family describes how the body is written (module docstring)."""

    mesh: Any = None
    in_specs: Any = None
    out_specs: Any = None
    in_shardings: Any = None
    out_shardings: Any = None
    donate_argnums: tuple = ()
    static_argnums: tuple = ()
    check_vma: Optional[bool] = False

    def axes(self) -> dict:
        if self.mesh is None:
            return {}
        return {str(k): int(v) for k, v in zip(self.mesh.mesh_dim_names,
                                                self.mesh.shape)}

    def lowering(self) -> str:
        """``"pjit"`` / ``"shard_map"`` / ``"jit"``."""
        if self.in_shardings is not None or self.out_shardings is not None:
            return "pjit"
        if self.in_specs is not None or self.out_specs is not None:
            return "shard_map"
        return "jit"


# -- spec trees ---------------------------------------------------------------

def _placement_type():
    from torch.distributed.tensor.placement_types import Placement
    return Placement


def _is_spec_leaf(x) -> bool:
    if x is None:
        return True
    Placement = _placement_type()
    if isinstance(x, Placement):
        return True
    return isinstance(x, (tuple, list)) and len(x) > 0 and \
        all(isinstance(p, Placement) for p in x)


def _as_placements(spec, mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    if spec is None:
        return tuple(Replicate() for _ in range(mesh.ndim))
    if isinstance(spec, _placement_type()):
        spec = (spec,)
    spec = tuple(spec)
    if len(spec) != mesh.ndim:
        raise ValueError(f"placements {spec} do not match a mesh of "
                         f"{mesh.ndim} dimensions")
    return spec


def _map_leaves(fn, tree):
    """``fn`` on every tensor leaf of a dict/list/tuple/dataclass tree."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map_leaves(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return fn(tree)


def _map_specs(fn, spec, tree):
    """``fn(spec_leaf, leaf)`` over ``tree`` with ``spec`` a prefix tree
    of it."""
    if _is_spec_leaf(spec):
        return _map_leaves(lambda leaf: fn(spec, leaf), tree)
    if isinstance(spec, dict):
        return {k: _map_specs(fn, spec[k], tree[k]) for k in tree}
    if isinstance(spec, (list, tuple)):
        if len(spec) != len(tree):
            raise ValueError(f"spec tree of {len(spec)} entries does not "
                             f"match an argument tree of {len(tree)}")
        return type(tree)(_map_specs(fn, s, t) for s, t in zip(spec, tree))
    if dataclasses.is_dataclass(spec):
        return type(tree)(**{f.name: _map_specs(fn, getattr(spec, f.name),
                                                getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    raise TypeError(f"not a spec: {spec!r}")


def _distribute(x, mesh, spec):
    import inspect

    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor) or not isinstance(x, torch.Tensor):
        return x
    kw = {}
    if "src_data_rank" in inspect.signature(distribute_tensor).parameters:
        kw["src_data_rank"] = None     # every rank holds the global value
    return distribute_tensor(x, mesh, _as_placements(spec, mesh), **kw)


def place_with_specs(tree: Any, mesh, spec_tree: Any) -> Any:
    """A tree of global tensors as ``DTensor``s placed by a matching tree
    of placements (a ZeRO optimizer's ``state_pspec()``, say)."""
    return _map_specs(lambda s, x: _distribute(x, mesh, s), spec_tree, tree)


def _local(mesh, spec, x):
    """The body's view of one argument: a DTensor's local shard, or this
    rank's chunk of a global tensor along every sharded dimension."""
    import torch
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(x, DTensor):
        return x.to_local()
    if not isinstance(x, torch.Tensor):
        return x
    coord = mesh.get_coordinate()
    for d, p in enumerate(_as_placements(spec, mesh)):
        if isinstance(p, Shard):
            n = mesh.shape[d]
            if x.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not "
                                 f"split over {n} ranks")
            x = x.chunk(n, dim=p.dim)[coord[d]]
    return x


def _from_local(mesh, spec, x):
    import torch
    from torch.distributed.tensor import DTensor, Shard
    pl = _as_placements(spec, mesh)
    if not isinstance(x, torch.Tensor) or \
            not any(isinstance(p, Shard) for p in pl):
        return x
    return DTensor.from_local(x, mesh, pl, run_check=False)


def _redistribute(mesh, spec, x):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, _as_placements(spec, mesh))


def _note_plan(plan: Plan, lowering: str, body_name: str) -> None:
    from apex_tpu_torch.prof import metrics as _telemetry
    _telemetry.note("plan_compiled", body=body_name, lowering=lowering,
                    axes=plan.axes(),
                    donate_argnums=list(plan.donate_argnums))


def compile_step_with_plan(body: Callable, plan: Plan, *,
                           donate_argnums=None,
                           static_argnums=None) -> Callable:
    """``body`` lowered by ``plan`` (module docstring); the returned
    callable takes the body's arguments. ``donate_argnums`` /
    ``static_argnums`` override the plan's (recorded only)."""
    if donate_argnums is not None or static_argnums is not None:
        plan = dataclasses.replace(
            plan,
            donate_argnums=tuple(plan.donate_argnums if donate_argnums is None
                                 else donate_argnums),
            static_argnums=tuple(plan.static_argnums if static_argnums is None
                                 else static_argnums))
    lowering = plan.lowering()
    body_name = getattr(body, "__name__", type(body).__name__)

    if lowering == "pjit":
        if (plan.in_shardings is None) != (plan.out_shardings is None):
            raise PlanCompilationError(
                "compile_step_with_plan requires both in_shardings and "
                "out_shardings for the pjit path",
                "pass both, or use in_specs/out_specs for a per-device "
                "(shard_map) body")
        if plan.mesh is None:
            raise PlanCompilationError(
                "Plan has placement shardings but no mesh",
                "construct the Plan with mesh=make_mesh(...)")
        mesh = plan.mesh

        def global_view(*args):
            args = _map_specs(lambda s, x: _distribute(x, mesh, s),
                              plan.in_shardings, args)
            out = body(*args)
            return _map_specs(lambda s, x: _redistribute(mesh, s, x),
                              plan.out_shardings, out)

        _note_plan(plan, "pjit", body_name)
        return global_view

    if lowering == "shard_map":
        if plan.mesh is None:
            raise PlanCompilationError(
                "Plan has in_specs/out_specs but no mesh",
                "construct the Plan with mesh=make_mesh(...)")
        if plan.in_specs is None or plan.out_specs is None:
            raise PlanCompilationError(
                "the shard_map path needs both in_specs and out_specs",
                "pass both (out_specs replicated(mesh) for replicated "
                "outputs)")
        mesh = plan.mesh

        def per_rank(*args):
            args = _map_specs(lambda s, x: _local(mesh, s, x),
                              plan.in_specs, args)
            out = body(*args)
            return _map_specs(lambda s, x: _from_local(mesh, s, x),
                              plan.out_specs, out)

        _note_plan(plan, "shard_map", body_name)
        return per_rank

    _note_plan(plan, "jit", body_name)
    return body
