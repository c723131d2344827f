"""Parallelism on ``torch.distributed`` (counterpart of
``apex_tpu/parallel``): ``launch.initialize`` joins the process group,
``make_mesh`` names its axes, ``DistributedDataParallel`` / ``Reducer``
average gradients, ``SyncBatchNorm`` syncs statistics (``convert_syncbn_model``,
``create_syncbn_process_group``), ``Plan`` / ``compile_step_with_plan``
lower a step body, ``ulysses_attention`` / ``merge_partials`` and the
submodule ``ring_attention`` (whose ``ring_attention`` is the ring) shard
the sequence, and ``gpipe`` / ``stack_layers`` / ``unstack_layers``
pipeline the layers. Tensor parallelism is not ported yet (ROADMAP.md
Queue 1, item 20). Names import lazily."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "DATA_AXIS": "mesh", "MODEL_AXIS": "mesh", "PIPE_AXIS": "mesh",
    "SEQ_AXIS": "mesh", "batch_sharded": "mesh",
    "local_device_count": "mesh", "make_mesh": "mesh",
    "replicated": "mesh", "subgroups": "mesh",
    "Plan": "plan", "PlanCompilationError": "plan",
    "compile_step_with_plan": "plan", "place_with_specs": "plan",
    "DistributedDataParallel": "distributed", "Reducer": "distributed",
    "broadcast_params": "distributed", "flat_dist_call": "distributed",
    "SyncBatchNorm": "sync_batchnorm",
    "ulysses_attention": "ring_attention", "merge_partials": "ring_attention",
    "gpipe": "pipeline", "stack_layers": "pipeline",
    "unstack_layers": "pipeline",
}
_SUBMODULES = ("launch", "multiproc", "collectives", "mesh", "plan",
               "distributed", "sync_batchnorm", "pipeline",
               "ring_attention")

__all__ = sorted([*_EXPORTS, "LARC", "convert_syncbn_model",
                  "create_syncbn_process_group", "launch"])


def __getattr__(name: str):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name == "LARC":
        from apex_tpu_torch.optimizers.larc import LARC
        return LARC
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def convert_syncbn_model(model, process_group=None, channel_last=False, *,
                         axis_name: str = "data", axis_index_groups=None):
    """A copy of ``model`` with every BatchNorm synced over ``axis_name``
    (the reference's ``convert_syncbn_model``, apex/parallel/__init__.py:
    21-56, in its positional order): the model must expose
    ``replace(bn_axis_name=..., bn_axis_index_groups=...)``, as
    ``models.ResNet`` does. ``process_group`` is
    ``create_syncbn_process_group``'s result (``axis_index_groups``);
    ``channel_last`` is accepted and ignored (the BNs take their layout
    from the model)."""
    del channel_last
    if isinstance(process_group, str):
        raise TypeError(
            f"process_group must be a sequence of rank groups, got "
            f"{process_group!r}; axis_name is keyword-only")
    groups = axis_index_groups if axis_index_groups is not None \
        else process_group
    if hasattr(model, "replace"):
        return model.replace(bn_axis_name=axis_name,
                             bn_axis_index_groups=groups)
    raise TypeError(
        f"{type(model).__name__} does not expose .replace(...); give your "
        f"model a config-rebuild method or construct it with "
        f"bn_axis_name={axis_name!r} directly")


def create_syncbn_process_group(group_size: int, axis_size: int = None):
    """``axis_index_groups`` of contiguous ranks for SyncBatchNorm
    (apex/parallel/__init__.py:58-95); ``axis_size`` defaults to the
    world's size. ``group_size`` 0 means no groups (None)."""
    if axis_size is None:
        import torch.distributed as dist
        axis_size = dist.get_world_size()
    if group_size == 0:
        return None
    from apex_tpu_torch.parallel.mesh import subgroups
    return subgroups(axis_size, group_size)
