"""Device meshes — counterpart of ``apex_tpu/parallel/mesh.py``.

The JAX package's substrate is a ``jax.sharding.Mesh`` whose named axes
play the role of process groups. The port's is
``torch.distributed.device_mesh``: :func:`make_mesh` lays the ranks of the
initialized process group out as a ``DeviceMesh`` with the same names and
the same ``-1`` rule, and binds each dimension's process group to its name
(``collectives.bind_axis``), so ``SyncBatchNorm(axis_name="data")``,
``DistributedDataParallel`` and ZeRO find it. A rank is a device: one
process a card (or, over gloo, a CPU process).

:func:`replicated` and :func:`batch_sharded` are DTensor placements
(``Replicate()`` / ``Shard(0)``, one a mesh dimension). Not ported:
``pin_cpu_devices``, JAX plumbing for virtual CPU devices (a CPU rank is a
process here).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from apex_tpu_torch.parallel import collectives as _C

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "make_mesh",
           "resolve_axis_sizes", "replicated", "batch_sharded", "placements",
           "subgroups", "local_device_count"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"


def resolve_axis_sizes(axis_sizes: Optional[dict], n: int) -> dict:
    """``{name: size}`` with the one ``-1`` resolved against ``n`` ranks;
    the errors of mesh.py:58-97."""
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    total = math.prod(sizes)
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    return dict(zip(names, (int(s) for s in sizes)))


def make_mesh(axis_sizes: Optional[dict] = None,
              devices: Optional[Sequence[int]] = None, *, device=None):
    """A ``DeviceMesh`` from ``{axis_name: size}`` over the world's ranks
    (or the global ranks ``devices``), on the card unless
    ``device="cpu"``. ``make_mesh()`` is a 1-D data mesh of every rank; a
    size of -1 (at most one) takes the ranks left over. Every rank must
    call it, after ``launch.initialize``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from apex_tpu_torch._device import resolve_device
    n = len(devices) if devices is not None else None
    if n is None:
        if not dist.is_initialized():
            raise RuntimeError(
                "make_mesh needs an initialized process group: call "
                "apex_tpu_torch.parallel.launch.initialize(...) first")
        n = dist.get_world_size()
    sizes = resolve_axis_sizes(axis_sizes, n)
    names = tuple(sizes)
    shape = tuple(sizes.values())
    dev_type = resolve_device(device).type
    if devices is None:
        mesh = init_device_mesh(dev_type, shape, mesh_dim_names=names)
    else:
        mesh = DeviceMesh(dev_type, torch.tensor(list(devices)).reshape(
            shape), mesh_dim_names=names)
    for d, name in enumerate(names):
        rows = mesh.mesh.movedim(d, -1).reshape(-1, shape[d]).tolist()
        _C.bind_axis(name, mesh.get_group(name), device_type=dev_type,
                     rows=rows)
    from apex_tpu_torch.prof import metrics as _telemetry
    _telemetry.note("mesh_created", axes=dict(sizes), devices=n,
                    platform=dev_type)
    return mesh


def placements(mesh, spec: dict) -> tuple:
    """DTensor placements, one a mesh dimension, from ``{axis_name:
    tensor_dim}`` (the sharded axes; every other dimension replicates)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    for a in spec:
        if a not in names:
            raise ValueError(f"axis {a!r} is not a dimension of the mesh "
                             f"{names}")
    return tuple(Shard(spec[a]) if a in spec else Replicate()
                 for a in names)


def replicated(mesh) -> tuple:
    return placements(mesh, {})


def batch_sharded(mesh, axis: str = DATA_AXIS) -> tuple:
    """Shard the leading (batch) dim over ``axis``."""
    return placements(mesh, {axis: 0})


def subgroups(axis_size: int, group_size: int) -> list:
    """Partition an axis into contiguous groups of ``group_size`` (the
    ``axis_index_groups`` of ``create_syncbn_process_group``)."""
    if group_size <= 0 or axis_size % group_size:
        raise ValueError(
            f"axis size {axis_size} not divisible by group_size {group_size}")
    return [list(range(i, i + group_size))
            for i in range(0, axis_size, group_size)]


def local_device_count() -> int:
    """The cards this host has."""
    import torch
    return torch.cuda.device_count()
