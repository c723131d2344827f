"""Overflow provenance — counterpart of the nonfinite census of
``apex_tpu/prof/numerics.py`` (:70-202).

- :func:`grad_census` counts each gradient leaf's infs and NaNs and takes
  its largest finite |g|, on the device, over a gradient tree or a flat
  buffer with its ``SegmentTable``;
- :func:`select_census` keeps, without a host read, the census of the
  last step that overflowed (``torch.where`` on the flag);
- :func:`tree_meta` and :func:`culprit_table` are the host side: the
  leaves' path labels (``a/0/b``, in ``jax.tree_util``'s leaf order,
  dict keys sorted) and the offending leaves named, worst first.

The underflow census comes with the rest of ``prof/``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops import flat as _flat

__all__ = ["TreeMeta", "tree_meta", "GradCensus", "grad_census",
           "empty_census", "select_census", "culprit_table"]


@dataclasses.dataclass(frozen=True)
class TreeMeta:
    """Path labels and element counts of a gradient tree's leaves, in the
    order of a census's entries."""
    paths: tuple
    sizes: tuple

    @property
    def n(self) -> int:
        return len(self.paths)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path) or "<root>"


def tree_meta(tree: Any) -> TreeMeta:
    """The labels of ``tree``: a gradient tree, or a ``SegmentTable`` (the
    flat-master case: labels from the table's own structure and sizes)."""
    if isinstance(tree, _flat.SegmentTable):
        paths, sizes = _flat.tree_paths(tree.treedef), tree.sizes
    else:
        leaves, treedef = _flat.tree_flatten(tree)
        paths = _flat.tree_paths(treedef)
        sizes = tuple(int(leaf.numel()) for leaf in leaves)
    return TreeMeta(paths=tuple(_path_str(p) for p in paths),
                    sizes=tuple(sizes))


def _leaves(grads: Any, table=None) -> list:
    """Per-leaf gradients; a flat buffer is cut back into leaves by its
    table (padding left out, so counts and maxima are per parameter)."""
    if table is not None:
        return [grads[off:off + size]
                for off, size in zip(table.offsets, table.sizes)]
    return _flat.tree_leaves(grads)


@dataclasses.dataclass
class GradCensus:
    """Per-leaf nonfinite census in ``tree_meta`` order; ``step`` is the
    step it was taken at (-1: no overflow seen yet)."""
    inf_count: torch.Tensor   # int32 [n]
    nan_count: torch.Tensor   # int32 [n]
    abs_max: torch.Tensor     # fp32 [n], max |finite|
    step: torch.Tensor        # int32, 0-d


def grad_census(grads: Any, table=None, step=None) -> GradCensus:
    """Per-leaf inf and NaN counts and the largest finite |g| of
    ``grads`` (a tree, or a flat buffer when ``table`` is given), on the
    gradients' device; ``step`` (e.g. ``ScalerState.step_count``) stamps
    it, -1 by default."""
    leaves = _leaves(grads, table)
    dev = leaves[0].device
    infs, nans, maxs = [], [], []
    for g in leaves:
        g32 = g.float()
        infs.append(torch.isinf(g32).sum().to(torch.int32))
        nans.append(torch.isnan(g32).sum().to(torch.int32))
        if g32.numel():
            maxs.append(torch.where(torch.isfinite(g32), g32.abs(),
                                    torch.zeros_like(g32)).amax())
        else:
            maxs.append(torch.zeros((), dtype=torch.float32, device=dev))
    step = torch.as_tensor(-1 if step is None else step, device=dev).to(
        torch.int32)
    return GradCensus(inf_count=torch.stack(infs),
                      nan_count=torch.stack(nans),
                      abs_max=torch.stack(maxs), step=step)


def empty_census(n: int, device=None) -> GradCensus:
    """The carry's start: all zeros, step -1 (no overflow seen yet), on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return GradCensus(
        inf_count=torch.zeros(n, dtype=torch.int32, device=dev),
        nan_count=torch.zeros(n, dtype=torch.int32, device=dev),
        abs_max=torch.zeros(n, dtype=torch.float32, device=dev),
        step=torch.full((), -1, dtype=torch.int32, device=dev))


def select_census(overflow, fresh: GradCensus,
                  carried: GradCensus) -> GradCensus:
    """``fresh`` where ``overflow`` is set, else ``carried``, with no host
    read: after a loop the carry is the census of the last step that
    overflowed."""
    ov = torch.as_tensor(overflow).to(torch.bool)
    return GradCensus(**{
        f.name: torch.where(ov, getattr(fresh, f.name),
                            getattr(carried, f.name))
        for f in dataclasses.fields(GradCensus)})


def culprit_table(meta: TreeMeta, census: GradCensus,
                  top: int = 8) -> list:
    """HOST SIDE: ``[{"path", "inf", "nan", "abs_max"}, ...]`` for the
    leaves with a nonfinite element, worst first (the one read back of
    the provenance path; call it on skipped steps)."""
    inf = census.inf_count.cpu().tolist()
    nan = census.nan_count.cpu().tolist()
    amax = census.abs_max.cpu().tolist()
    bad = [(inf[i] + nan[i], i) for i in range(meta.n) if inf[i] or nan[i]]
    bad.sort(key=lambda t: -t[0])
    return [{"path": meta.paths[i], "inf": int(inf[i]), "nan": int(nan[i]),
             "abs_max": float(amax[i])} for _, i in bad[:top]]
