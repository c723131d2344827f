"""Overflow provenance and the underflow census — counterpart of
``apex_tpu/prof/numerics.py``.

- :func:`grad_census` counts each gradient leaf's infs and NaNs and takes
  its largest finite |g|, on the device, over a gradient tree or a flat
  buffer with its ``SegmentTable``;
- :func:`select_census` keeps, without a host read, the census of the
  last step that overflowed (``torch.where`` on the flag);
- :func:`tree_meta` and :func:`culprit_table` are the host side: the
  leaves' path labels (``a/0/b``, in ``jax.tree_util``'s leaf order,
  dict keys sorted) and the offending leaves named, worst first;
- :func:`underflow_census` (:199-270) counts, per leaf, the nonzero
  gradients below fp16's smallest normal and below its flush-to-zero
  floor and the exact zeros, with a log2-magnitude histogram anchored on
  fp16's landmarks (``HIST_EDGES_LOG2``) and the global L2 norm, on the
  device; :func:`underflow_summary` renders it on the host. It reads every
  gradient element, so callers sample it (DCGAN's ``--numerics`` takes it
  once, of the final G grads).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops import flat as _flat

__all__ = ["FP16_TINY", "FP16_FTZ", "HIST_EDGES_LOG2",
           "hist_labels", "TreeMeta", "tree_meta", "GradCensus",
           "grad_census", "empty_census", "select_census", "culprit_table",
           "UnderflowCensus", "underflow_census", "underflow_summary"]

FP16_TINY = 2.0 ** -14           # smallest normal fp16
FP16_FTZ = 2.0 ** -24            # below this, fp16 flushes to zero

# log2-magnitude histogram edges on fp16's landmarks: the flush-to-zero
# floor, the normal floor, 1.0 and the overflow ceiling (2^16 > 65504,
# fp16's largest finite value)
HIST_EDGES_LOG2 = (-24.0, -14.0, -8.0, -4.0, 0.0, 4.0, 8.0, 16.0)


def hist_labels() -> tuple:
    """The histogram's bin labels (one more than the edges)."""
    labels = [f"<2^{HIST_EDGES_LOG2[0]:g}"]
    for lo, hi in zip(HIST_EDGES_LOG2, HIST_EDGES_LOG2[1:]):
        labels.append(f"[2^{lo:g},2^{hi:g})")
    labels.append(f">=2^{HIST_EDGES_LOG2[-1]:g}")
    return tuple(labels)


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


@dataclasses.dataclass
class UnderflowCensus:
    """Per-leaf underflow counts in ``tree_meta`` order, a global
    log2-magnitude histogram of the nonzero gradients and the global L2
    norm. Counts, not fractions, so rates aggregate exactly on the host."""
    tiny_count: torch.Tensor   # int32 [n], nonzero |g| < FP16_TINY
    ftz_count: torch.Tensor    # int32 [n], nonzero |g| < FP16_FTZ
    zero_count: torch.Tensor   # int32 [n], exact zeros
    hist: torch.Tensor         # int32 [len(HIST_EDGES_LOG2) + 1]
    grad_norm: torch.Tensor    # fp32, 0-d, accumulated in fp32


def underflow_census(grads: Any, table=None) -> UnderflowCensus:
    """The underflow census of ``grads`` (a tree, or a flat buffer when
    ``table`` is given) on the gradients' device (numerics.py:216-246)."""
    leaves = _leaves(grads, table)
    dev = leaves[0].device
    edges = torch.tensor(HIST_EDGES_LOG2, dtype=torch.float32, device=dev)
    nbins = len(HIST_EDGES_LOG2) + 1
    tiny, ftz, zero = [], [], []
    hist = torch.zeros(nbins, dtype=torch.int32, device=dev)
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    for g in leaves:
        mag = g.float().abs().reshape(-1)
        nz = mag > 0.0
        tiny.append((nz & (mag < FP16_TINY)).sum().to(torch.int32))
        ftz.append((nz & (mag < FP16_FTZ)).sum().to(torch.int32))
        zero.append((~nz).sum().to(torch.int32))
        sq = sq + torch.sum(torch.square(mag))
        # log2(0) is -inf: the zeros go to an extra bin, dropped after;
        # integer adds, so the counts are exact in any order
        log2m = torch.log2(torch.where(nz, mag, torch.ones_like(mag)))
        idx = torch.searchsorted(edges, log2m, right=True)
        idx = torch.where(nz, idx, torch.full_like(idx, nbins))
        counts = torch.zeros(nbins + 1, dtype=torch.int64, device=dev)
        counts.scatter_add_(0, idx, torch.ones_like(idx))
        hist = hist + counts[:nbins].to(torch.int32)
    return UnderflowCensus(tiny_count=torch.stack(tiny),
                           ftz_count=torch.stack(ftz),
                           zero_count=torch.stack(zero), hist=hist,
                           grad_norm=torch.sqrt(sq))


def underflow_summary(meta: TreeMeta, census: UnderflowCensus,
                      top: int = 5) -> dict:
    """HOST SIDE: a census as the fields of a ``numerics`` record: global
    fractions over the nonzero magnitudes, the labelled histogram and the
    worst leaves by their fp16-tiny fraction (numerics.py:249-270)."""
    import numpy as np
    tiny = census.tiny_count.cpu().numpy().astype(np.int64)
    ftz = census.ftz_count.cpu().numpy().astype(np.int64)
    zero = census.zero_count.cpu().numpy().astype(np.int64)
    sizes = np.asarray(meta.sizes, np.int64)
    nnz = np.maximum(sizes - zero, 1)
    total_nnz = int(max((sizes - zero).sum(), 1))
    worst = sorted(range(meta.n), key=lambda i: -tiny[i] / nnz[i])[:top]
    return {
        "grad_norm": float(census.grad_norm),
        "tiny_frac": round(float(tiny.sum()) / total_nnz, 6),
        "ftz_frac": round(float(ftz.sum()) / total_nnz, 6),
        "zero_frac": round(float(zero.sum()) / max(int(sizes.sum()), 1), 6),
        "hist": {label: int(c) for label, c in
                 zip(hist_labels(), census.hist.cpu().tolist())},
        "worst": [{"path": meta.paths[i],
                   "tiny_frac": round(float(tiny[i]) / int(nnz[i]), 6)}
                  for i in worst if tiny[i] > 0],
    }
