"""Flat parameter store — counterpart of ``apex_tpu/ops/flat.py``.

One contiguous buffer per (role, dtype) — master params, grads, optimizer
slots — plus a static ``SegmentTable`` that maps each parameter to an
aligned slice of it. Segments are padded with zeros to ``align`` elements
(default 128), so seen as ``(rows, 128)`` a row never holds two
parameters: per-tensor reductions are a pass over rows plus a sum over
each segment's contiguous row range.

Leaf order is ``jax.tree_util``'s (dict keys sorted, lists and tuples in
order, ``None`` an empty subtree), kept by the small tree walker below, so
a buffer of the JAX package and one of the port hold the same element at
the same offset.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch

__all__ = ["DEFAULT_ALIGN", "LANES", "SegmentTable", "make_table", "flatten",
           "unflatten", "zeros_like_flat", "tree_flatten", "tree_unflatten",
           "tree_paths", "tree_leaves", "tree_map"]

DEFAULT_ALIGN = 128
LANES = 128           # row width of the (rows, 128) view the kernels take

_LEAF = "*"


# -- tree walker (jax.tree_util order) ----------------------------------------

def tree_flatten(tree: Any) -> tuple[list, Any]:
    """Leaves in ``jax.tree_util`` order, and a hashable structure."""
    leaves: list = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, len(node),
                    tuple(walk(c) for c in node))
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == _LEAF:
            return next(it)
        kind = d[0]
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        children = [build(c) for c in d[2]]
        return tuple(children) if kind == "tuple" else children

    return build(treedef)


def tree_paths(treedef: Any) -> list:
    """The key path of each leaf of a ``tree_flatten`` structure, in leaf
    order: a tuple of dict keys and list or tuple indices."""
    if treedef is None:
        return []
    if treedef == _LEAF:
        return [()]
    kind, keys, children = treedef
    if kind != "dict":
        keys = range(keys)
    return [(k,) + p for k, c in zip(keys, children) for p in tree_paths(c)]


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


# -- the table ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentTable:
    """Where each leaf lives in the flat buffer; all Python ints and
    tuples, so it is hashable and its device-side index vectors are
    cached per device."""

    treedef: Any
    shapes: tuple
    sizes: tuple           # exact element counts
    offsets: tuple         # aligned start offsets
    padded_sizes: tuple    # sizes rounded up to align
    total: int             # buffer length
    align: int

    @property
    def num_segments(self) -> int:
        return len(self.sizes)

    @property
    def row_aligned(self) -> bool:
        """Every segment starts and ends on a 128-element row boundary."""
        return self.align % LANES == 0

    def segment_ids(self, device=None) -> torch.Tensor:
        """int32 [total]: the segment of every element, padding included."""
        return self._segment_ids(torch.device(device or "cpu"))

    @functools.lru_cache(maxsize=None)
    def _segment_ids(self, device: torch.device) -> torch.Tensor:
        ids = torch.repeat_interleave(
            torch.arange(self.num_segments, dtype=torch.int32),
            torch.tensor(self.padded_sizes, dtype=torch.int64))
        return ids.to(device)

    def valid_mask(self, device=None) -> torch.Tensor:
        """bool [total]: True on real elements, False on padding."""
        mask = torch.zeros(self.total, dtype=torch.bool)
        for off, size in zip(self.offsets, self.sizes):
            mask[off:off + size] = True
        return mask.to(device or "cpu")

    def row_counts(self) -> tuple:
        """Rows of 128 elements in each segment (needs ``row_aligned``)."""
        if not self.row_aligned:
            raise ValueError(f"align {self.align} is not a multiple of "
                             f"{LANES}: a row may straddle two segments")
        return tuple(p // LANES for p in self.padded_sizes)

    def row_segment_ids(self, device=None) -> torch.Tensor:
        """int32 [total // 128]: the segment of every row
        (``row_segment_ids``, apex_tpu/ops/pallas/multi_tensor.py:240)."""
        return self._row_segment_ids(torch.device(device or "cpu"))

    @functools.lru_cache(maxsize=None)
    def _row_segment_ids(self, device: torch.device) -> torch.Tensor:
        ids = torch.repeat_interleave(
            torch.arange(self.num_segments, dtype=torch.int32),
            torch.tensor(self.row_counts(), dtype=torch.int64))
        return ids.to(device)

    @functools.lru_cache(maxsize=None)
    def row_lengths(self, device: torch.device) -> torch.Tensor:
        """int64 rows of each segment, for a sum over each segment's
        contiguous row range."""
        return torch.tensor(self.row_counts(), dtype=torch.int64).to(device)


def _round_up(n: int, align: int) -> int:
    return ((n + align - 1) // align) * align


def make_table(tree: Any, align: int = DEFAULT_ALIGN) -> SegmentTable:
    """The segment table of a tree of arrays or tensors (values unused)."""
    leaves, treedef = tree_flatten(tree)
    shapes, sizes, offsets, padded = [], [], [], []
    cursor = 0
    for leaf in leaves:
        shape = _shape(leaf)
        size = math.prod(shape)
        psz = _round_up(max(size, 1), align)
        shapes.append(shape)
        sizes.append(size)
        offsets.append(cursor)
        padded.append(psz)
        cursor += psz
    return SegmentTable(treedef=treedef, shapes=tuple(shapes),
                        sizes=tuple(sizes), offsets=tuple(offsets),
                        padded_sizes=tuple(padded), total=cursor, align=align)


def flatten(tree: Any, table: Optional[SegmentTable] = None,
            dtype: Optional[torch.dtype] = None,
            align: int = DEFAULT_ALIGN) -> tuple[torch.Tensor, SegmentTable]:
    """Pack a tree of tensors into one zero-padded flat buffer on the
    leaves' device; ``dtype`` defaults to the first leaf's."""
    if table is None:
        table = make_table(tree, align=align)
    leaves = tree_leaves(tree)
    if len(leaves) != table.num_segments:
        raise ValueError(
            f"tree has {len(leaves)} leaves but table describes "
            f"{table.num_segments} segments — was the table built for this "
            f"tree?")
    for i, leaf in enumerate(leaves):
        size = math.prod(_shape(leaf))
        if size != table.sizes[i]:
            raise ValueError(f"leaf {i} has {size} elements but table "
                             f"segment {i} expects {table.sizes[i]}")
    if not leaves:
        return torch.zeros(0, dtype=dtype or torch.float32), table
    leaves = [torch.as_tensor(x) for x in leaves]
    if dtype is None:
        dtype = leaves[0].dtype
    out = torch.zeros(table.total, dtype=dtype, device=leaves[0].device)
    for leaf, off, size in zip(leaves, table.offsets, table.sizes):
        out[off:off + size] = leaf.reshape(-1)
    return out, table


class _Unflatten(torch.autograd.Function):
    """One cast of the flat buffer, then a view per leaf. The backward is
    pinned to one flatten (a zeroed buffer, one copy per leaf, one cast)
    as the JAX package pins its transpose (flat.py:167-207); autograd's own
    rule would add one full-size zero buffer per leaf."""

    @staticmethod
    def forward(ctx, flat, table, dtype):
        ctx.table = table
        ctx.in_dtype = flat.dtype
        src = flat if dtype is None else flat.to(dtype)
        return tuple(src[off:off + size].view(shape) for shape, size, off
                     in zip(table.shapes, table.sizes, table.offsets))

    @staticmethod
    def backward(ctx, *grads):
        table = ctx.table
        real = [g for g in grads if g is not None]
        dt = functools.reduce(torch.promote_types,
                              [g.dtype for g in real], real[0].dtype) \
            if real else ctx.in_dtype
        dev = real[0].device if real else None
        buf = torch.zeros(table.total, dtype=dt, device=dev)
        for g, off, size in zip(grads, table.offsets, table.sizes):
            if g is not None:
                buf[off:off + size] = g.reshape(-1)
        return buf.to(ctx.in_dtype), None, None


def unflatten(flat: torch.Tensor, table: SegmentTable,
              dtype: Optional[torch.dtype] = None) -> Any:
    """The tree back from a flat buffer; with ``dtype``, one cast of the
    whole buffer first. Differentiable back to ``flat`` (the padding's
    gradient is zero)."""
    if flat.dim() != 1 or flat.numel() != table.total:
        raise ValueError(f"flat buffer must be 1-D of {table.total} "
                         f"elements, got shape {tuple(flat.shape)}")
    if table.num_segments == 0:
        return tree_unflatten(table.treedef, [])
    leaves = _Unflatten.apply(flat, table, dtype)
    return tree_unflatten(table.treedef, leaves)


def zeros_like_flat(table: SegmentTable, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    return torch.zeros(table.total, dtype=dtype, device=device)
