"""Group BatchNorm, NHWC — counterpart of ``apex_tpu/contrib/groupbn``.

The reference's ``BatchNorm2d_NHWC`` (apex/contrib/groupbn/batch_norm.py:
101) exchanges statistics within ``bn_group`` GPUs over CUDA IPC. Here, as
in the JAX package, it is ``SyncBatchNorm`` over channels-last rows with
``bn_group`` mapped to ``axis_index_groups``: the group's statistics are
one all-reduce over its sub-group (``parallel.collectives``).
"""

from __future__ import annotations

from typing import Optional

from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["BatchNorm2d_NHWC", "bn_groups_for"]


def bn_groups_for(world_size: int, bn_group: int):
    """``world_size`` ranks in consecutive groups of ``bn_group``
    (batch_norm.py:103-140's order); ``bn_group`` 1 means no groups."""
    if bn_group <= 1:
        return None
    if world_size % bn_group:
        raise ValueError(f"world_size {world_size} not divisible by "
                         f"bn_group {bn_group}")
    return tuple(tuple(range(i, i + bn_group))
                 for i in range(0, world_size, bn_group))


class BatchNorm2d_NHWC(SyncBatchNorm):
    """NHWC BatchNorm2d with the fused add+ReLU and statistics groups
    (``BatchNorm2d_NHWC(planes, fuse_relu, bn_group, ...)``). ``bn_group``
    above 1 needs ``world_size`` to build the groups, or explicit
    ``axis_index_groups``; ``bn_group`` 1 is per-rank statistics."""

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 bn_group: int = 1, max_cta_per_sm: int = 2,
                 cta_launch_margin: int = 12, multi_stream: bool = False,
                 *, world_size: Optional[int] = None,
                 axis_name: Optional[str] = "data",
                 axis_index_groups=None, eps: float = 1e-5,
                 momentum: Optional[float] = 0.1, **kw):
        # the CUDA launch knobs are accepted at their positions and ignored
        del max_cta_per_sm, cta_launch_margin, multi_stream
        if axis_index_groups is None and bn_group > 1:
            if world_size is None:
                raise ValueError("bn_group > 1 needs world_size (or pass "
                                 "axis_index_groups explicitly)")
            axis_index_groups = bn_groups_for(world_size, bn_group)
        if bn_group <= 1 and axis_index_groups is None:
            axis_name = None
        super().__init__(num_features, eps=eps, momentum=momentum,
                         axis_name=axis_name,
                         axis_index_groups=axis_index_groups,
                         channel_axis=-1, fuse_relu=fuse_relu, **kw)
