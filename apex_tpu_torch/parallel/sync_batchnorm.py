"""SyncBatchNorm — counterpart of ``apex_tpu/parallel/sync_batchnorm.py``.

Training mode is a ``torch.autograd.Function`` with the JAX package's
hand-written backward on its welford-kernel route (``_use_pallas_bn``,
sync_batchnorm.py:144-162). Its forward is ``_bn_train_fwd_math``
(:165-222): the per-channel fp32 sums of x and x² from ``bn_moments``,
biased variance, and the normalize-apply folded into a per-channel scale
and shift, with the residual ``z`` and the relu fused (plain PyTorch, as
the JAX package leaves it to XLA). It saves what :232-245 saves: the
input, weight, bias, mean and invvar, and the output as the relu mask.
Its backward is ``_bn_train_bwd_out`` (:257-352): per-channel sum(dy) and
sum(dy·xhat) from ``bn_backward_fused_reduce``, then dx and dz (the
masked dy) from ``bn_backward_dx``, and the weight and bias grads in
their own dtypes.

The three passes are ``ops.welford``'s wrappers over ``[N·H·W, C]`` rows:
hand CUDA kernels on the card, their plain versions on the CPU. Not
``F.batch_norm`` or cuDNN.

Cross-replica statistics (``axis_name``, and ``axis_index_groups`` for
the sub-groups of ``create_syncbn_process_group``): the local (Σx, Σx²)
from ``bn_moments`` are summed over the group in one all-reduce
(``collectives.grouped_psum``) before the mean and variance; in the
backward, the local (Σdy, Σdy·xhat) from ``bn_backward_fused_reduce`` are
summed over the group in one all-reduce before ``bn_backward_dx``. The
running variance is unbiased with the group's count. The ranks of a group
hold batches of one shape, as shard_map's shards do, so the group's count
is the local count times the group's size, a host number (the JAX
package sums the count over the group, :165-218, and gets the same):
the step reads nothing back from the card for it.

The weight and bias gradients stay local: the JAX package sums them over
the whole axis inside the vjp only when vma tracking is on (``_for_param``,
:319-333), and under ``check_vma=False`` leaves them to
``DistributedDataParallel``; in torch every gradient is local, so DDP is
the one place they are reduced (a sum here too would double them).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp.autocast import custom_grad
from apex_tpu_torch.ops import welford as WF
from apex_tpu_torch.parallel import collectives as _C

__all__ = ["SyncBatchNorm", "bn_train"]


def _bcast_shape(ndim: int, channel_axis: int, c: int) -> tuple:
    ca = channel_axis % ndim
    return tuple(c if i == ca else 1 for i in range(ndim))


def _rows(t: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """``[N·spatial, C]`` rows of ``t``: a view for channels-last memory
    (NHWC, or NCHW in channels_last), else a copy."""
    return t.movedim(channel_axis, -1).reshape(-1, t.shape[channel_axis])


def _group_sums(a, b, axis):
    """``(Σ_group a, Σ_group b)`` in one all-reduce; ``axis`` None keeps
    them local."""
    if axis is None:
        return a, b
    both = _C.grouped_psum(torch.cat([a, b]), axis[0], axis[1])
    return both[:a.numel()], both[a.numel():]


def _bn_train_fwd_math(x, z, weight, bias, eps, fuse_relu, channel_axis,
                       axis=None):
    ndim = x.dim()
    c = x.shape[channel_axis % ndim]
    bshape = _bcast_shape(ndim, channel_axis, c)
    count = _count(x, channel_axis, axis)
    lsum, lsq = _group_sums(*WF.bn_moments(_rows(x, channel_axis % ndim)),
                            axis)
    mean = lsum / count
    mean_sq = lsq / count
    var = mean_sq - torch.square(mean)        # biased
    invvar = torch.rsqrt(var + eps)
    # normalize-apply reads the original x through a per-channel scale and
    # shift, as the JAX package folds it (sync_batchnorm.py:204-217)
    scale = invvar
    if weight is not None:
        scale = scale * weight.float()
    shift = -mean * scale
    if bias is not None:
        shift = shift + bias.float()
    out = x * scale.reshape(bshape) + shift.reshape(bshape)
    if z is not None:
        out = out + z.float()
    if fuse_relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(x.dtype), mean, var, invvar, count


def _count(x, channel_axis, axis) -> float:
    """Values a channel over the group: the local count times the group's
    size (the ranks' batches have one shape)."""
    c = x.shape[channel_axis % x.dim()]
    local = float(x.numel() // c) if c else 0.0
    if axis is None:
        return local
    return local * _C.group_size(axis[0], axis[1])


class _BNTrain(torch.autograd.Function):
    """Training-mode BN with the JAX package's backward; ``mean`` and
    ``var`` are outputs for the running-stat update only. ``axis`` is
    None (local statistics) or ``(axis_name, axis_index_groups)``."""

    @staticmethod
    def forward(ctx, x, z, weight, bias, eps, fuse_relu, channel_axis,
                axis=None):
        out, mean, var, invvar, count = _bn_train_fwd_math(
            x, z, weight, bias, eps, fuse_relu, channel_axis, axis)
        ctx.save_for_backward(x, weight, bias, mean, invvar,
                              out if fuse_relu else None)
        ctx.has_z = z is not None
        ctx.count = count
        ctx.fuse_relu = fuse_relu
        ctx.channel_axis = channel_axis
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _d_mean, _d_var):
        x, weight, bias, mean, invvar, out = ctx.saved_tensors
        ca = ctx.channel_axis % x.dim()
        x2, dy2 = _rows(x, ca), _rows(dy, ca)
        out2 = _rows(out, ca) if ctx.fuse_relu else None
        sum_dy, sum_dy_xhat = WF.bn_backward_fused_reduce(dy2, x2, mean,
                                                          invvar, out2)
        grad_weight = (sum_dy_xhat.to(weight.dtype)
                       if weight is not None else None)
        grad_bias = sum_dy.to(bias.dtype) if bias is not None else None
        sum_dy, sum_dy_xhat = _group_sums(sum_dy, sum_dy_xhat, ctx.axis)
        mean_dy = sum_dy / ctx.count
        mean_dy_xhat = sum_dy_xhat / ctx.count
        wvec = (weight.float() if weight is not None
                else torch.ones_like(invvar))
        dx2, dz2 = WF.bn_backward_dx(dy2, x2, mean, invvar, invvar * wvec,
                                     mean_dy, mean_dy_xhat, out2,
                                     emit_dz=ctx.has_z)

        def back(t2):       # [rows, C] -> x's shape and channel position
            return t2.view(x.movedim(ca, -1).shape).movedim(-1, ca)
        dz = back(dz2) if ctx.has_z else None
        return (back(dx2), dz, grad_weight, grad_bias, None, None, None,
                None)


@custom_grad
def bn_train(x, z, weight, bias, eps: float, fuse_relu: bool,
             channel_axis: int, axis_name: Optional[str] = None,
             groups=None):
    """Training-mode BN: ``(out, mean, var, count)`` with ``count`` the
    number of values per channel over the group (a Python float)."""
    axis = None if axis_name is None else (axis_name, groups)
    out, mean, var = _BNTrain.apply(x, z, weight, bias, eps, fuse_relu,
                                    channel_axis, axis)
    return out, mean, var, _count(x, channel_axis, axis)


class SyncBatchNorm:
    """Counterpart of ``apex_tpu.parallel.SyncBatchNorm`` (functional:
    ``init`` returns ``(params, state)``, ``apply`` returns ``(out,
    new_state)``). ``axis_name`` (default ``"data"``, bound by
    ``parallel.make_mesh``) syncs the statistics over that axis, or over
    the rank's group of ``axis_index_groups`` (``process_group``, the
    reference's name, is the same); ``axis_name=None`` is local
    BatchNorm. ``momentum=None`` is a cumulative average."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: Optional[float] = 0.1, affine: bool = True,
                 track_running_stats: bool = True, process_group=None,
                 channel_last: Optional[bool] = None,
                 fuse_relu: bool = False, *,
                 axis_name: Optional[str] = "data", axis_index_groups=None,
                 channel_axis: int = -1, param_dtype=torch.float32):
        if process_group is not None:
            if isinstance(process_group, str):
                # the 6th positional was axis_name once: a stale caller
                # must fail, not get its name split into "groups"
                raise TypeError(
                    f"process_group must be a sequence of rank groups "
                    f"(create_syncbn_process_group result), got "
                    f"{process_group!r}; axis_name is keyword-only "
                    f"(axis_name={process_group!r})")
            if axis_index_groups is not None:
                raise ValueError(
                    "pass process_group OR axis_index_groups, not both")
            axis_index_groups = process_group
        if channel_last is not None:
            channel_axis = -1 if channel_last else 1
        self.num_features = int(num_features)
        self.eps = float(eps)
        self.momentum = momentum
        self.affine = bool(affine)
        self.track_running_stats = bool(track_running_stats)
        self.axis_name = axis_name
        self.axis_index_groups = (tuple(tuple(g) for g in axis_index_groups)
                                  if axis_index_groups else None)
        self.channel_axis = int(channel_axis)
        self.fuse_relu = bool(fuse_relu)
        self.param_dtype = param_dtype

    def init(self, device=None) -> tuple:
        """``(params, state)`` on ``device`` (the card unless "cpu")."""
        dev = resolve_device(device)
        params, state = {}, {}
        c = self.num_features
        if self.affine:
            params = {"weight": torch.ones(c, dtype=self.param_dtype,
                                           device=dev),
                      "bias": torch.zeros(c, dtype=self.param_dtype,
                                          device=dev)}
        if self.track_running_stats:
            state = {"running_mean": torch.zeros(c, device=dev),
                     "running_var": torch.ones(c, device=dev),
                     "num_batches_tracked": torch.zeros(
                         (), dtype=torch.int32, device=dev)}
        return params, state

    def apply(self, params: dict, state: dict, x, z=None,
              training: bool = True) -> tuple:
        w = params.get("weight") if self.affine else None
        b = params.get("bias") if self.affine else None

        if not training and self.track_running_stats:
            bshape = _bcast_shape(x.dim(), self.channel_axis,
                                  self.num_features)
            inv = torch.rsqrt(state["running_var"] + self.eps)
            scale = inv if w is None else inv * w.float()
            shift = -state["running_mean"] * scale
            if b is not None:
                shift = shift + b.float()
            out = x * scale.reshape(bshape) + shift.reshape(bshape)
            if z is not None:
                out = out + z.float()
            if self.fuse_relu:
                out = torch.clamp_min(out, 0.0)
            return out.to(x.dtype), state

        out, mean, var, count = bn_train(x, z, w, b, self.eps,
                                         self.fuse_relu, self.channel_axis,
                                         self.axis_name,
                                         self.axis_index_groups)
        if not self.track_running_stats:
            return out, state
        # running stats are buffers: new tensors from the detached batch
        # statistics, unbiased with the group's count
        # (sync_batchnorm.py:476-490)
        unbiased = var * (count / max(count - 1.0, 1.0))
        tracked = state["num_batches_tracked"] + 1
        m = (1.0 / tracked.float() if self.momentum is None
             else self.momentum)
        new_state = {
            "running_mean": (1 - m) * state["running_mean"] + m * mean,
            "running_var": (1 - m) * state["running_var"] + m * unbiased,
            "num_batches_tracked": tracked,
        }
        return out, new_state

    def __call__(self, params, state, x, **kw):
        return self.apply(params, state, x, **kw)
