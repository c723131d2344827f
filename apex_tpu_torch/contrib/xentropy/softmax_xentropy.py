"""Softmax cross-entropy with label smoothing — counterpart of
``apex_tpu/contrib/xentropy/softmax_xentropy.py``.

``softmax_cross_entropy_loss`` is a ``torch.autograd.Function`` whose
forward is the ``xent_fwd`` kernel and whose backward is the ``xent_bwd``
kernel (``ops/xentropy.py``; the plain versions for CPU tensors). Its
residuals are the logits, the fp32 per-row logsumexp and the labels,
never the [N, V] softmax (softmax_xentropy.py:86-93): the backward
recomputes the probabilities from the logsumexp.

  loss_i = lse_i − (1−ε)·x_i[y_i] − ε·mean_j(x_ij)
  dx_ij  = g_i·(softmax_ij − (1−ε)·1[j = y_i] − ε/V)

Rows whose label is ``padding_idx`` (default 0, as the reference; None
masks nothing) get zero loss and zero gradient, applied here in the
wrapper as the JAX package applies it. ``select_label_logits`` (the RN50
loss's label pick) is ``ops.xentropy.label_logits``.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.amp.autocast import custom_grad
from apex_tpu_torch.ops import xentropy as XE

__all__ = ["select_label_logits", "softmax_cross_entropy_loss",
           "SoftmaxCrossEntropyLoss"]


# the RN50 loss's label pick: one copy, with the kernels' convention for a
# label outside [0, V)
select_label_logits = XE.label_logits


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx):
        v = logits.shape[-1]
        losses, lse = XE.xent_fwd(logits.reshape(-1, v),
                                  labels.reshape(-1), smoothing)
        losses = losses.reshape(labels.shape)
        if padding_idx is not None:
            losses = torch.where(labels == padding_idx,
                                 torch.zeros_like(losses), losses)
        ctx.save_for_backward(logits, lse, labels)
        ctx.cfg = (smoothing, padding_idx)
        return losses

    @staticmethod
    def backward(ctx, g):
        logits, lse, labels = ctx.saved_tensors
        smoothing, padding_idx = ctx.cfg
        g = g.float()
        if padding_idx is not None:
            g = torch.where(labels == padding_idx, torch.zeros_like(g), g)
        v = logits.shape[-1]
        dx = XE.xent_bwd(logits.reshape(-1, v), labels.reshape(-1), lse,
                         g.reshape(-1), smoothing)
        return dx.reshape(logits.shape), None, None, None


@custom_grad
def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0,
                               padding_idx: Optional[int] = 0,
                               half_to_float: bool = False) -> torch.Tensor:
    """Per-row losses (no reduction) of logits [..., V] against int labels
    [...]. ``half_to_float`` returns fp32 losses from half logits; by
    default they keep the logits' dtype (softmax_xentropy.py:121-136).
    Differentiable in ``logits``."""
    losses = _SoftmaxXent.apply(logits, labels, float(smoothing),
                                padding_idx)
    if not half_to_float:
        losses = losses.to(logits.dtype)
    return losses


class SoftmaxCrossEntropyLoss:
    """Class facade with the reference autograd Function's call signature
    (softmax_xentropy.py:139-151)."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False):
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          padding_idx, half_to_float)
