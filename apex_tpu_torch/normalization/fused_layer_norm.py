"""FusedLayerNorm — counterpart of
``apex_tpu/normalization/fused_layer_norm.py``.

An autograd Function over rows: the forward is ``ops.layer_norm.ln_fwd``
and the backward ``ops.layer_norm.ln_bwd`` (the hand kernels on the card,
the plain versions on the CPU).
"""

from __future__ import annotations

import numbers

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp.autocast import custom_grad
from apex_tpu_torch.ops.layer_norm import ln_bwd, ln_fwd

__all__ = ["FusedLayerNorm", "fused_layer_norm", "fused_layer_norm_affine"]


def _canon_shape(normalized_shape) -> tuple:
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(d) for d in normalized_shape)


def _n1_n2(x_shape, normalized_shape):
    """(n1, n2) flattening (reference layer_norm_cuda.cpp:7-27): the
    trailing ``len(normalized_shape)`` dims are normalized, the rest are
    rows."""
    k = len(normalized_shape)
    if k == 0 or len(x_shape) < k or \
            tuple(x_shape[-k:]) != tuple(normalized_shape):
        raise ValueError(
            f"input trailing dims {tuple(x_shape[-k:]) if k else ()} do "
            f"not match normalized_shape {normalized_shape}")
    n2 = 1
    for d in normalized_shape:
        n2 *= d
    n1 = 1
    for d in x_shape[:len(x_shape) - k]:
        n1 *= d
    return n1, n2


class _LayerNorm(torch.autograd.Function):
    """The reference's autograd shape (fused_layer_norm.py:21-22): the
    forward kernel saves (x, weight, mean, invvar); the backward kernel
    gives dx and the fp32 column sums, cast to the weight's and the bias's
    dtypes as ``_ln_affine_bwd`` does (fused_layer_norm.py:125-157)."""

    @staticmethod
    def forward(ctx, x, weight, bias, normalized_shape, eps):
        n1, n2 = _n1_n2(x.shape, normalized_shape)
        x2 = x.reshape(n1, n2).contiguous()
        w2 = None if weight is None else weight.reshape(n2).contiguous()
        b2 = None if bias is None else bias.reshape(n2).contiguous()
        y, mean, invvar = ln_fwd(x2, w2, b2, eps)
        ctx.save_for_backward(x2, w2, mean, invvar)
        ctx.x_shape = x.shape
        ctx.wb = None if weight is None else (weight.shape, weight.dtype,
                                              bias.shape, bias.dtype)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, w2, mean, invvar = ctx.saved_tensors
        dx, gw, gb = ln_bwd(dy.reshape(x2.shape).contiguous(), x2, w2, mean,
                            invvar)
        dx = dx.reshape(ctx.x_shape)
        if ctx.wb is None:
            return dx, None, None, None, None
        w_shape, w_dtype, b_shape, b_dtype = ctx.wb
        return (dx, gw.reshape(w_shape).to(w_dtype),
                gb.reshape(b_shape).to(b_dtype), None, None)


@custom_grad
def fused_layer_norm_affine(x, normalized_shape, weight, bias,
                            eps: float = 1e-6):
    """Functional affine layernorm, the reference signature (input,
    normalized_shape, weight, bias, eps=1e-6)."""
    ns = _canon_shape(normalized_shape)
    return _LayerNorm.apply(x, weight, bias, ns, float(eps))


@custom_grad
def fused_layer_norm(x, normalized_shape, eps: float = 1e-6):
    """Functional non-affine layernorm (same 1e-6 default)."""
    ns = _canon_shape(normalized_shape)
    return _LayerNorm.apply(x, None, None, ns, float(eps))


class FusedLayerNorm(nn.Module):
    """Module form (reference ``FusedLayerNorm``: normalized_shape, eps,
    elementwise_affine); weight 1 and bias 0 at construction."""

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.normalized_shape = _canon_shape(normalized_shape)
        self.eps = float(eps)
        self.elementwise_affine = bool(elementwise_affine)
        if self.elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, device=dev, dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, device=dev, dtype=dtype))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.elementwise_affine:
            return fused_layer_norm_affine(x, self.normalized_shape,
                                           self.weight, self.bias, self.eps)
        return fused_layer_norm(x, self.normalized_shape, self.eps)
