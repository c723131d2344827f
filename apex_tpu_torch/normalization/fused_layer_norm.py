"""FusedLayerNorm forward — counterpart of
``apex_tpu/normalization/fused_layer_norm.py``.

Forward only in this slice: the serving path never differentiates. The
rows go through ``ops.layer_norm.ln_fwd`` (the hand kernel on the card,
the plain version on the CPU). On the card a call that would need a
gradient raises; the autograd Function with the backward kernel comes
with the training slice (ROADMAP.md Queue 1, slice 4).
"""

from __future__ import annotations

import numbers

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.layer_norm import ln_fwd

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


def _ln_fwd_math(x, weight, bias, normalized_shape, eps):
    """(out, mean, invvar) with mean/invvar in keepdims shape, fp32."""
    if x.is_cuda and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        raise NotImplementedError(
            "FusedLayerNorm is forward-only on the card in this port "
            "slice (the backward kernel comes with training, ROADMAP.md "
            "Queue 1, slice 4); run under torch.no_grad()")
    n1, n2 = _n1_n2(x.shape, normalized_shape)
    k = len(normalized_shape)
    y, mean, invvar = ln_fwd(
        x.reshape(n1, n2).contiguous(),
        None if weight is None else weight.reshape(n2).contiguous(),
        None if bias is None else bias.reshape(n2).contiguous(), eps)
    ks = tuple(x.shape[:x.dim() - k]) + (1,) * k
    return y.reshape(x.shape), mean.reshape(ks), invvar.reshape(ks)


def fused_layer_norm_affine(x, normalized_shape, weight, bias,
                            eps: float = 1e-6):
    """Functional affine layernorm, the reference signature (input,
    normalized_shape, weight, bias, eps=1e-6)."""
    ns = _canon_shape(normalized_shape)
    return _ln_fwd_math(x, weight, bias, ns, float(eps))[0]


def fused_layer_norm(x, normalized_shape, eps: float = 1e-6):
    """Functional non-affine layernorm (same 1e-6 default)."""
    ns = _canon_shape(normalized_shape)
    return _ln_fwd_math(x, None, None, ns, float(eps))[0]


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
