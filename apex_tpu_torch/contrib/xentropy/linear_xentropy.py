"""Fused LM-head projection + softmax cross entropy, chunked over the
vocabulary — counterpart of ``apex_tpu/contrib/xentropy/linear_xentropy.py``.

The loss never builds the [N, V] logits: the forward walks the vocabulary
in chunks of ``chunk`` columns keeping an online (max, sumexp) pair per
row plus the label's logit, and saves only the per-row lse; the backward
recomputes each chunk's logits from it (one extra head product). Label
smoothing follows ``lse - (1-eps)·z_y - eps·mean(z)``; rows whose label is
``padding_idx`` get zero loss and zero gradient.

No kernel here, as in the JAX package (plain XLA dots there): each chunk
is one matrix product. Its fp32 result comes from 16-bit operands where an
operand is bf16 or fp16 on the card (``torch.mm(..., out_dtype=float32)``,
the JAX ``preferred_element_type``; the backward's fp32 dz enters in that
dtype, as the TPU's default dot precision takes an fp32 operand), and
from fp32 operands otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.amp.autocast import custom_grad

__all__ = ["linear_cross_entropy"]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b``."""
    for half in (torch.bfloat16, torch.float16):
        if a.is_cuda and half in (a.dtype, b.dtype):
            return torch.mm(a.to(half), b.to(half), out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _fwd_scan(h, w, labels, chunk, smoothing):
    """(lse, label logit, sum of logits or None) per row."""
    n = h.shape[0]
    m = torch.full((n,), float("-inf"), dtype=torch.float32, device=h.device)
    s = torch.zeros((n,), dtype=torch.float32, device=h.device)
    zy = torch.zeros((n,), dtype=torch.float32, device=h.device)
    zsum = torch.zeros_like(s) if smoothing > 0.0 else None
    lab = labels.long()
    for off in range(0, w.shape[0], chunk):
        z = _dot(h, w[off:off + chunk].T)                    # [N, C] fp32
        m_new = torch.maximum(m, z.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(-1)
        m = m_new
        inside = (lab >= off) & (lab < off + z.shape[1])
        idx = torch.clamp(lab - off, 0, z.shape[1] - 1)
        zy = zy + torch.where(inside, z.gather(1, idx[:, None])[:, 0],
                              torch.zeros_like(zy))
        if zsum is not None:
            zsum = zsum + z.sum(-1)
    return m + torch.log(s), zy, zsum


class _LinearXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, smoothing, padding_idx, chunk):
        lse, zy, zsum = _fwd_scan(h, w, labels, chunk, smoothing)
        if smoothing > 0.0:
            losses = lse - (1.0 - smoothing) * zy \
                - smoothing * (zsum / w.shape[0])
        else:
            losses = lse - zy
        if padding_idx is not None:
            losses = torch.where(labels == padding_idx,
                                 torch.zeros_like(losses), losses)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.cfg = (smoothing, padding_idx, chunk)
        return losses

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        smoothing, padding_idx, chunk = ctx.cfg
        v = w.shape[0]
        lab = labels.long()
        g = g.float()
        if padding_idx is not None:
            g = torch.where(labels == padding_idx, torch.zeros_like(g), g)
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dws = []
        for off in range(0, v, chunk):
            w_c = w[off:off + chunk]
            z = _dot(h, w_c.T)                               # recompute
            p = torch.exp(z - lse[:, None])
            cols = off + torch.arange(z.shape[1], device=z.device)
            onehot = (cols[None, :] == lab[:, None]).float()
            dz = p - (1.0 - smoothing) * onehot
            if smoothing > 0.0:
                dz = dz - smoothing / v
            dz = dz * g[:, None]
            dh += _dot(dz, w_c)                              # [N, D]
            dws.append(_dot(dz.T, h).to(w.dtype))            # [C, D]
        return dh.to(h.dtype), torch.cat(dws), None, None, None, None


@custom_grad
def linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                         labels: torch.Tensor, *, smoothing: float = 0.0,
                         padding_idx: Optional[int] = None,
                         chunk: int = 8192) -> torch.Tensor:
    """Per-row ``xent(hidden @ weight.T, labels)`` without the logits:
    hidden [N, D], weight [V, D] (the tied embedding), labels int [N];
    ``chunk`` vocab columns a step (must divide V; clamped to V). Returns
    [N] fp32 losses, differentiable in hidden and weight."""
    if hidden.dim() != 2 or weight.dim() != 2 \
            or hidden.shape[1] != weight.shape[1]:
        raise ValueError(f"expected h [N, D] and w [V, D] with matching D; "
                         f"got {tuple(hidden.shape)} and "
                         f"{tuple(weight.shape)}")
    if tuple(labels.shape) != (hidden.shape[0],):
        raise ValueError(f"labels must be [N]={hidden.shape[0]}, "
                         f"got {tuple(labels.shape)}")
    chunk = min(chunk, weight.shape[0])
    if weight.shape[0] % chunk:
        raise ValueError(f"chunk ({chunk}) must divide vocab "
                         f"({weight.shape[0]})")
    return _LinearXent.apply(hidden, weight, labels, float(smoothing),
                             padding_idx, chunk)
