"""Softmax cross-entropy helpers — counterpart of
``apex_tpu/contrib/xentropy/softmax_xentropy.py``.

Ported so far: ``select_label_logits``, which the RN50 training loss
uses. The fused label-smoothed loss and its kernels are slice 4
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch

__all__ = ["select_label_logits"]


def select_label_logits(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., i, labels[i]]`` in fp32, as the JAX package takes it:
    a compare with the class index and a masked sum over the last axis
    (softmax_xentropy.py:47-58)."""
    cols = torch.arange(logits.shape[-1], device=logits.device)
    mask = cols == labels[..., None].to(torch.int64)
    return torch.where(mask, logits, torch.zeros((), dtype=logits.dtype,
                                                 device=logits.device)
                       ).float().sum(dim=-1)
