"""Prefill attention — the part of
``apex_tpu/contrib/multihead_attn/flash_attention.py`` the serving path
runs: ``NEG_INF`` (:73) and ``reference_attention`` (:586-631) on its
causal, no-bias, no-dropout path.

The JAX package runs this outside any kernel (chunked prefill and the
model's forward use the unfused path), so it stays plain PyTorch here,
op for op: fp32 scores, finite ``NEG_INF`` masking, max, exp under where,
sum, guarded divide. The flash kernels (forward and backward) come with
the training slice.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "reference_attention"]

# finite -inf stand-in: exp(NEG_INF - m) is exactly 0.0 in fp32, so a fully
# masked row yields zeros instead of NaN
NEG_INF = -1.0e30


def reference_attention(q, k, v, *, causal: bool = False, scale=None,
                        q_start: int = 0, k_start: int = 0):
    """Unfused attention: q [..., Sq, d], k/v [..., Sk, d]. With
    ``causal``, query row i (absolute position ``q_start + i``) sees keys
    at absolute positions ``k_start + j <= q_start + i``. Returns
    [..., Sq, d] in q's dtype."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = q_start + torch.arange(sq, device=q.device)[:, None]
        k_pos = k_start + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m),
                    torch.zeros_like(s))
    l_sum = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(l_sum > 0.0, l_sum, torch.ones_like(l_sum))
    return torch.matmul(probs, v.float()).to(q.dtype)
