"""Sequence parallelism: ring attention and Ulysses all-to-all —
counterpart of ``apex_tpu/parallel/ring_attention.py``.

The sequence is sharded over a named axis (``collectives.bind_axis``; a
rank a shard) and attention runs either as

- **ring attention** (:func:`ring_attention`): the K/V shard rotates to
  the next rank by ``collectives.ppermute``; each step runs the flash
  kernels on the resident shard at its global offsets (``q_start``,
  ``k_start``) with ``return_lse=True`` and merges the partial into the
  running output with :func:`merge_partials`. A rank holds one K/V shard
  at a time;
- **Ulysses** (:func:`ulysses_attention`): one ``all_to_all`` trades the
  sequence sharding for a head sharding, attention runs on the full
  sequence for H/n heads, and a second restores the sequence sharding.

Causality across shards, the per-key ``kv_bias`` and dropout use global
positions, so a sharded run equals the single-device computation; the
dropout mask is the coordinate hash of the global (q, k) positions, bit
for bit. The backward needs no code of its own: ``ppermute``'s and
``all_to_all``'s backwards send the cotangents back, and the merge's lse
carries a cotangent into the flash backward (``flash_delta``'s ``dlse``).

The JAX ring scans ``axis_size`` steps and rotates after each, the last
rotation unused; here the K and V of a step travel as one stacked
tensor, and the unused last rotation is not sent (the result is the
same). ``kv_bias`` carries no gradient and rotates outside autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.contrib.multihead_attn.flash_attention import (
    NEG_INF, flash_attention, reference_attention)
from apex_tpu_torch.parallel import collectives as _C

__all__ = ["ring_attention", "ulysses_attention", "merge_partials"]


def merge_partials(o1, lse1, o2, lse2):
    """Online-softmax merge of two attention partials (ring_attention.py:
    40-56). o: [..., S, D] fp32 outputs, each normalized by its own sum;
    lse: [..., S] their log-sum-exps (``NEG_INF`` for a partial that saw
    nothing, which then weighs nothing)."""
    m = torch.maximum(lse1, lse2)
    zero = torch.zeros_like(m)
    w1 = torch.where(lse1 > NEG_INF * 0.5, torch.exp(lse1 - m), zero)
    w2 = torch.where(lse2 > NEG_INF * 0.5, torch.exp(lse2 - m), zero)
    denom = w1 + w2
    safe = torch.where(denom > 0.0, denom, torch.ones_like(denom))
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / safe[..., None]
    lse = torch.where(denom > 0.0, m + torch.log(safe),
                      torch.full_like(m, NEG_INF))
    return o, lse


def _check_axis(axis_name, axis_size: int) -> None:
    n = _C.group_size(axis_name)
    if n != axis_size:
        raise ValueError(f"axis_size={axis_size} != size of axis "
                         f"{axis_name!r} ({n})")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str, axis_size: int, *,
                   causal: bool = False, scale: Optional[float] = None,
                   kv_bias: Optional[torch.Tensor] = None,
                   dropout_rate: float = 0.0,
                   dropout_seed=0) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis_name`` (ring_attention.py:
    58-127). q, k, v are this rank's shards [BH, S_local, D] (or [B, H,
    S_local, D]); the result is full attention over the concatenated
    sequence with optional global causality, this rank's rows.
    ``kv_bias`` [1|BH, S_local]: this rank's per-key bias, rotating with
    its K/V shard. ``dropout_rate`` / ``dropout_seed``: dropout of the
    probabilities drawn from global positions."""
    _check_axis(axis_name, axis_size)
    n = axis_size
    idx = _C.axis_index(axis_name)
    s_local = q.shape[-2]
    q_start = idx * s_local
    lead = q.shape[:-2]
    if q.dim() == 4:
        q, k, v = (t.reshape(-1, *t.shape[2:]) for t in (q, k, v))
    kvb = None if kv_bias is None else kv_bias.detach()
    perm = [(j, (j + 1) % n) for j in range(n)]
    kv = torch.stack([k, v])
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                     device=q.device)
    for t in range(n):
        # after t rotations this rank holds the shard of (idx - t)
        src = (idx - t) % n
        o_t, lse_t = flash_attention(
            q, kv[0], kv[1], kv_bias=kvb, causal=causal, scale=scale,
            q_start=q_start, k_start=src * kv.shape[-2], return_lse=True,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        o, lse = merge_partials(o, lse, o_t.float(), lse_t)
        if t < n - 1:
            kv = _C.ppermute(kv, axis_name, perm)
            if kvb is not None:
                kvb = _C.ppermute(kvb, axis_name, perm)
    return o.to(q.dtype).reshape(*lead, *o.shape[1:])


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str, axis_size: int, *,
                      causal: bool = False, scale: Optional[float] = None,
                      kv_bias: Optional[torch.Tensor] = None,
                      impl: str = "flash") -> torch.Tensor:
    """All-to-all sequence parallelism (ring_attention.py:130-193): q, k,
    v are this rank's sequence shards [B, H, S_local, D], H divisible by
    ``axis_size``. ``kv_bias``: this rank's per-key bias [1|B·H, S_local],
    gathered to the full key length ([1, S]) or split with the heads
    ([B·H, S]: the rows follow K's head split). ``impl="flash"`` runs
    ``flash_attention`` on the full sequences, anything else
    ``reference_attention``."""
    b, h, s_local, d = q.shape
    if h % axis_size:
        raise ValueError(f"num_heads {h} not divisible by axis {axis_size}")
    _check_axis(axis_name, axis_size)
    # [3, B, H, Sl, D] -> [3, B, H/n, n*Sl, D]: scatter heads, gather seq,
    # q, k and v in one exchange
    qkv = _C.all_to_all(torch.stack([q, k, v]), axis_name, split_axis=2,
                        concat_axis=3)
    qh, kh, vh = qkv.unbind(0)
    kvb_full = None
    if kv_bias is not None:
        kv_bias = kv_bias.detach()
        if kv_bias.shape[0] == 1:
            # head-shared: gather the key length
            kvb_full = _C.all_gather(kv_bias.t().contiguous(),
                                     axis_name).t()
        elif kv_bias.shape[0] == b * h:
            # per (batch, head): the same head split as K
            kvb4 = kv_bias.reshape(b, h, s_local, 1)
            kvb_full = _C.all_to_all(kvb4, axis_name, split_axis=1,
                                     concat_axis=2).reshape(
                b * h // axis_size, axis_size * s_local)
        else:
            raise ValueError(
                f"kv_bias leading dim must be 1 or B*H={b * h}, "
                f"got {kv_bias.shape[0]}")
    if impl == "flash":
        oh = flash_attention(qh, kh, vh, kv_bias=kvb_full, causal=causal,
                             scale=scale)
    else:
        kvb = kvb_full
        if kvb is not None:
            kvb = kvb.reshape(b, -1, kvb.shape[-1]) if kvb.shape[0] > 1 \
                else kvb[None]
        oh = reference_attention(qh, kh, vh, kv_bias=kvb, causal=causal,
                                 scale=scale)
    return _C.all_to_all(oh, axis_name, split_axis=2, concat_axis=1)
