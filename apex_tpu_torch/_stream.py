"""The counter-based random stream of the port's samplers.

A uniform is a pure function of integers: ``(seed, key, index, column)``,
computed where ``key`` lives. The serving engine keys it by request and
token index, ``TransformerLM.generate`` by batch row and position, and the
speculative step folds a role and a draft row into the request key
(:func:`fold_key`), where the JAX package folds the same integers into a
threefry key (``jax.random.fold_in``). Threefry's bits cannot be
reproduced in torch, so the streams differ across packages; within the
port a run replays bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["stream_uniforms", "fold_key", "gumbel_argmax"]

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant
    c, in two 16-bit halves so no product leaves the int64 range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (lowbias32): each output bit depends on
    every input bit. Inputs stay in [0, 2**32), so shifts are logical."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stream_uniforms(seed: int, key: torch.Tensor, tok_idx: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Uniforms in (0, 1), float32 [rows, n]. Row r is draw ``tok_idx[r]``
    of the stream ``(seed, key[r])``, column j its j-th value: a pure
    function of those integers, computed where ``key`` lives."""
    s = _mix32(torch.full_like(key, seed & _M32))
    h = _mix32((key & _M32) ^ s)
    h = _mix32(h ^ (tok_idx.to(torch.int64) & _M32))
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    bits = _mix32(_mix32((h[:, None] + _mul32(j, 0x9E3779B9)[None, :])
                         & _M32))
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def fold_key(key: torch.Tensor, *xs: int) -> torch.Tensor:
    """A stream key derived from ``key`` (int64, in [0, 2**32)) and the
    integers ``xs`` in turn: the analog of ``jax.random.fold_in``."""
    key = key.to(torch.int64) & _M32
    for x in xs:
        key = _mix32(key ^ ((int(x) + 1) * 0x85EBCA6B & _M32))
    return key


def gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One categorical draw a row from fp32 logits [rows, V] (``-inf``
    masks a token) with the uniforms ``u`` [rows, V]: the argmax of logits
    plus Gumbel noise, as ``jax.random.categorical`` draws. int32
    [rows]."""
    return torch.argmax(logits - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)
