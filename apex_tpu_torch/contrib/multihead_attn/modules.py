"""Self multihead attention — counterpart of
``apex_tpu/contrib/multihead_attn/modules.py`` for what the LM needs: the
packed parameter layout and xavier init (:38-43, :211-236) and the
forward without masks, with the attention core chosen by ``impl``
(:169-203): ``"fast"`` the flash kernels, ``"default"`` the unfused
``reference_attention``, ``"auto"`` flash from ``flash_min_s`` (4096 when
unset) or when the unfused scores would pass 2 GiB (``_flash_wins``,
:138-167), both as constants here.

Parameters keep the JAX layout ``[in, out]`` (``in_proj`` [E, 3E],
``out_proj`` [E, E]) so ``x @ W`` is the same product in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from apex_tpu_torch.contrib.multihead_attn.flash_attention import (
    DEFAULT_FLASH_MIN_S, flash_attention, reference_attention)

__all__ = ["SelfMultiheadAttn"]

# impl="auto" takes the kernel below the crossover length once the
# unfused path's ~6 live fp32 [BH, Sq, Sk] buffers would pass this
COMPOSED_SCORE_BYTES = 2 << 30


def _xavier(generator: torch.Generator, shape) -> torch.Tensor:
    """Xavier-uniform over (fan_in, fan_out) = (shape[0], shape[-1]),
    drawn on the CPU from ``generator``."""
    fan_in, fan_out = shape[0], shape[-1]
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2 * bound) - bound


def _split_heads(x, num_heads):
    # [T, B, E] -> [B*H, T, E/H]
    t, b, e = x.shape
    return x.reshape(t, b * num_heads, e // num_heads).transpose(0, 1)


def _merge_heads(x, b):
    # [B*H, T, D] -> [T, B, H*D]
    bh, t, d = x.shape
    return x.transpose(0, 1).reshape(t, b, (bh // b) * d)


@dataclasses.dataclass(frozen=True)
class SelfMultiheadAttn:
    """Self-attention with one packed [E, 3E] input projection: ``bias``
    on or off, ``causal``, ``impl`` in {"fast", "default", "auto"}.
    ``dropout`` > 0 is refused in training (not ported yet)."""
    embed_dim: int
    num_heads: int
    bias: bool = False
    causal: bool = False
    dropout: float = 0.0
    impl: str = "fast"
    flash_min_s: Optional[int] = None

    def __post_init__(self):
        if self.embed_dim % self.num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if self.impl not in ("fast", "default", "auto"):
            raise ValueError(f"impl must be 'fast', 'default' or 'auto', "
                             f"got {self.impl!r}")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def init(self, generator: torch.Generator) -> dict:
        """Fresh fp32 parameters on the CPU (the caller moves them)."""
        e = self.embed_dim
        p = {"in_proj": _xavier(generator, (e, 3 * e)),
             "out_proj": _xavier(generator, (e, e))}
        if self.bias:
            p["in_proj_bias"] = torch.zeros(3 * e)
            p["out_proj_bias"] = torch.zeros(e)
        return p

    def _flash_wins(self, q, k) -> bool:
        thr = self.flash_min_s if self.flash_min_s is not None \
            else DEFAULT_FLASH_MIN_S
        sq, sk = q.shape[-2], k.shape[-2]
        if max(sq, sk) >= thr:
            return True
        bh = 1
        for d in q.shape[:-2]:
            bh *= d
        return 6 * bh * sq * sk * 4 > COMPOSED_SCORE_BYTES

    def apply(self, params: dict, query: torch.Tensor, *,
              is_training: bool = True):
        """query: [T, B, E] time-major. Returns (output [T, B, E], None)
        like the JAX module."""
        if is_training and self.dropout > 0.0:
            raise NotImplementedError(
                "attention dropout is not ported yet (ROADMAP.md Queue 1, "
                "item 15)")
        t, b, e = query.shape
        qkv = query @ params["in_proj"]
        if self.bias:
            qkv = qkv + params["in_proj_bias"]
        q, k, v = torch.split(qkv, e, dim=-1)
        q, k, v = (_split_heads(a, self.num_heads) for a in (q, k, v))
        scale = 1.0 / float(self.head_dim) ** 0.5
        if self.impl == "fast" or (self.impl == "auto"
                                   and self._flash_wins(q, k)):
            out = flash_attention(q, k, v, causal=self.causal, scale=scale)
        else:
            out = reference_attention(q, k, v, causal=self.causal,
                                      scale=scale)
        out = _merge_heads(out, b) @ params["out_proj"]
        if self.bias:
            out = out + params["out_proj_bias"]
        return out, None

    __call__ = apply
