"""Self and encoder-decoder multihead attention — counterpart of
``apex_tpu/contrib/multihead_attn/modules.py`` for what the LM, the
Seq2Seq Transformer and the ViT need: the packed parameter layouts and
xavier init (:38-43, :211-236, :305-318), the two mask kinds split onto the
kernels' inputs (``_masks_to_biases``, :57-75), and the forward with the
attention core chosen by ``impl`` (:169-203): ``"fast"`` the flash
kernels, ``"default"`` the unfused ``reference_attention``, ``"auto"`` the
flash kernels where they take the call (fp32, bf16 or fp16 on the card,
head dim up to 512) from ``flash_min_s`` (when unset the H100's
crossover, ``DEFAULT_FLASH_MIN_S``, where it was measured to hold: the
16-bit kernels to head dim 256 and fp32's 3xTF32 ones to 128; none for
fp32 past 128, whose forward or backward loses to the plain path without
a causal mask, nor yet for the 16-bit kernels past 256, where the
crossover was first measured with every kernel on the tensor cores) or
when the unfused scores would pass 2 GiB (``_flash_wins``).

A ``key_padding_mask`` [B, Sk] (True = pad) becomes the per-key
``kv_bias`` [B·H, Sk], and an ``attn_mask`` [Sq, Sk] a full additive bias
[1, Sq, Sk]; every core takes both, the flash kernels with
``bias_grad=False`` (a constructed mask, :195-197). Dropout (training,
``dropout`` > 0) drops the attention probabilities in the core with the
coordinate hash, from the int ``dropout_seed`` the caller passes per call
(JAX derives it from a key, ``_dropout_seed``, :78-80); without a seed
there is no dropout, as without a key there.

With ``seq_axis`` / ``seq_axis_size`` (:111-132, :179-190) the time
axis is sharded over that named axis (``parallel.collectives``) and the
core is ``parallel.ring_attention`` whatever ``impl`` says; an
``attn_mask`` is refused there, a ``key_padding_mask`` rotates with its
keys.

Parameters keep the JAX layout ``[in, out]`` (``in_proj`` [E, 3E],
``q_proj`` [E, E], ``kv_proj`` [E, 2E], ``out_proj`` [E, E]) so
``x @ W`` is the same product in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from apex_tpu_torch.contrib.multihead_attn.flash_attention import (
    DEFAULT_FLASH_MIN_S, NEG_INF, flash_attention, reference_attention)
from apex_tpu_torch.ops.flash_attn import (KERNEL_HEAD_DIMS,
                                           SIMT_MAX_HEAD_DIM, kernel_form)

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn"]

# impl="auto" takes the kernel below the crossover length once the
# unfused path's ~6 live fp32 [BH, Sq, Sk] buffers would pass this
COMPOSED_SCORE_BYTES = 2 << 30


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


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


def _masks_to_biases(key_padding_mask, attn_mask, h: int, sq: int, sk: int):
    """(bias, kv_bias): ``attn_mask`` [Sq, Sk] additive -> a full bias
    [1, Sq, Sk]; ``key_padding_mask`` [B, Sk] bool (True = pad) -> the
    per-key kv_bias [B·H, Sk], 0 or ``NEG_INF``, each batch row repeated
    for its H heads (bh = b·H + h, the order of ``_split_heads``)."""
    bias = None
    if attn_mask is not None:
        bias = attn_mask.float()[None].expand(1, sq, sk)
    kv_bias = None
    if key_padding_mask is not None:
        kp = torch.where(key_padding_mask, NEG_INF, 0.0).float()
        kv_bias = kp.repeat_interleave(h, dim=0)
    return bias, kv_bias


@dataclasses.dataclass(frozen=True)
class _AttnBase:
    """What both modules share: the config, ``impl``'s rule and the
    attention core."""
    embed_dim: int
    num_heads: int
    bias: bool = False
    causal: bool = False
    dropout: float = 0.0
    impl: str = "fast"
    flash_min_s: Optional[int] = None
    # sequence parallelism: the time axis sharded over this named axis,
    # the core the ring (call on every rank with its shard)
    seq_axis: Optional[str] = None
    seq_axis_size: int = 0

    def __post_init__(self):
        if self.embed_dim % self.num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if self.impl not in ("fast", "default", "auto"):
            raise ValueError(f"impl must be 'fast', 'default' or 'auto', "
                             f"got {self.impl!r}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got "
                             f"{self.dropout}")
        if self.seq_axis is not None and self.seq_axis_size < 2:
            raise ValueError("seq_axis requires seq_axis_size >= 2")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def _flash_wins(self, q, k) -> bool:
        """impl="auto": the kernels only where they take the call — fp32,
        bf16 or fp16 tensors on the card, head dim up to 512 — from
        ``flash_min_s``, or once the plain path's scores would pass 2 GiB.
        Unset, ``flash_min_s`` is ``DEFAULT_FLASH_MIN_S`` where the H100's
        crossover was measured to hold (bf16 and fp16 at a head dim up to
        256, fp32 in 3xTF32 at one up to 128: the crossovers measured 128
        at D 64 and 256). fp32 at 129-256 runs in 3xTF32 too, but there the
        forward loses to the plain path from S 1024 without a causal mask
        (``chip_smoke.flash_crossover_phase(torch, "float32", 256)``:
        ``min_s`` None, PERF.md; at 320, in 3xTF32 too, the forward and
        backward together lose without it from S 256). Past 256 bf16 and
        fp16 run all three
        kernels on the tensor cores and won from S 128 at D 320 (PERF.md
        §7); no crossover is set there until that reading is taken at
        more head dims, so only the 2 GiB rule sends a call past 256. The
        kernels take
        the full bias and dropout, so neither routes a call away. Anything
        else goes to ``reference_attention``, as JAX's "auto" does below
        its crossover. A routing rule, not a fallback: ``impl="fast"``
        still raises on what the kernels do not take."""
        bh = 1
        for d in q.shape[:-2]:
            bh *= d
        if not (_on_card(q) and q.dtype in (torch.float32, torch.bfloat16,
                                            torch.float16)
                and k.dtype == q.dtype
                and q.shape[-1] <= SIMT_MAX_HEAD_DIM):
            return False
        thr = self.flash_min_s
        form = kernel_form(q, "dkv")
        if thr is None and (form in ("tc", "tc256") or (
                form == "f32" and q.shape[-1] <= KERNEL_HEAD_DIMS[1])):
            thr = DEFAULT_FLASH_MIN_S
        sq, sk = q.shape[-2], k.shape[-2]
        return (thr is not None and max(sq, sk) >= thr) or \
            6 * bh * sq * sk * 4 > COMPOSED_SCORE_BYTES

    def _core(self, q, k, v, bias, kv_bias, is_training: bool,
              dropout_seed=None):
        """The attention core over [B·H, S, D]; the masks are constructed,
        so neither gets a gradient. Dropout at ``self.dropout`` in training
        when a ``dropout_seed`` is given (:175-178)."""
        scale = 1.0 / float(self.head_dim) ** 0.5
        rate = self.dropout if (is_training and self.dropout > 0.0
                                and dropout_seed is not None) else 0.0
        seed = int(dropout_seed) if rate > 0.0 else 0
        if self.seq_axis is not None:
            if bias is not None:
                raise NotImplementedError(
                    "attn_mask is not supported under ring attention "
                    "(it would need the full [Sq, Sk_global] matrix); "
                    "key_padding_mask and causal=True are supported")
            from apex_tpu_torch.parallel.ring_attention import \
                ring_attention
            return ring_attention(q, k, v, self.seq_axis,
                                  self.seq_axis_size, causal=self.causal,
                                  scale=scale, kv_bias=kv_bias,
                                  dropout_rate=rate, dropout_seed=seed)
        if self.impl == "fast" or (self.impl == "auto"
                                   and self._flash_wins(q, k)):
            return flash_attention(q, k, v, bias, kv_bias=kv_bias,
                                   causal=self.causal, scale=scale,
                                   bias_grad=False, dropout_rate=rate,
                                   dropout_seed=seed)
        return reference_attention(q, k, v, bias, kv_bias=kv_bias,
                                   causal=self.causal, scale=scale,
                                   dropout_rate=rate, dropout_seed=seed)

    def _project_out(self, params, out, b):
        out = _merge_heads(out, b) @ params["out_proj"]
        if self.bias:
            out = out + params["out_proj_bias"]
        return out


@dataclasses.dataclass(frozen=True)
class SelfMultiheadAttn(_AttnBase):
    """Self-attention with one packed [E, 3E] input projection
    (modules.py:209-284): ``bias`` on or off, ``causal``, ``impl`` in
    {"fast", "default", "auto"}."""

    def init(self, generator: torch.Generator) -> dict:
        """Fresh fp32 parameters on the CPU (the caller moves them)."""
        e = self.embed_dim
        p = {"in_proj": _xavier(generator, (e, 3 * e)),
             "out_proj": _xavier(generator, (e, e))}
        if self.bias:
            p["in_proj_bias"] = torch.zeros(3 * e)
            p["out_proj_bias"] = torch.zeros(e)
        return p

    def apply(self, params: dict, query: torch.Tensor, *,
              key_padding_mask: Optional[torch.Tensor] = None,
              attn_mask: Optional[torch.Tensor] = None,
              is_training: bool = True, dropout_seed=None):
        """query: [T, B, E] time-major; ``key_padding_mask`` bool [B, T]
        (True = pad), ``attn_mask`` additive [T, T]; ``dropout_seed`` an
        int for this call's dropout mask. Returns (output [T, B, E], None)
        like the JAX module."""
        t, b, e = query.shape
        qkv = query @ params["in_proj"]
        if self.bias:
            qkv = qkv + params["in_proj_bias"]
        q, k, v = (_split_heads(a, self.num_heads)
                   for a in torch.split(qkv, e, dim=-1))
        bias, kv_bias = _masks_to_biases(key_padding_mask, attn_mask,
                                         self.num_heads, t, t)
        out = self._core(q, k, v, bias, kv_bias, is_training,
                         dropout_seed)
        return self._project_out(params, out, b), None

    __call__ = apply


@dataclasses.dataclass(frozen=True)
class EncdecMultiheadAttn(_AttnBase):
    """Encoder-decoder attention (modules.py:286-354): q from the decoder
    stream through ``q_proj`` [E, E], k and v from the encoder memory
    through one packed ``kv_proj`` [E, 2E]."""

    def init(self, generator: torch.Generator) -> dict:
        """Fresh fp32 parameters on the CPU (the caller moves them)."""
        e = self.embed_dim
        p = {"q_proj": _xavier(generator, (e, e)),
             "kv_proj": _xavier(generator, (e, 2 * e)),
             "out_proj": _xavier(generator, (e, e))}
        if self.bias:
            p["q_proj_bias"] = torch.zeros(e)
            p["kv_proj_bias"] = torch.zeros(2 * e)
            p["out_proj_bias"] = torch.zeros(e)
        return p

    def apply(self, params: dict, query: torch.Tensor,
              key_value: torch.Tensor, *,
              key_padding_mask: Optional[torch.Tensor] = None,
              attn_mask: Optional[torch.Tensor] = None,
              is_training: bool = True, dropout_seed=None):
        """query: [Tq, B, E]; key_value: [Tk, B, E]; ``key_padding_mask``
        bool [B, Tk] (True = pad), ``attn_mask`` additive [Tq, Tk];
        ``dropout_seed`` as for ``SelfMultiheadAttn``. Returns (output
        [Tq, B, E], None)."""
        tq, b, e = query.shape
        tk = key_value.shape[0]
        q = query @ params["q_proj"]
        kv = key_value @ params["kv_proj"]
        if self.bias:
            q = q + params["q_proj_bias"]
            kv = kv + params["kv_proj_bias"]
        k, v = torch.split(kv, e, dim=-1)
        q, k, v = (_split_heads(a, self.num_heads) for a in (q, k, v))
        bias, kv_bias = _masks_to_biases(key_padding_mask, attn_mask,
                                         self.num_heads, tq, tk)
        out = self._core(q, k, v, bias, kv_bias, is_training,
                         dropout_seed)
        return self._project_out(params, out, b), None

    __call__ = apply
