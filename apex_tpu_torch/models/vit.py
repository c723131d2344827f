"""Vision Transformer — counterpart of ``apex_tpu/models/vit.py``, the
model of ``examples/imagenet/main_amp.py --arch vit_*``.

Pre-LN blocks over patch tokens::

    tokens = [cls, patchify(x) @ patch_proj + patch_bias] + pos_emb
    t += MHA(LN(t))            # non-causal, time-major, dropout in the core
    t += MLP(LN(t))            # GeLU (tanh form, as jax.nn.gelu)
    logits = LN(t)[:, 0] @ head.w + head.b     (or the patch tokens' mean)

Ported: the config, ``init`` (the JAX names and shapes, drawn from a
``torch.Generator``), ``apply`` under autograd with attention dropout,
``analytic_flops`` and the constructors ``vit_tiny``, ``vit_small``,
``vit_b16`` and ``vit_l16``; ``remat`` and ``remat_policy`` rematerialize
each block (``models/_remat.py``).

The input is a channels-last batch [B, H, W, 3]; the patch embedding is
a reshape and one product (vit.py:119-133), not a convolution. Every
LayerNorm goes through ``normalization.fused_layer_norm_affine`` (the
LayerNorm kernels on the card) and the attention through
``SelfMultiheadAttn`` with ``attn_impl`` ("auto": the flash kernels for
bf16 on the card from the H100's crossover, which the 197 tokens of
ViT-B/16 at 224² pass). Parameters keep the JAX layout, weights
``[in, out]``; convert a JAX tree with ``convert.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib.multihead_attn.modules import SelfMultiheadAttn
from apex_tpu_torch.models import _remat
from apex_tpu_torch.models.transformer import _gelu, _layer_seeds, _tree_to
from apex_tpu_torch.normalization import fused_layer_norm_affine

__all__ = ["ViT", "analytic_flops", "vit_tiny", "vit_small", "vit_b16",
           "vit_l16"]


@dataclasses.dataclass(frozen=True)
class ViT:
    num_classes: int
    image_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    ffn_mult: int = 4
    dropout: float = 0.0
    attn_impl: str = "auto"     # 'auto' crossover, 'fast', 'default'
    pool: str = "cls"           # 'cls' token or 'mean' over patch tokens
    remat: bool = False
    remat_policy: Optional[str] = None
    # where init() puts the parameters; None means the card
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"patch_size ({self.patch_size}) must divide image_size "
                f"({self.image_size})")
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', "
                             f"got {self.pool!r}")
        _remat.validate_remat_config(self.remat, self.remat_policy)
        self._mha()                          # validates widths and impl
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        # +1 for the cls token (present in both pool modes)
        return self.num_patches + 1

    def _mha(self) -> SelfMultiheadAttn:
        return SelfMultiheadAttn(self.embed_dim, self.num_heads,
                                 dropout=self.dropout, bias=True,
                                 impl=self.attn_impl, causal=False)

    def init(self, generator: Union[torch.Generator, int] = 0, *,
             dtype: torch.dtype = torch.float32) -> dict:
        """Random parameters with the JAX names and shapes (vit.py:82-117),
        drawn on the CPU from ``generator`` (a ``torch.Generator`` or a
        seed) and moved to ``self.device`` in ``dtype``. The draws differ
        from ``jax.random``'s; to hold the two packages on the same
        weights, convert the JAX tree with ``convert.params_from_jax``."""
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        e, f = self.embed_dim, self.ffn_mult * self.embed_dim
        pdim = self.patch_size * self.patch_size * 3

        def normal(*shape, std=0.02):
            return torch.randn(shape, generator=generator) * std

        def ln():
            return {"g": torch.ones(e), "b": torch.zeros(e)}

        p = {"patch_proj": normal(pdim, e, std=pdim ** -0.5),
             "patch_bias": torch.zeros(e),
             "cls_token": normal(1, 1, e),
             "pos_emb": normal(self.seq_len, e),
             "ln_f": ln(),
             "head": {"w": normal(e, self.num_classes, std=e ** -0.5),
                      "b": torch.zeros(self.num_classes)}}
        mha = self._mha()
        for i in range(self.num_layers):
            p[f"layer_{i}"] = {
                "ln1": ln(), "attn": mha.init(generator), "ln2": ln(),
                "mlp": {"w1": normal(e, f), "b1": torch.zeros(f),
                        "w2": normal(f, e), "b2": torch.zeros(e)}}
        return _tree_to(p, self.device, dtype)

    def _ln(self, x, lnp):
        return fused_layer_norm_affine(x, (self.embed_dim,), lnp["g"],
                                       lnp["b"], 1e-5)

    def _patchify(self, x):
        """[B, H, W, 3] -> [B, N, p·p·3] by reshape and permute only."""
        b, h, w, c = x.shape
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(
                f"input spatial dims {(h, w)} do not match the model's "
                f"image_size {self.image_size}")
        ps = self.patch_size
        gh, gw = h // ps, w // ps
        x = x.reshape(b, gh, ps, gw, ps, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * gw, ps * ps * c)

    def apply(self, params: dict, x: torch.Tensor, *,
              is_training: bool = False, dropout_seeds=None) -> torch.Tensor:
        """x: [B, H, W, 3] channels-last, in the params' dtype. Returns fp32
        logits [B, num_classes]; differentiable in ``params``. In
        training, ``dropout_seeds`` (one int per layer, where JAX folds the
        layer index into its key, vit.py:150-156) drives the attention
        dropout; without seeds there is none."""
        seeds = _layer_seeds(dropout_seeds, self.num_layers)
        b = x.shape[0]
        tokens = self._patchify(x) @ params["patch_proj"] \
            + params["patch_bias"]                  # [B, N, E]
        cls = params["cls_token"].to(tokens.dtype).expand(
            b, 1, self.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1) + params["pos_emb"]
        mha = self._mha()

        def layer_body(t, lp, seed):
            h = self._ln(t, lp["ln1"])
            # MHA modules are time-major [T, B, E]
            attn_out, _ = mha.apply(lp["attn"], h.transpose(0, 1),
                                    is_training=is_training,
                                    dropout_seed=seed)
            t = t + attn_out.transpose(0, 1)
            h = self._ln(t, lp["ln2"])
            h = _gelu(h @ lp["mlp"]["w1"] + lp["mlp"]["b1"])
            return t + (h @ lp["mlp"]["w2"] + lp["mlp"]["b2"])

        if self.remat:
            layer_body = _remat.remat(layer_body, self.remat_policy)
        for i in range(self.num_layers):
            tokens = layer_body(tokens, params[f"layer_{i}"], seeds[i])
        tokens = self._ln(tokens, params["ln_f"])
        pooled = tokens[:, 0] if self.pool == "cls" \
            else torch.mean(tokens[:, 1:], dim=1)
        logits = pooled @ params["head"]["w"] + params["head"]["b"]
        return logits.float()

    __call__ = apply


def analytic_flops(model: ViT, image: Optional[int] = None) -> float:
    """Forward FLOPs per image (2 a multiply-add), for MFU: the JAX
    package's count (vit.py:184-201)."""
    image = image or model.image_size
    n = (image // model.patch_size) ** 2 + 1
    e, f = model.embed_dim, model.ffn_mult * model.embed_dim
    pdim = model.patch_size * model.patch_size * 3
    fl = 2.0 * (n - 1) * pdim * e                       # patch embed
    per_layer = (
        2.0 * n * e * (3 * e)                           # qkv proj
        + 2.0 * 2.0 * n * n * e                         # qk^T and pv
        + 2.0 * n * e * e                               # out proj
        + 2.0 * n * e * f * 2                           # mlp
    )
    fl += model.num_layers * per_layer
    fl += 2.0 * e * model.num_classes                   # head
    return fl


def vit_tiny(num_classes: int = 10, image_size: int = 32,
             patch_size: int = 4, **kw) -> ViT:
    """Test-sized ViT (CIFAR-scale)."""
    return ViT(num_classes=num_classes, image_size=image_size,
               patch_size=patch_size, embed_dim=64, num_heads=4,
               num_layers=2, **kw)


def vit_small(num_classes: int = 1000, **kw) -> ViT:
    return ViT(num_classes=num_classes, embed_dim=384, num_heads=6,
               num_layers=12, **kw)


def vit_b16(num_classes: int = 1000, **kw) -> ViT:
    return ViT(num_classes=num_classes, embed_dim=768, num_heads=12,
               num_layers=12, **kw)


def vit_l16(num_classes: int = 1000, **kw) -> ViT:
    return ViT(num_classes=num_classes, embed_dim=1024, num_heads=16,
               num_layers=24, **kw)
