"""Models of the port (counterpart of ``apex_tpu/models``): the
``TransformerLM``, the ``Seq2SeqTransformer``, the ``ResNet`` family
(``analytic_flops`` is ResNet's), the ``ViT`` family (its FLOP count is
``models.vit.analytic_flops``) and the DCGAN example's G and D
(``DCGAN``, ``bce_logits``). Names import lazily."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "TransformerLM": "transformer", "Seq2SeqTransformer": "seq2seq",
    "ResNet": "resnet", "analytic_flops": "resnet", "resnet18": "resnet",
    "resnet34": "resnet", "resnet50": "resnet", "resnet101": "resnet",
    "resnet152": "resnet", "ViT": "vit", "vit_tiny": "vit",
    "vit_small": "vit", "vit_b16": "vit", "vit_l16": "vit",
    "DCGAN": "dcgan", "bce_logits": "dcgan",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
