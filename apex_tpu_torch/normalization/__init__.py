"""Fused normalization layers (counterpart of
``apex_tpu/normalization``)."""

from apex_tpu_torch.normalization.fused_layer_norm import (  # noqa: F401
    FusedLayerNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
)
