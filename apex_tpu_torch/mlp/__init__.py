"""Fused MLP (counterpart of ``apex_tpu/mlp``)."""

from apex_tpu_torch.mlp.mlp import MLP, mlp  # noqa: F401

__all__ = ["MLP", "mlp"]
