"""Fused MLP block — counterpart of ``apex_tpu/mlp/mlp.py`` (the API of
apex/mlp/mlp.py: ``mlp_sizes``, ``bias``, ``activation``).

The JAX module has no Pallas kernel: it writes the stack as one jitted
function and leaves the matmul + bias + activation fusion to XLA. So the
port is plain PyTorch too: ``torch.matmul`` per layer (cuBLAS on the card),
the bias add and the activation, under autograd. No hand kernel replaces
a TPU kernel here.

Weight convention as the reference: ``weight_i`` is ``(mlp_sizes[i+1],
mlp_sizes[i])`` (out_features, in_features) and inputs are ``(batch,
mlp_sizes[0])``; the activation follows every layer, the last included
(mlp_cuda's epilogue on each GEMM).
"""

from __future__ import annotations

import math
from typing import Union

import torch

from apex_tpu_torch._device import resolve_device

__all__ = ["MLP", "mlp"]

_ACTIVATIONS = ("none", "relu", "sigmoid")


def mlp(params: dict, x: torch.Tensor, *, num_layers: int,
        bias: bool = True, activation: str = "relu") -> torch.Tensor:
    """Functional whole-MLP forward (``MlpFunction.apply``'s analog):
    per layer ``h @ weight_i.T`` (weights cast to h's dtype), the bias
    and the activation, after every layer including the last.
    Differentiable in ``params`` and ``x``."""
    if activation not in _ACTIVATIONS:
        raise TypeError("activation must be 'none', 'relu' or 'sigmoid'")
    h = x
    for i in range(num_layers):
        h = h @ params[f"weight_{i}"].T.to(h.dtype)
        if bias:
            h = h + params[f"bias_{i}"].to(h.dtype)
        if activation == "relu":
            h = torch.relu(h)
        elif activation == "sigmoid":
            h = torch.sigmoid(h)
    return h


class MLP:
    """Analog of ``apex.mlp.MLP``: ``MLP([1024, 1024, 512])`` is two layers
    1024 -> 1024 -> 512. Functional::

        m = MLP([480, 1024, 1024, 512, 256, 1])
        params = m.init(torch.Generator().manual_seed(0))
        y = m.apply(params, x)

    ``init`` puts the parameters on ``device`` (the card unless
    ``device="cpu"``)."""

    def __init__(self, mlp_sizes, bias: bool = True,
                 activation: str = "relu",
                 param_dtype: torch.dtype = torch.float32, device=None):
        if activation not in _ACTIVATIONS:
            raise TypeError("activation must be 'none', 'relu' or 'sigmoid'")
        self.num_layers = len(mlp_sizes) - 1
        self.mlp_sizes = list(mlp_sizes)
        self.bias = bool(bias)
        self.activation = activation
        self.param_dtype = param_dtype
        self.device = resolve_device(device)

    def init(self, generator: Union[torch.Generator, int, None] = None
             ) -> dict:
        """Xavier-style normal init as the reference's reset_parameters
        (mlp.py:64-72): weight ~ N(0, 2/(fan_in+fan_out)), bias ~ N(0,
        1/fan_out), drawn on the CPU from ``generator`` (a
        ``torch.Generator`` or a seed; None is seed 0). The draws differ
        from ``jax.random``'s; to hold the packages on the same weights,
        convert the JAX dict with ``convert.params_from_jax``."""
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(
                0 if generator is None else int(generator))
        params = {}
        for i in range(self.num_layers):
            fan_in, fan_out = self.mlp_sizes[i], self.mlp_sizes[i + 1]
            w_std = math.sqrt(2.0 / (fan_in + fan_out))
            params[f"weight_{i}"] = w_std * torch.randn(
                (fan_out, fan_in), generator=generator)
            if self.bias:
                b_std = math.sqrt(1.0 / fan_out)
                params[f"bias_{i}"] = b_std * torch.randn(
                    (fan_out,), generator=generator)
        return {k: t.to(self.device, self.param_dtype)
                for k, t in params.items()}

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.mlp_sizes[0]:
            raise ValueError(
                f"input last dim {x.shape[-1]} != mlp_sizes[0] "
                f"{self.mlp_sizes[0]}")
        return mlp(params, x, num_layers=self.num_layers, bias=self.bias,
                   activation=self.activation)

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x)

    def extra_repr(self) -> str:
        return (f"MLP sizes: {self.mlp_sizes}, Bias={self.bias}, "
                f"activation={self.activation}")
