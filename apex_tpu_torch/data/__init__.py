"""On-device input normalization — the part of ``apex_tpu/data`` that the
ImageNet training step runs (``apex_tpu/data/__init__.py:58-64``): a
uint8 NHWC batch becomes ``(x - mean) / std`` over the trailing channel
axis inside the step, as ``examples/imagenet/main_amp.py:239-245`` does.
The loaders and the native pipeline are not ported yet.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["normalize_imagenet", "IMAGENET_MEAN", "IMAGENET_STD"]

# the reference example's constants, scaled to 0-255 inputs
IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


@functools.lru_cache(maxsize=None)
def _stats(mean: tuple, std: tuple, device: torch.device) -> tuple:
    # one host-to-device copy per (constants, device), not per step
    return (torch.tensor(mean, dtype=torch.float32).to(device),
            torch.tensor(std, dtype=torch.float32).to(device))


def normalize_imagenet(x: torch.Tensor, mean=IMAGENET_MEAN,
                       std=IMAGENET_STD, dtype=None) -> torch.Tensor:
    """``(x - mean) / std`` in fp32 over the trailing channel axis, on x's
    device, cast to ``dtype`` when given."""
    m, s = _stats(tuple(mean), tuple(std), x.device)
    out = (x.float() - m) / s
    return out.to(dtype) if dtype is not None else out
