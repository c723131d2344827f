"""The DCGAN example's generator and discriminator — counterpart of the
models of ``examples/dcgan/main_amp.py`` (:73-113) and its loss
(:133-135).

Both are inline convolutions over 32×32×3 NHWC images, with no
BatchNorm:

- G: the latent [B, nz] @ fc, seen as [B, 4, 4, 4·ngf], then three
  up-convolutions (2× nearest resize, a 4×4 SAME convolution at stride
  1), ReLU between them and tanh at the end;
- D: three 4×4 SAME convolutions at stride 2 with leaky ReLU (0.2), the
  [B, 4·4·4·ndf] flattening in NHWC order, and fc to one logit.

Parameters keep the JAX names, shapes and layouts (conv kernels HWIO, fc
``[in, out]``), so ``convert.params_from_jax`` takes the example's trees
as they are. Inside, activations are NCHW views of the NHWC tensors and
the convolutions ``models.resnet.conv`` (cuDNN's ``F.conv2d``; SAME
padding of a 4×4 kernel is (1, 2) at stride 1 and (1, 1) at stride 2). The
2× nearest resize is ``F.interpolate(..., mode="nearest")``, which picks
source index ``i // 2`` as ``jax.image.resize`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models.resnet import conv
from apex_tpu_torch.models.transformer import _tree_to

__all__ = ["DCGAN", "bce_logits"]


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross entropy of ``logits`` against a constant target,
    in the stable form of main_amp.py:133-135."""
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class DCGAN:
    """The example's G and D at its widths (``--nz 64 --ngf 32 --ndf 32``
    by default); ``device`` is where the inits put the parameters, the card
    unless ``device="cpu"``."""

    nz: int = 64
    ngf: int = 32
    ndf: int = 32
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _normal(self, generator, shapes: dict) -> dict:
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        p = {k: torch.randn(s, generator=generator) * 0.02
             for k, s in shapes.items()}
        return _tree_to(p, self.device, torch.float32)

    def g_init(self, generator: Union[torch.Generator, int] = 1) -> dict:
        """G's parameters, N(0, 0.02²) with the JAX names and shapes, drawn
        on the CPU from ``generator`` (a ``torch.Generator`` or a seed)."""
        g = self.ngf
        return self._normal(generator, {
            "fc": (self.nz, 4 * 4 * g * 4), "c1": (4, 4, g * 4, g * 2),
            "c2": (4, 4, g * 2, g), "c3": (4, 4, g, 3)})

    def d_init(self, generator: Union[torch.Generator, int] = 2) -> dict:
        """D's parameters, as :meth:`g_init`."""
        d = self.ndf
        return self._normal(generator, {
            "c1": (4, 4, 3, d), "c2": (4, 4, d, d * 2),
            "c3": (4, 4, d * 2, d * 4), "fc": (4 * 4 * d * 4, 1)})

    def generator(self, p: dict, z: torch.Tensor) -> torch.Tensor:
        """z [B, nz] -> images [B, 32, 32, 3] NHWC in (-1, 1)."""
        h = (z @ p["fc"]).reshape(-1, 4, 4, self.ngf * 4)
        h = _nchw(F.relu(h))
        for name in ("c1", "c2"):
            h = F.relu(self._upconv(h, p[name]))
        return _nhwc(torch.tanh(self._upconv(h, p["c3"])))

    @staticmethod
    def _upconv(x, w):
        y = F.interpolate(x, scale_factor=2, mode="nearest")
        return conv(w, y, stride=1, padding="SAME")

    def discriminator(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """images [B, 32, 32, 3] NHWC -> logits [B]."""
        h = _nchw(x)
        for name in ("c1", "c2", "c3"):
            h = F.leaky_relu(conv(p[name], h, stride=2, padding="SAME"),
                             0.2)
        return (_nhwc(h).reshape(h.shape[0], -1) @ p["fc"])[:, 0]
