"""The one device rule of the port: entry points run on the card unless the
caller asks for the CPU, and never fall back to the CPU on their own."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without CUDA raises: the
    caller must pass ``device="cpu"`` to run the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        if dev.index is None:     # name the card, as tensor.device does
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
