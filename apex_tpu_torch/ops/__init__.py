"""Kernel layer of the port (counterpart of ``apex_tpu/ops``): the dispatch
rule, the CUDA build, and one module per kernel with its plain PyTorch
version."""

from apex_tpu_torch.ops import dispatch  # noqa: F401
