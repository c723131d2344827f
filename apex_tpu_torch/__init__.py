"""apex_tpu_torch — the PyTorch + CUDA port of ``apex_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``apex_tpu`` stays beside this one as the reference; every
module here keeps the JAX module's name and place, so a reader can find
each counterpart. Plain tensor code is PyTorch; every Pallas kernel on a
ported path is a kernel written by hand for ``sm_90a`` (sources under
``ops/cuda/csrc``, built with ``nvcc`` at first use). Each kernel sits next
to a plain PyTorch version of the same function, which is what a tensor on
the CPU runs.

Ported so far: the serving path — ``models.TransformerLM`` decode and the
continuous-batching engine (``serve``) over the dense and paged KV arenas,
with the decode-attention and LayerNorm-forward kernels; and the ResNet
AMP FusedLAMB training step (``train.Trainer``: the flat master store
``ops.flat``, ``amp``, ``optimizers.FusedLAMB``, the ``parallel``
SyncBatchNorm core, ``models.ResNet``), with the unscale and two LAMB
kernels; the decoder-LM FusedAdam step (``train.LMTrainer``) with the
flash, LayerNorm-backward and Adam kernels; and the ImageNet example's
step (``Trainer(optimizer="sgd")`` on a uint8 batch normalized by
``data.normalize_imagenet``, ``Trainer.evaluate``), with
``optimizers.FusedSGD``, ``FusedNovoGrad`` and ``LARC`` and the SGD,
NovoGrad and per-row norm kernels; the Seq2Seq Transformer's translation
step, with the softmax cross-entropy kernels; and gradient accumulation
(``LMTrainer(microbatches=...)``, ``amp``'s ``accumulate_grads``) and the
legacy ``fp16_utils`` (``FP16_Optimizer`` with clipping over
``optimizers.FusedAdagrad``, the overflow census of ``prof``), with the
axpby, L2-norm and Adagrad kernels.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.

Submodules import lazily, so ``import apex_tpu_torch`` is cheap.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_SUBMODULES = ("amp", "contrib", "convert", "data", "fp16_utils", "mlp",
               "models", "normalization", "ops", "optimizers", "parallel",
               "prof", "serve", "train")

__all__ = list(_SUBMODULES)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
