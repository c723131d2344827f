"""FusedLAMB over flat buffers — counterpart of
``apex_tpu/optimizers/fused_lamb.py``.

The global grad norm is taken across every param group in plain PyTorch
(fused_lamb.py:41-46), then each group runs the two-phase LAMB update
through ``ops.kernels.lamb_step`` (the LAMB kernels on the card) with its
segment table's row-aligned per-tensor norms.
"""

from __future__ import annotations

import dataclasses

import torch

from apex_tpu_torch.ops import kernels as K
from apex_tpu_torch.optimizers.base import FusedOptimizer, GroupState

__all__ = ["FusedLAMB"]


class FusedLAMB(FusedOptimizer):
    _slot_names = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 max_grad_norm=1.0, use_nvlamb=False, **kw):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        max_grad_norm=max_grad_norm)
        self.adam_w_mode = adam_w_mode
        self.use_nvlamb = use_nvlamb
        super().__init__(params, defaults, **kw)

    def _pre_update(self, flat_grads, scale):
        sq = sum(torch.sum(torch.square(g.float())) for g in flat_grads)
        return {"global_grad_norm": torch.sqrt(sq)}

    def _update_group(self, gidx, grad, gs: GroupState, hp, lr, extras):
        beta1, beta2 = hp["betas"]
        p, m, v = K.lamb_step(
            grad, gs.master, gs.slots["exp_avg"], gs.slots["exp_avg_sq"],
            self._tables[gidx],
            aligned_segments=True,  # flat-store segments are 128-aligned
            lr=lr, beta1=beta1, beta2=beta2, eps=hp["eps"], step=gs.step,
            bias_correction=bool(hp["bias_correction"]),
            weight_decay=hp["weight_decay"],
            grad_averaging=bool(hp["grad_averaging"]),
            mode=K.MODE_DECOUPLED if self.adam_w_mode else K.MODE_L2,
            global_grad_norm=extras["global_grad_norm"],
            max_grad_norm=hp["max_grad_norm"], use_nvlamb=self.use_nvlamb)
        return dataclasses.replace(
            gs, master=p, slots={"exp_avg": m, "exp_avg_sq": v})
