"""FusedAdam over flat buffers — counterpart of
``apex_tpu/optimizers/fused_adam.py``.

One fused update per param group through ``ops.kernels.adam_step`` (the
Adam kernel on the card); ``adam_w_mode`` selects decoupled weight decay.
The branchless overflow skip is the base class's.
"""

from __future__ import annotations

import dataclasses

from apex_tpu_torch.ops import kernels as K
from apex_tpu_torch.optimizers.base import FusedOptimizer, GroupState

__all__ = ["FusedAdam"]


class FusedAdam(FusedOptimizer):
    _slot_names = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, **kw):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        self.adam_w_mode = adam_w_mode
        super().__init__(params, defaults, **kw)

    def _update_group(self, gidx, grad, gs: GroupState, hp, lr, extras):
        beta1, beta2 = hp["betas"]
        p, m, v = K.adam_step(
            grad, gs.master, gs.slots["exp_avg"], gs.slots["exp_avg_sq"],
            lr=lr, beta1=beta1, beta2=beta2, eps=hp["eps"], step=gs.step,
            mode=K.MODE_DECOUPLED if self.adam_w_mode else K.MODE_L2,
            bias_correction=bool(hp["bias_correction"]),
            weight_decay=hp["weight_decay"])
        return dataclasses.replace(
            gs, master=p, slots={"exp_avg": m, "exp_avg_sq": v})
