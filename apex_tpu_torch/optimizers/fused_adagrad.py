"""FusedAdagrad over flat buffers — counterpart of
``apex_tpu/optimizers/fused_adagrad.py``.

One fused update per param group through ``ops.kernels.adagrad_step``
(the Adagrad kernel on the card) with the accumulated square sum in the
``"sum"`` slot; ``adagrad_w_mode`` selects decoupled weight decay, else
it is folded into the gradient (L2). The grad unscale and the branchless
overflow skip are the base class's.
"""

from __future__ import annotations

import dataclasses

from apex_tpu_torch.ops import kernels as K
from apex_tpu_torch.optimizers.base import FusedOptimizer, GroupState

__all__ = ["FusedAdagrad"]


class FusedAdagrad(FusedOptimizer):
    _slot_names = ("sum",)

    def __init__(self, params, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 set_grad_none=True, adagrad_w_mode=False, **kw):
        defaults = dict(lr=lr, eps=eps, weight_decay=weight_decay)
        self.adagrad_w_mode = adagrad_w_mode
        # accepted for the reference's signature: grads are values passed
        # to step, so there is nothing to clear
        self.set_grad_none = bool(set_grad_none)
        super().__init__(params, defaults, **kw)

    def _update_group(self, gidx, grad, gs: GroupState, hp, lr, extras):
        p, h = K.adagrad_step(
            grad, gs.master, gs.slots["sum"], lr=lr, eps=hp["eps"],
            mode=K.MODE_DECOUPLED if self.adagrad_w_mode else K.MODE_L2,
            weight_decay=hp["weight_decay"])
        return dataclasses.replace(gs, master=p, slots={"sum": h})
