"""FusedSGD over flat buffers — counterpart of
``apex_tpu/optimizers/fused_sgd.py``.

SGD with momentum, dampening and nesterov; weight decay before the
momentum, or after it with ``wd_after_momentum``. One fused update per
param group through ``ops.kernels.sgd_step`` (the SGD kernel on the card).
The first step sets the momentum buffer to the incoming grad
(``first_run``: the step count after its increment is 1); that is a
device value, so the step never reads it back. The grad unscale and the
branchless overflow skip are the base class's.
"""

from __future__ import annotations

import dataclasses

from apex_tpu_torch.ops import kernels as K
from apex_tpu_torch.optimizers.base import FusedOptimizer, GroupState

__all__ = ["FusedSGD"]


class FusedSGD(FusedOptimizer):
    _slot_names = ("momentum_buffer",)

    def __init__(self, params, lr, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 materialize_master_grads=True, **kw):
        # materialize_master_grads: accepted for drop-in parity with the
        # reference; the flat store always holds fp32 master grads
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov)
        self.wd_after_momentum = wd_after_momentum
        super().__init__(params, defaults, **kw)

    def _update_group(self, gidx, grad, gs: GroupState, hp, lr, extras):
        p, mom = K.sgd_step(
            grad, gs.master, gs.slots["momentum_buffer"],
            wd=hp["weight_decay"], momentum=hp["momentum"],
            dampening=hp["dampening"], lr=lr, nesterov=hp["nesterov"],
            first_run=gs.step == 1,
            wd_after_momentum=self.wd_after_momentum)
        return dataclasses.replace(gs, master=p,
                                   slots={"momentum_buffer": mom})
