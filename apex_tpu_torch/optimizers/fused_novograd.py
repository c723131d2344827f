"""FusedNovoGrad over flat buffers — counterpart of
``apex_tpu/optimizers/fused_novograd.py``.

The second moment is one value per tensor, stored as a norm (L2 or
L-inf, ``norm_type`` 2 or 0) in the ``exp_avg_sq`` slot of shape
``[num_segments]``. It starts as NaN, which marks "not seeded": the first
step puts the first grad's norms in its place, so the first blend leaves
them as they are; ``init_zero`` starts it at 0 instead. The grad's
per-tensor norms are taken once a step (the row kernel and a segment
pass) and serve both the seeding and the blend inside
``ops.kernels.novograd_step``, whose elementwise update is the NovoGrad
kernel on the card. ``reg_inside_moment`` picks weight decay inside the
moment (mode 0) or outside it (mode 1).
"""

from __future__ import annotations

import dataclasses

import torch

from apex_tpu_torch.ops import kernels as K
from apex_tpu_torch.optimizers.base import FusedOptimizer, GroupState

__all__ = ["FusedNovoGrad"]


class FusedNovoGrad(FusedOptimizer):
    _slot_names = ("exp_avg",)     # exp_avg_sq is per tensor: _new_group

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, reg_inside_moment=False,
                 grad_averaging=True, norm_type=2, init_zero=False,
                 set_grad_none=True, **kw):
        # set_grad_none: accepted for drop-in parity with the reference;
        # grads are values passed to step, so there is nothing to clear
        if amsgrad:
            raise RuntimeError(
                "FusedNovoGrad does not support the AMSGrad variant.")
        if norm_type not in (K.NORM_LINF, K.NORM_L2):
            raise RuntimeError("FusedNovoGrad only supports l2/inf norm.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging, norm_type=norm_type)
        self.moment_mode = K.MODE_L2 if reg_inside_moment \
            else K.MODE_DECOUPLED
        self.init_zero = init_zero
        super().__init__(params, defaults, **kw)

    def _new_group(self, tree) -> GroupState:
        gs = super()._new_group(tree)
        table = self._tables[-1]
        gs.slots["exp_avg_sq"] = torch.full(
            (table.num_segments,), 0.0 if self.init_zero else float("nan"),
            dtype=torch.float32, device=self.device)
        return gs

    def _update_group(self, gidx, grad, gs: GroupState, hp, lr, extras):
        beta1, beta2 = hp["betas"]
        table = self._tables[gidx]
        per_segment = K.maxnorm_per_segment \
            if hp["norm_type"] == K.NORM_LINF else K.l2norm_per_segment
        norms = per_segment(grad, table, aligned_segments=True)
        v = gs.slots["exp_avg_sq"]
        if not self.init_zero:
            v = torch.where(torch.isnan(v), norms, v)
        p, m, v = K.novograd_step(
            grad, gs.master, gs.slots["exp_avg"], v, table,
            aligned_segments=True,  # flat-store segments are 128-aligned
            lr=lr, beta1=beta1, beta2=beta2, eps=hp["eps"], step=gs.step,
            bias_correction=bool(hp["bias_correction"]),
            weight_decay=hp["weight_decay"],
            grad_averaging=bool(hp["grad_averaging"]),
            mode=self.moment_mode, norm_type=hp["norm_type"],
            grad_norms=norms)
        return dataclasses.replace(
            gs, master=p, slots={"exp_avg": m, "exp_avg_sq": v})
