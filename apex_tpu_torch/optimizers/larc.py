"""LARC, layer-wise adaptive rate control, as a wrapper of a fused
optimizer — counterpart of ``apex_tpu/optimizers/larc.py``.

Before the inner optimizer's update, each tensor's gradient gets weight
decay folded in and is scaled by its adaptive rate ``trust_coefficient ·
‖p‖ / (‖g‖ + wd·‖p‖ + eps)``, clipped to ``min(rate / lr, 1)`` in clip
mode, and left at 1 where either norm is 0. The inner optimizer then runs
with its groups' ``weight_decay`` at 0, restored afterwards even when the
update raises. The per-tensor norms are the row kernel and a fixed-order
sum over each segment's rows (``ops.kernels.l2norm_per_segment``); the
rate reaches each element through its row's segment id.

``apply_update`` is functional, as the base class's: the norms read the
masters of the ``state`` passed in. ``step`` and ``step_flat`` keep the
result in the inner optimizer's ``state``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import kernels as K
from apex_tpu_torch.ops.flat import LANES

__all__ = ["LARC"]


class LARC:
    def __init__(self, optimizer, trust_coefficient=0.02, clip=True,
                 eps=1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    # -- pass-throughs (the reference's LARC.py:44-76) ------------------------
    @property
    def param_groups(self):
        return self.optim.param_groups

    @property
    def state(self):
        return self.optim.state

    @state.setter
    def state(self, value):
        self.optim.state = value

    def state_dict(self):
        return self.optim.state_dict()

    def load_state_dict(self, d):
        self.optim.load_state_dict(d)

    def add_param_group(self, group):
        self.optim.add_param_group(group)

    def init_state(self):
        return self.optim.init_state()

    def params_tree(self):
        return self.optim.params_tree()

    def master_params_tree(self):
        return self.optim.master_params_tree()

    # -- the update --------------------------------------------------------------
    def _adapt(self, gidx: int, grad, master):
        """The grad with weight decay folded in, scaled by each tensor's
        adaptive rate, in the grad's dtype."""
        hp = self.optim.param_groups[gidx]
        wd = hp.get("weight_decay", 0.0)
        table = self.optim._tables[gidx]
        pnorm = K.l2norm_per_segment(master, table, aligned_segments=True)
        gnorm = K.l2norm_per_segment(grad, table, aligned_segments=True)
        rate = self.trust_coefficient * pnorm / (gnorm + pnorm * wd
                                                 + self.eps)
        if self.clip:
            rate = torch.clamp(rate / hp["lr"], max=1.0)
        rate = torch.where((pnorm != 0) & (gnorm != 0), rate,
                           torch.ones_like(rate))
        row_rate = rate[table.row_segment_ids(grad.device).long()][:, None]
        g = grad.float() + wd * master.float()
        return (g.view(-1, LANES) * row_rate).view(-1).to(grad.dtype)

    def apply_update(self, state, flat_grads, *, found_inf=None, scale=1.0):
        """New state from per-group flat grads; ``state`` is unchanged."""
        groups = self.optim.param_groups
        new_grads = [self._adapt(i, g, gs.master)
                     for i, (g, gs) in enumerate(zip(flat_grads, state))]
        saved = [hp.get("weight_decay", 0.0) for hp in groups]
        for hp in groups:
            hp["weight_decay"] = 0.0
        try:
            return self.optim.apply_update(state, new_grads,
                                           found_inf=found_inf, scale=scale)
        finally:
            for hp, wd in zip(groups, saved):
                hp["weight_decay"] = wd

    def step(self, grads, **kw):
        """One update from a grads tree; returns the new params tree."""
        return self.step_flat(self.optim.flatten_grads(grads), **kw)

    def step_flat(self, flat_grads, **kw):
        self.optim.state = self.apply_update(self.optim.state, flat_grads,
                                             **kw)
        return self.optim.params_tree()
