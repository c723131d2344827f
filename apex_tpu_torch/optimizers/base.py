"""Fused-optimizer base — counterpart of ``apex_tpu/optimizers/base.py``:
a param-group facade over flat fp32 master buffers.

Construction flattens each param group into one master buffer and one
``SegmentTable``; the update runs over the flat buffers. AMP enters as
arguments: ``scale`` folds the grad unscale into the update, and
``found_inf`` (a device bool) selects the old or the new state with
``torch.where``, so an overflowing step leaves masters, slots and
``step`` as they were without the host reading the flag.

The functional core (``init_state`` / ``apply_update``) returns new
state and never changes the state it is given; the stateful facade
(``step`` / ``step_flat``) keeps the result in ``self.state``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops import flat as _flat

__all__ = ["GroupState", "FusedOptimizer"]


def _canon_hp(hp: dict) -> dict:
    """Sequence hyperparameters (betas) as tuples at every entry point."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in hp.items()}


@dataclasses.dataclass
class GroupState:
    """Device state of one param group: flat master params, the
    optimizer's slots (flat buffers of the same length) and the step
    count (0-d int32)."""
    master: torch.Tensor
    slots: dict
    step: torch.Tensor


class FusedOptimizer:
    """Base class; subclasses define ``_slot_names`` and ``_update_group``.

    ``params`` is a tree of tensors (one group) or apex-style group dicts
    ``{"params": tree, **hyperparameters}``. The masters live on
    ``device`` (the card unless ``device="cpu"``).
    """

    _slot_names: Sequence[str] = ()

    def __init__(self, params, defaults: dict, *, model_dtype=None,
                 master_dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        if isinstance(params, (list, tuple)) and params and \
                isinstance(params[0], dict):
            groups = [dict(g) for g in params]
        else:
            groups = [{"params": params}]
        self.defaults = _canon_hp(dict(defaults))
        self.model_dtype = model_dtype
        self.master_dtype = master_dtype
        self.param_groups: list = []
        self._tables: list = []
        states = []
        for g in groups:
            tree = g.pop("params")
            self.param_groups.append(_canon_hp({**self.defaults, **g}))
            states.append(self._new_group(tree))
        self.state: tuple = tuple(states)

    def _new_group(self, tree) -> GroupState:
        tree = _flat.tree_map(
            lambda x: torch.as_tensor(x).to(self.device), tree)
        buf, table = _flat.flatten(tree, dtype=self.master_dtype)
        self._tables.append(table)
        return GroupState(master=buf, slots={
            name: torch.zeros_like(buf) for name in self._slot_names},
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    # -- functional core -----------------------------------------------------
    def _update_group(self, gidx: int, grad, gs: GroupState, hp: dict, lr,
                      extras: dict) -> GroupState:
        raise NotImplementedError

    def _pre_update(self, flat_grads: list, scale) -> dict:
        """Cross-group quantities (LAMB's global grad norm)."""
        return {}

    def _step_impl(self, state, flat_grads, lrs, found_inf, scale):
        # the unscale folds in before _pre_update, so norms are in
        # unscaled units; a scale of exactly 1.0 is skipped (x * 1.0 == x)
        if not (isinstance(scale, (int, float)) and scale == 1.0):
            flat_grads = [(g.float() * scale).to(g.dtype)
                          for g in flat_grads]
        extras = self._pre_update(flat_grads, scale)
        if found_inf is not None:
            # a device bool, or accumulate_grads' fp32 0/1 (JAX's)
            found_inf = torch.as_tensor(found_inf).to(torch.bool)
        new_states = []
        for i, (gs, g) in enumerate(zip(state, flat_grads)):
            new_gs = self._update_group(
                i, g, dataclasses.replace(gs, step=gs.step + 1),
                self.param_groups[i], lrs[i], extras)
            if found_inf is not None:
                # branchless skip: on overflow keep the old state and do
                # not advance the step (base.py:154-163)
                def keep(old, new):
                    return torch.where(found_inf, old, new)
                new_gs = GroupState(
                    master=keep(gs.master, new_gs.master),
                    slots={k: keep(gs.slots[k], v)
                           for k, v in new_gs.slots.items()},
                    step=keep(gs.step, new_gs.step))
            new_states.append(new_gs)
        return tuple(new_states)

    def _lrs(self) -> list:
        return [float(hp.get("lr", self.defaults.get("lr", 1e-3)))
                for hp in self.param_groups]

    def init_state(self) -> tuple:
        """A copy of the current state for functional callers."""
        return tuple(GroupState(
            master=gs.master.clone(),
            slots={k: v.clone() for k, v in gs.slots.items()},
            step=gs.step.clone()) for gs in self.state)

    def apply_update(self, state, flat_grads: list, *, found_inf=None,
                     scale=1.0) -> tuple:
        """New state from per-group flat grads; ``state`` is unchanged."""
        return self._step_impl(state, list(flat_grads), self._lrs(),
                               found_inf, scale)

    # -- stateful facade ------------------------------------------------------
    def flatten_grads(self, grads) -> list:
        """Grads as a tree matching construction (one group) or a list of
        per-group trees, flattened to the masters' dtype."""
        if len(self._tables) == 1:
            trees = [grads]
        else:
            if not isinstance(grads, (list, tuple)) or \
                    len(grads) != len(self._tables):
                raise ValueError(
                    f"optimizer has {len(self._tables)} param groups; pass "
                    f"a list of {len(self._tables)} grad trees")
            trees = list(grads)
        return [_flat.flatten(t, table=tab, dtype=self.master_dtype)[0]
                for t, tab in zip(trees, self._tables)]

    def step(self, grads, *, found_inf=None, scale=1.0):
        """One update from a grads tree; returns the new params tree."""
        return self.step_flat(self.flatten_grads(grads),
                              found_inf=found_inf, scale=scale)

    def step_flat(self, flat_grads: list, *, found_inf=None, scale=1.0):
        """One update from per-group flat grads."""
        self.state = self.apply_update(self.state, flat_grads,
                                       found_inf=found_inf, scale=scale)
        return self.params_tree()

    # -- views ---------------------------------------------------------------
    def _trees(self, dtype=None) -> list:
        return [_flat.unflatten(gs.master, tab, dtype=dtype)
                for gs, tab in zip(self.state, self._tables)]

    def params_tree(self):
        """Current params in the model dtype (the masters' when unset)."""
        trees = self._trees(dtype=self.model_dtype)
        return trees[0] if len(trees) == 1 else trees

    def master_params_tree(self):
        trees = self._trees()
        return trees[0] if len(trees) == 1 else trees

    def zero_grad(self):
        """No-op, for the reference's API: grads are values passed to
        ``step``, not buffers to clear."""

    def set_lr(self, lr: float, group: Optional[int] = None):
        if group is None:
            for hp in self.param_groups:
                hp["lr"] = float(lr)
        else:
            self.param_groups[group]["lr"] = float(lr)

    def add_param_group(self, group: dict):
        g = dict(group)
        tree = g.pop("params")
        self.param_groups.append(_canon_hp({**self.defaults, **g}))
        self.state = (*self.state, self._new_group(tree))

    # -- checkpointing --------------------------------------------------------
    def state_dict(self) -> dict:
        """Host copies of every group's masters, slots and step."""
        return {"param_groups": [dict(hp) for hp in self.param_groups],
                "groups": [{"master": gs.master.detach().cpu().clone(),
                            "slots": {k: v.detach().cpu().clone()
                                      for k, v in gs.slots.items()},
                            "step": int(gs.step)} for gs in self.state]}

    def load_state_dict(self, d: dict):
        self.param_groups = [_canon_hp(dict(hp)) for hp in d["param_groups"]]
        dev = self.device
        self.state = tuple(GroupState(
            master=torch.as_tensor(gs["master"]).to(dev),
            slots={k: torch.as_tensor(v).to(dev)
                   for k, v in gs["slots"].items()},
            step=torch.tensor(gs["step"], dtype=torch.int32, device=dev))
            for gs in d["groups"])
