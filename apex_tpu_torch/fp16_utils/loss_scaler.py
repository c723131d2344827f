"""Standalone static and dynamic loss scalers — counterpart of
``apex_tpu/fp16_utils/loss_scaler.py`` (:22-115).

Both are facades over the device-resident :class:`apex_tpu_torch.amp.
scaler.LossScaler`: the state stays on the device, the unscale is the
``scale`` kernel, and the legacy ``has_overflow`` / ``update_scale``
protocol reads the flag on the host, as the reference does. On an
overflow, ``update_scale`` queues an ``amp_overflow`` record, naming the
offending leaves when the grads were passed in.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp.scaler import LossScaler as _AmpScaler
from apex_tpu_torch.ops import flat as _flat
from apex_tpu_torch.ops import multi_tensor as MT

__all__ = ["LossScaler", "DynamicLossScaler"]


class _ScalerBase:
    def __init__(self, cfg: _AmpScaler, device=None):
        self._cfg = cfg
        self._state = cfg.init(device)
        self._last_overflow = torch.zeros((), dtype=torch.bool,
                                          device=self._state.scale.device)
        # held by reference: the next overflowing update_scale names the
        # offending leaves from them
        self._last_grads = None
        self.last_culprits: list = []

    @property
    def loss_scale(self) -> float:
        return float(self._state.scale)

    def scale_loss(self, loss):
        """``loss * loss_scale`` in fp32 (loss_scaler.py:40-43)."""
        return self._cfg.scale_loss(loss, self._state)

    def unscale(self, flat_grads):
        """grads / scale, the overflow flag kept for ``update_scale``
        (loss_scaler.py:45-50)."""
        out, found_inf = self._cfg.unscale(flat_grads, self._state)
        self._last_overflow = found_inf
        return out

    def has_overflow(self, grads=None) -> bool:
        """Whether the last grads seen had a nonfinite element
        (loss_scaler.py:52-61); passing ``grads`` (a tree or a flat
        buffer) checks them and keeps them for provenance."""
        if grads is not None:
            self._last_grads = grads
            self._last_overflow = ~MT.all_finite(*_flat.tree_leaves(grads))
        return bool(self._last_overflow)

    def update_scale(self, overflow=None, grads=None):
        """Back off or grow the scale (loss_scaler.py:63-90). On an
        overflow, queues an ``amp_overflow`` record (with ``culprits``
        when grads were passed here or to ``has_overflow``); the census
        is taken on overflow steps only."""
        if grads is not None:
            self.has_overflow(grads)
        ov = self._last_overflow if overflow is None \
            else torch.as_tensor(overflow)
        step_at_overflow = self._state.step_count
        scale_at_overflow = self._state.scale
        self._state = self._cfg.update(self._state, ov)
        if bool(ov):
            from apex_tpu_torch.prof import metrics as M
            fields = {"loss_id": 0, "source": "fp16_utils",
                      "loss_scale": float(scale_at_overflow)}
            if self._last_grads is not None:
                from apex_tpu_torch.prof import numerics as N
                census = N.grad_census(self._last_grads,
                                       step=step_at_overflow)
                self.last_culprits = N.culprit_table(
                    N.tree_meta(self._last_grads), census)
                fields["culprits"] = self.last_culprits
                step = int(census.step)
                if step >= 0:
                    fields["step"] = step
            M.note_kind("amp_overflow", **fields)

    def state_dict(self) -> dict:
        return self._cfg.state_dict(self._state)

    def load_state_dict(self, d: dict):
        self._state = self._cfg.load_state_dict(
            d, self._state.scale.device)


class LossScaler(_ScalerBase):
    """Static scaler (loss_scaler.py:99-104): ``update_scale`` only
    counts. Its state lives on ``device``, the card unless
    ``device="cpu"``."""

    def __init__(self, scale: float = 1.0, device=None):
        super().__init__(_AmpScaler(dynamic=False, init_scale=scale), device)


class DynamicLossScaler(_ScalerBase):
    """Dynamic scaler (loss_scaler.py:107-115): halve on overflow, double
    after ``scale_window`` clean steps."""

    def __init__(self, init_scale: float = 2.0 ** 32,
                 scale_factor: float = 2.0, scale_window: int = 1000,
                 device=None):
        super().__init__(_AmpScaler(dynamic=True, init_scale=init_scale,
                                    scale_factor=scale_factor,
                                    scale_window=scale_window), device)
