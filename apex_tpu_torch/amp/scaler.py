"""Loss scaler with its state on the device — counterpart of
``apex_tpu/amp/scaler.py``.

The whole lifecycle stays on the card, as in the JAX package: the state is
a dataclass of 0-d device tensors; ``unscale`` returns the overflow flag
as a device bool from the ``scale`` kernel; the dynamic update (halve on
overflow, double after ``scale_window`` clean steps) is branchless
``torch.where``; the step skip is the optimizer choosing old or new state
on the same flag. Nothing here reads a value back to the host except
``state_dict``.

Defaults are the reference's: init 2**16, factor 2, window 2000, max
2**24.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp.policy import AmpError
from apex_tpu_torch.ops import multi_tensor as MT

__all__ = ["ScalerState", "LossScaler"]


@dataclasses.dataclass
class ScalerState:
    """Device-resident scaler state: ``scale`` fp32, the rest int32, all
    0-d. ``None`` counters are not tracked and stay ``None``."""
    scale: torch.Tensor
    unskipped: torch.Tensor       # clean steps since the last growth/overflow
    step_count: Optional[torch.Tensor] = None      # update() calls
    overflow_count: Optional[torch.Tensor] = None  # overflow = skip = backoff
    growth_count: Optional[torch.Tensor] = None    # scale-growth events


@dataclasses.dataclass(frozen=True)
class LossScaler:
    """Static scaler config and its ops over :class:`ScalerState`;
    ``dynamic=False`` keeps a static scale (``update`` then only counts)."""

    dynamic: bool = True
    init_scale: float = 2.0 ** 16
    scale_factor: float = 2.0
    scale_window: int = 2000
    min_loss_scale: Optional[float] = None
    max_loss_scale: float = 2.0 ** 24

    @classmethod
    def from_policy(cls, policy, min_loss_scale=None,
                    max_loss_scale=2.0 ** 24) -> "LossScaler":
        if min_loss_scale is not None:
            try:
                mls = float(min_loss_scale)
            except (TypeError, ValueError):
                raise AmpError(
                    f"min_loss_scale must be a positive number or None, "
                    f"got {min_loss_scale!r}")
            if not mls > 0.0:
                raise AmpError(f"min_loss_scale must be > 0 (got {mls}); "
                               f"use None for no floor")
            if mls > max_loss_scale:
                raise AmpError(
                    f"min_loss_scale ({mls}) exceeds max_loss_scale "
                    f"({max_loss_scale}): the backoff floor would sit "
                    f"above the growth ceiling and the scale could never "
                    f"satisfy both")
            min_loss_scale = mls
        if policy.is_dynamic:
            return cls(dynamic=True, min_loss_scale=min_loss_scale,
                       max_loss_scale=max_loss_scale)
        return cls(dynamic=False, init_scale=policy.static_scale)

    def init(self, device=None) -> ScalerState:
        """Fresh state on ``device`` (the card unless ``device="cpu"``)."""
        dev = resolve_device(device)

        def zero():
            return torch.zeros((), dtype=torch.int32, device=dev)
        return ScalerState(
            scale=torch.full((), self.init_scale, dtype=torch.float32,
                             device=dev),
            unskipped=zero(), step_count=zero(), overflow_count=zero(),
            growth_count=zero())

    def scale_loss(self, loss: torch.Tensor, state: ScalerState):
        """``loss * scale`` in fp32."""
        return loss.float() * state.scale

    def unscale(self, flat_grads: torch.Tensor, state: ScalerState):
        """``(grads / scale, found_inf)``; the flag reads the incoming
        grads (the ``scale`` kernel on the card)."""
        return MT.scale(flat_grads, 1.0 / state.scale)

    def unscale_with_stashed(self, new_flat_grads, stashed_master, state):
        raise NotImplementedError(
            "unscale_with_stashed needs the axpby kernel, which is not "
            "ported yet (ROADMAP.md Queue 1, slice 3)")

    def update(self, state: ScalerState, found_inf) -> ScalerState:
        """Branchless dynamic adjustment and event counting
        (scaler.py:134-165)."""
        overflow = torch.as_tensor(found_inf).to(torch.bool)
        counters = {}
        if state.step_count is not None:
            counters["step_count"] = state.step_count + 1
            counters["overflow_count"] = (state.overflow_count
                                          + overflow.to(torch.int32))
        if not self.dynamic:
            return dataclasses.replace(state, **counters) if counters \
                else state
        scale, unskipped = state.scale, state.unskipped
        down = scale / self.scale_factor
        if self.min_loss_scale is not None:
            down = torch.clamp(down, min=self.min_loss_scale)
        unskipped = torch.where(overflow, torch.zeros_like(unskipped),
                                unskipped + 1)
        grow = unskipped >= self.scale_window
        up = torch.clamp(scale * self.scale_factor, max=self.max_loss_scale)
        new_scale = torch.where(overflow, down, torch.where(grow, up, scale))
        unskipped = torch.where(grow, torch.zeros_like(unskipped), unskipped)
        if state.growth_count is not None:
            counters["growth_count"] = (state.growth_count
                                        + grow.to(torch.int32))
        return dataclasses.replace(state, scale=new_scale,
                                   unskipped=unskipped, **counters)

    def update_with_census(self, state, found_inf, grads, census=None, *,
                           table=None):
        raise NotImplementedError(
            "update_with_census needs the numerics census of prof/, which "
            "is not ported yet (ROADMAP.md Queue 1, slice 8)")

    # -- checkpoint facade ---------------------------------------------------
    def state_dict(self, state: ScalerState) -> dict:
        """Host-side dict: the one place the scaler reads the card."""
        d = {"loss_scale": float(state.scale),
             "unskipped": int(state.unskipped)}
        for k in ("step_count", "overflow_count", "growth_count"):
            v = getattr(state, k)
            if v is not None:
                d[k] = int(v)
        return d

    def load_state_dict(self, d: dict, device=None) -> ScalerState:
        dev = resolve_device(device)

        def i32(k):
            return torch.tensor(d.get(k, 0), dtype=torch.int32, device=dev)
        return ScalerState(
            scale=torch.tensor(d["loss_scale"], dtype=torch.float32,
                               device=dev),
            unskipped=torch.tensor(d["unskipped"], dtype=torch.int32,
                                   device=dev),
            step_count=i32("step_count"), overflow_count=i32("overflow_count"),
            growth_count=i32("growth_count"))
