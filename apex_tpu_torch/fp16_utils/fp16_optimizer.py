"""FP16_Optimizer — counterpart of ``apex_tpu/fp16_utils/fp16_optimizer.py``
(:33-195): the legacy "wrap any optimizer" mixed-precision wrapper.

It wraps a :class:`apex_tpu_torch.optimizers.FusedOptimizer`, which owns
the flat fp32 masters, and adds the loss-scaler sequence::

    opt = FP16_Optimizer(FusedAdagrad(params, model_dtype=torch.bfloat16),
                         dynamic_loss_scale=True)
    grads = torch.autograd.grad(opt.scale_loss(loss), half_params)
    grads, norm = opt.clip_master_grads(1.0, grads)   # optional
    params = opt.step(grads)

``step`` unscales each group's flat grad (the ``scale`` kernel), updates
through ``step_flat`` with the overflow flag (skipped branchlessly on an
overflow), updates the scaler, and reads the flag on the host
(``self.overflow``), as the JAX package and the reference do. On an
overflow with ``track_numerics`` it names the offending leaves in
``last_culprits`` and queues an ``amp_overflow`` record.
``clip_master_grads`` takes the global L2 norm with the ``l2norm`` kernel
and scales each grad leaf with the ``scale`` kernel, one launch a leaf,
as JAX maps it over the tree.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.amp.scaler import LossScaler as _AmpScaler
from apex_tpu_torch.fp16_utils.fp16util import to_python_float
from apex_tpu_torch.ops import flat as _flat
from apex_tpu_torch.ops import kernels as K

__all__ = ["FP16_Optimizer"]


class FP16_Optimizer:
    def __init__(self, init_optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = False, track_numerics: bool = True):
        self.optimizer = init_optimizer
        self._track_numerics = bool(track_numerics)
        self.last_culprits: list = []
        if dynamic_loss_scale:
            args = dict(dynamic_loss_args or {})
            self.loss_scaler = _AmpScaler(
                dynamic=True,
                init_scale=args.get("init_scale", 2.0 ** 16),
                scale_factor=args.get("scale_factor", 2.0),
                scale_window=args.get("scale_window", 2000))
        else:
            self.loss_scaler = _AmpScaler(dynamic=False,
                                          init_scale=static_loss_scale)
        self.scaler_state = self.loss_scaler.init(init_optimizer.device)
        self.overflow = False
        self.first_closure_call_this_step = True   # the reference's API
        self._verbose = verbose

    # -- the reference's API --------------------------------------------------
    @property
    def loss_scale(self) -> float:
        return to_python_float(self.scaler_state.scale)

    def scale_loss(self, loss):
        """``loss * scale`` in fp32 (the functional form of
        ``optimizer.backward(loss)``)."""
        return self.loss_scaler.scale_loss(loss, self.scaler_state)

    backward = scale_loss

    def step(self, grads, closure=None):
        """Unscale, detect overflow, update (or skip), adjust the scale
        (fp16_optimizer.py:76-115). ``grads`` is the grads tree of the
        SCALED loss; returns the updated model params."""
        if closure is not None:
            raise NotImplementedError(
                "closure-based step is not supported on the functional core")
        flat_grads = self.optimizer.flatten_grads(grads)
        found_inf = None
        unscaled = []
        for fg in flat_grads:
            out, fi = self.loss_scaler.unscale(fg, self.scaler_state)
            unscaled.append(out)
            found_inf = fi if found_inf is None else (found_inf | fi)
        step_at_overflow = self.scaler_state.step_count
        scale_at_overflow = self.scaler_state.scale
        params = self.optimizer.step_flat(unscaled, found_inf=found_inf)
        self.scaler_state = self.loss_scaler.update(self.scaler_state,
                                                    found_inf)
        self.overflow = bool(found_inf)
        if self.overflow and self._track_numerics:
            # the census only on a skipped step: the flag is already on
            # the host, and clean steps pay nothing
            from apex_tpu_torch.prof import metrics as _m
            from apex_tpu_torch.prof import numerics as _n
            census = _n.grad_census(grads, step=step_at_overflow)
            self.last_culprits = _n.culprit_table(_n.tree_meta(grads),
                                                  census)
            fields = {"loss_id": 0, "source": "fp16_optimizer",
                      "culprits": self.last_culprits,
                      "loss_scale": float(scale_at_overflow)}
            step = int(census.step)
            if step >= 0:
                fields["step"] = step
            _m.note_kind("amp_overflow", **fields)
        if self.overflow and self._verbose:
            print(f"OVERFLOW! Skipping step. Reducing loss scale to "
                  f"{self.loss_scale}")
        return params

    def update_master_grads(self, *a, **k):
        """No-op: ``step`` makes the master grads (``flatten_grads``)."""

    def clip_master_grads(self, max_norm, grads=None, norm_type=2):
        """Clip the grads to a global L2 norm of ``max_norm``
        (fp16_optimizer.py:121-163). ``grads`` is the grads tree of the
        SCALED loss; returns ``(clipped_grads, total_norm)`` with
        ``total_norm`` the UNSCALED fp32 global norm (a device scalar).
        Each group's norm is the ``l2norm`` kernel over its flat grad,
        unscaled as a scalar; each leaf is multiplied by ``min(max_norm /
        (norm + 1e-6), 1)`` through the ``scale`` kernel. A nonfinite norm
        passes the grads through unchanged: the scaler's skip owns that
        step."""
        if grads is None:
            raise TypeError(
                "the functional core holds no grad state: pass the "
                "grads tree — clip_master_grads(max_norm, grads)")
        if norm_type != 2:
            raise NotImplementedError("only norm_type=2 (global L2)")
        flat_grads = self.optimizer.flatten_grads(grads)
        inv_scale = 1.0 / self.scaler_state.scale
        sq = None
        for fg in flat_grads:
            n = K.l2norm(fg)
            sq = n * n if sq is None else sq + n * n
        total_norm = torch.sqrt(sq) * inv_scale
        clip_coef = max_norm / (total_norm + 1e-6)
        coef = torch.where(torch.isfinite(total_norm),
                           torch.clamp(clip_coef, max=1.0),
                           torch.ones_like(clip_coef)).to(torch.float32)
        clipped = _flat.tree_map(
            lambda g: K.scale(g.reshape(-1), coef)[0].view(g.shape), grads)
        return clipped, total_norm

    def zero_grad(self, set_grads_to_None: bool = True):
        self.optimizer.zero_grad()

    # -- delegated surface ----------------------------------------------------
    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def params_tree(self):
        return self.optimizer.params_tree()

    def master_params_tree(self):
        return self.optimizer.master_params_tree()

    # -- checkpointing (fp16_optimizer.py:183-195) ----------------------------
    def state_dict(self) -> dict:
        return {
            "loss_scaler": self.loss_scaler.state_dict(self.scaler_state),
            "dynamic": self.loss_scaler.dynamic,
            "overflow": self.overflow,
            "optimizer_state_dict": self.optimizer.state_dict(),
        }

    def load_state_dict(self, d: dict):
        self.scaler_state = self.loss_scaler.load_state_dict(
            d["loss_scaler"], self.optimizer.device)
        self.overflow = bool(d.get("overflow", False))
        self.optimizer.load_state_dict(d["optimizer_state_dict"])
