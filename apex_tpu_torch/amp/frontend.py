"""AMP user API — counterpart of ``apex_tpu/amp/frontend.py``: ``initialize``
resolves a policy and wraps a model apply-function for it, and the
``AmpHandle`` carries the loss scalers, whose state the caller threads
through the step as a tuple of :class:`ScalerState`.

Ported: O0, O2 and O3 (parameter and input casts, BN kept fp32 under O2
by a path predicate, fp32 outputs), microbatch gradient accumulation
(``accumulate_grads``) and the overflow census (``update_with_census``).
O1's per-op autocast raises, naming the slice that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from apex_tpu_torch.amp.policy import Policy, as_dtype, make_policy
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.ops import flat as _flat

__all__ = ["AmpHandle", "initialize", "cast_model_params", "cast_inputs",
           "cast_outputs_fp32"]


def _default_bn_predicate(path) -> bool:
    """True for parameters that stay fp32 under keep_batchnorm_fp32:
    a path entry named like a BatchNorm (frontend.py:42-51)."""
    for name in path:
        low = str(name).lower()
        if "batchnorm" in low or low in ("bn", "batch_stats") \
                or low.startswith("bn_"):
            return True
    return False


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def cast_model_params(params, dtype, keep_fp32_predicate=None,
                      coalesce: bool = True):
    """Cast float params to ``dtype``, keeping those the predicate matches
    (given the path of keys) in fp32. With ``coalesce``, leaves of one
    source dtype are packed into one flat buffer and cast once
    (frontend.py:54-103); the values equal a per-leaf cast."""
    dtype = as_dtype(dtype)
    pred = keep_fp32_predicate
    leaves, treedef = _flat.tree_flatten(params)
    items = list(zip(_flat.tree_paths(treedef), leaves))
    out = []
    cast_idx = []
    for i, (path, leaf) in enumerate(items):
        if not _is_float(leaf):
            out.append(leaf)
        elif pred is not None and pred(path):
            out.append(leaf.float())
        else:
            out.append(leaf)
            if leaf.dtype != dtype:
                cast_idx.append(i)
    src = {out[i].dtype for i in cast_idx}
    if coalesce and len(cast_idx) >= 2 and len(src) == 1:
        parts = [out[i] for i in cast_idx]
        buf, table = _flat.flatten(parts)
        for i, leaf in zip(cast_idx, _flat.unflatten(buf, table, dtype)):
            out[i] = leaf
    else:
        for i in cast_idx:
            out[i] = out[i].to(dtype)
    return _flat.tree_unflatten(treedef, out)


def cast_inputs(tree, dtype):
    """Cast float tensors of a tree to ``dtype``."""
    dtype = as_dtype(dtype)
    return _flat.tree_map(lambda x: x.to(dtype) if _is_float(x) else x, tree)


def cast_outputs_fp32(tree):
    return cast_inputs(tree, torch.float32)


@dataclasses.dataclass
class AmpHandle:
    """The AMP configuration of one run and its scaler ops; device state
    is the tuple :meth:`init_state` returns, one ScalerState per loss."""

    policy: Policy
    scalers: Sequence[LossScaler]

    def init_state(self, device=None) -> tuple:
        return tuple(s.init(device) for s in self.scalers)

    def scale_loss(self, loss, amp_state, loss_id: int = 0):
        return self.scalers[loss_id].scale_loss(loss, amp_state[loss_id])

    def unscale(self, flat_grads, amp_state, loss_id: int = 0):
        return self.scalers[loss_id].unscale(flat_grads, amp_state[loss_id])

    def unscale_with_stashed(self, flat_grads, stashed, amp_state,
                             loss_id: int = 0):
        return self.scalers[loss_id].unscale_with_stashed(
            flat_grads, stashed, amp_state[loss_id])

    def update(self, amp_state, found_inf, loss_id: int = 0) -> tuple:
        new = self.scalers[loss_id].update(amp_state[loss_id], found_inf)
        return tuple(new if i == loss_id else s
                     for i, s in enumerate(amp_state))

    def update_with_census(self, amp_state, found_inf, grads, census=None,
                           loss_id: int = 0, table=None):
        """:meth:`update` plus overflow provenance; returns
        ``(new_amp_state, census_carry)`` (frontend.py:152-160)."""
        new, carry = self.scalers[loss_id].update_with_census(
            amp_state[loss_id], found_inf, grads, census, table=table)
        return tuple(new if i == loss_id else s
                     for i, s in enumerate(amp_state)), carry

    def loss_scale(self, amp_state, loss_id: int = 0):
        return amp_state[loss_id].scale

    def accumulate_grads(self, loss_fn, master, microbatches, amp_state,
                         loss_id: int = 0, average: bool = True):
        """Microbatch gradient accumulation (frontend.py:166-200): for each
        microbatch along the leading axis of every leaf of
        ``microbatches``, the gradient of the scaled ``loss_fn(flat_master,
        microbatch)`` (an unscaled loss) with respect to the flat master
        folds into an fp32 accumulator that starts at zeros, through
        :meth:`unscale_with_stashed` (the ``axpby`` kernel), its flag
        reading the fresh gradient only. A Python loop takes the place of
        JAX's ``lax.scan``; each microbatch's graph is freed before the
        next. Returns ``(flat grad, found_inf, mean loss)``: the mean of
        the per-microbatch gradients (``average``) or their sum, already
        unscaled; found_inf the fp32 running max of the flags."""
        n = _flat.tree_leaves(microbatches)[0].shape[0]
        acc = torch.zeros_like(master)
        found_inf = torch.zeros((), dtype=torch.float32, device=master.device)
        losses = []
        for i in range(n):
            mb = _flat.tree_map(lambda t: t[i], microbatches)
            m = master.detach().requires_grad_(True)
            loss = loss_fn(m, mb)
            (fg,) = torch.autograd.grad(
                self.scale_loss(loss, amp_state, loss_id), m)
            acc, fi = self.unscale_with_stashed(fg, acc, amp_state, loss_id)
            found_inf = torch.maximum(found_inf, fi.to(torch.float32))
            losses.append(loss.detach())
            del m, loss, fg
        if average:
            acc = acc / n
        return acc, found_inf, torch.stack(losses).mean()

    def state_dict(self, amp_state) -> dict:
        return {f"loss_scaler{i}": s.state_dict(st)
                for i, (s, st) in enumerate(zip(self.scalers, amp_state))}

    def load_state_dict(self, d: dict, device=None) -> tuple:
        return tuple(s.load_state_dict(d[f"loss_scaler{i}"], device)
                     for i, s in enumerate(self.scalers))


def initialize(apply_fn: Optional[Callable] = None, opt_level: str = "O1",
               num_losses: int = 1,
               keep_fp32_predicate: Optional[Callable] = None,
               verbosity: int = 1, cast_model_outputs=None,
               min_loss_scale: Optional[float] = None,
               max_loss_scale: float = 2.0 ** 24,
               **overrides) -> tuple[Any, AmpHandle]:
    """Resolve a policy and wrap ``apply_fn(params, *args)`` for it
    (frontend.py:229-323). Returns ``(wrapped_apply, handle)``; with no
    ``apply_fn`` the first is None. The reference's keyword names
    (``cast_model_type``, ``patch_torch_functions``, ``enabled``) are
    accepted."""
    if not overrides.pop("enabled", True):
        opt_level, overrides, cast_model_outputs = "O0", {}, None
    cmt = overrides.pop("cast_model_type", None)
    if cmt is not None:
        overrides["cast_model_dtype"] = as_dtype(cmt)
    ptf = overrides.pop("patch_torch_functions", None)
    if ptf is not None:
        overrides["autocast"] = bool(ptf)
    for k in ("keep_batchnorm_fp32", "master_weights", "loss_scale"):
        if k in overrides and overrides[k] is None:
            del overrides[k]

    policy = make_policy(opt_level, **overrides)
    handle = AmpHandle(policy=policy, scalers=tuple(
        LossScaler.from_policy(policy, min_loss_scale=min_loss_scale,
                               max_loss_scale=max_loss_scale)
        for _ in range(num_losses)))

    if apply_fn is None:
        return None, handle

    if policy.autocast:
        raise NotImplementedError(
            "O1 per-op autocast is not ported yet (ROADMAP.md Queue 1, "
            "slice 3); use O0, O2 or O3")
    if policy.cast_model_dtype is not None and \
            policy.cast_model_dtype != torch.float32:      # O2 / O3
        dtype = policy.cast_model_dtype
        pred = keep_fp32_predicate
        if pred is None and policy.keep_batchnorm_fp32:
            pred = _default_bn_predicate

        def wrapped(params, *args, **kwargs):
            model_p = cast_model_params(params, dtype, pred)
            out = apply_fn(model_p, *cast_inputs(list(args), dtype),
                           **cast_inputs(kwargs, dtype))
            return cast_outputs_fp32(out)
    else:                                                  # O0
        def wrapped(params, *args, **kwargs):
            return apply_fn(cast_model_params(params, torch.float32),
                            *cast_inputs(list(args), torch.float32),
                            **cast_inputs(kwargs, torch.float32))

    if cast_model_outputs is not None:
        inner, odt = wrapped, as_dtype(cast_model_outputs)

        def wrapped(params, *args, **kwargs):  # noqa: F811
            return cast_inputs(inner(params, *args, **kwargs), odt)

    if verbosity > 0:
        p = policy
        print(f"apex_tpu_torch.amp: opt_level={p.opt_level}, "
              f"half_dtype={p.half_dtype}, autocast={p.autocast}, "
              f"cast_model_dtype={p.cast_model_dtype}, "
              f"keep_batchnorm_fp32={p.keep_batchnorm_fp32}, "
              f"master_weights={p.master_weights}, "
              f"loss_scale={p.loss_scale}")
    return wrapped, handle
