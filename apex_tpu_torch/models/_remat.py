"""Rematerialization for the model zoo — counterpart of
``apex_tpu/models/_remat.py``.

A model with ``remat=True`` runs each block through :func:`remat`, which
drops the block's inner activations in the forward and recomputes them in
the backward (``torch.utils.checkpoint``, non-reentrant). The policy
names are ``jax.checkpoint_policies``' and mean what they mean there:

- ``None`` and ``"nothing_saveable"``: save nothing inside the block;
- ``"everything_saveable"``: save every activation, so nothing is
  recomputed and the block runs as without remat;
- ``"dots_saveable"``: save the outputs of the products (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``) and convolutions, recompute the rest;
- ``"dots_with_no_batch_dims_saveable"``: the same without ``bmm`` and
  ``baddbmm``, whose batch dimension JAX's rule excludes.

The last two are selective checkpointing over aten ops
(``create_selective_checkpoint_contexts``). The flash attention and
LayerNorm kernels are launches of their own, not aten ops, so they are
recomputed under every policy but ``everything_saveable``, as the
``pallas_call`` is under JAX's (it is not a dot). Attention dropout is a
hash of the seeds and the coordinates, so the recompute draws the same
mask, and the recompute runs the same kernels on the same inputs: remat
leaves the loss and the gradients unchanged bit for bit.

Under O1 the recompute runs outside ``amp.autocast``'s mode, so the
recompute context re-enters it (``amp.autocast.recompute_context``),
composed with the selective-checkpoint contexts.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from apex_tpu_torch.amp.autocast import recompute_context

__all__ = ["REMAT_POLICIES", "validate_remat_config", "remat"]

REMAT_POLICIES = ("everything_saveable", "nothing_saveable",
                  "dots_saveable", "dots_with_no_batch_dims_saveable")

_DOTS = {"dots_saveable": ("mm", "addmm", "bmm", "baddbmm", "convolution"),
         "dots_with_no_batch_dims_saveable": ("mm", "addmm", "convolution")}


def validate_remat_config(remat: bool, remat_policy: Optional[str]) -> None:
    """Raise ValueError on an inconsistent (remat, remat_policy) pair, with
    the JAX package's messages."""
    if remat_policy is None:
        return
    if not remat:
        raise ValueError(
            "remat_policy is set but remat=False — the policy "
            "would be silently ignored")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {remat_policy!r}; one of "
            f"{REMAT_POLICIES}")


def _saved_ops(policy: str) -> frozenset:
    aten = torch.ops.aten
    return frozenset(getattr(aten, name).default for name in _DOTS[policy])


def _contexts(policy: Optional[str]):
    """``(forward context, recompute context)`` for one checkpointed call:
    the policy's, with the O1 mode active now re-entered for the
    recompute."""
    o1 = recompute_context()
    if policy not in _DOTS:
        return contextlib.nullcontext(), o1
    saved = _saved_ops(policy)

    def policy_fn(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    fwd, rec = _ckpt.create_selective_checkpoint_contexts(policy_fn)
    return fwd, _both(o1, rec)


@contextlib.contextmanager
def _both(outer, inner):
    with outer, inner:
        yield


def remat(fn, policy: Optional[str] = None):
    """``fn`` rematerialized under ``policy`` (a name of
    ``REMAT_POLICIES`` or None, which saves nothing)."""
    validate_remat_config(True, policy)
    if policy == "everything_saveable":
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        # the blocks draw no random numbers (dropout is a hash of seeds),
        # so there is no RNG state to stash and restore
        return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                                preserve_rng_state=False,
                                context_fn=functools.partial(_contexts,
                                                             policy),
                                **kwargs)
    return run
