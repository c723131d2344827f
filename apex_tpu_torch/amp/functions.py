"""The precision decorators — counterpart of ``apex_tpu/amp/functions.py``.

``half_function``, ``float_function`` and ``promote_function`` pin a
callable's precision by casting the float tensors of its argument tree
(nested tuples, lists and dicts) before the call, with the JAX package's
semantics (:41-94); ``register_*`` rebind ``module.name`` in place as one
of them. They compose with ``amp.autocast``: a function already pinned
sees inputs already cast. Non-tensor arguments are left as they are.
"""

from __future__ import annotations

import functools

import torch

from apex_tpu_torch.amp.autocast import _cast, _floats, _widest
from apex_tpu_torch.amp.policy import as_dtype

__all__ = ["half_function", "float_function", "promote_function",
           "register_half_function", "register_float_function",
           "register_promote_function"]


def half_function(fn, compute_dtype=torch.bfloat16):
    """Run ``fn`` with its float tensor inputs cast to the half dtype
    (bf16 by default)."""
    dtype = as_dtype(compute_dtype)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args, kwargs = _cast((args, kwargs), dtype)
        return fn(*args, **kwargs)
    return wrapped


def float_function(fn):
    """Run ``fn`` with its float tensor inputs cast to fp32."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args, kwargs = _cast((args, kwargs), torch.float32)
        return fn(*args, **kwargs)
    return wrapped


def promote_function(fn):
    """Run ``fn`` with its float tensor inputs promoted to the widest float
    dtype among them."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        floats = _floats((args, kwargs), [])
        if floats:
            args, kwargs = _cast((args, kwargs), _widest(floats))
        return fn(*args, **kwargs)
    return wrapped


def _register(module, name, deco):
    setattr(module, name, deco(getattr(module, name)))
    return getattr(module, name)


def register_half_function(module, name):
    """Rebind ``module.name`` as a half function."""
    return _register(module, name, half_function)


def register_float_function(module, name):
    """Rebind ``module.name`` as a float function."""
    return _register(module, name, float_function)


def register_promote_function(module, name):
    """Rebind ``module.name`` as a promote function."""
    return _register(module, name, promote_function)
