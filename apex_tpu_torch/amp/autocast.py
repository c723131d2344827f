"""O1 autocast as a ``TorchFunctionMode`` — counterpart of
``apex_tpu/amp/autocast.py``.

The JAX package traces ``fn`` to a jaxpr and re-evaluates it with the
policy applied primitive by primitive (``_eval_jaxpr``, :147-208). Eager
PyTorch has no trace to rewrite, so ``autocast(fn)`` runs ``fn`` under a
``TorchFunctionMode`` that applies the same policy to each torch call as
it happens, the same on the CPU and on the card:

- ops of ``lists.HALF`` cast their float inputs to the compute dtype. A
  convolution returns it; a product returns its operands' promotion (fp32
  where an fp32 master takes part), summed in fp32, since JAX's ``jnp``
  products carry the ``preferred_element_type`` they were traced with.
  The bias or input that ``F.linear``, the convolutions and ``addmm`` add
  to their product is added afterwards, under promotion;
- ops of ``lists.FP32`` cast their float inputs to fp32;
- any other op with float tensor operands of more than one dtype casts
  them to the widest (``_unify_floats``, :101-114). Every tensor is a
  strong type, a 0-dim one too: the mode promotes itself, where torch's
  own rule would let a 0-dim fp32 tensor lose to a bf16 one. A Python
  number that is an operand counts as fp32, as JAX traces it
  (``lists.SCALAR_OPERAND``, ``lists.CONSTANT``). In-place ops, ``out=``
  calls and the ops that take a second tensor only for its dtype or shape
  (``to``, ``type_as``, ``*_as``) are left alone.

``torch.autocast`` is not used: its op lists are not these, and its CPU
lists differ from its CUDA lists (CPU autocast leaves ``exp``, ``log1p``,
``sum`` and ``mean`` in bf16), so the CPU tests would hold another policy
than the card runs.

Custom-gradient boundaries. In JAX each ``custom_vjp`` / ``custom_jvp``
runs at its traced dtypes with its own backward (``_CUSTOM_GRAD_PRIMS``,
:47-61). The mode sees the ops inside an ``autograd.Function``'s forward
but not ``Function.apply``, so each port entry point that stands for a JAX
``custom_vjp`` carries :func:`custom_grad`: under an active policy its
float inputs go to fp32 (the traced dtype under O1, whose params and
inputs are fp32 masters) and its body runs outside the policy. Under O1
the LM's attention therefore takes the fp32 flash kernels and its
LayerNorms run in fp32, as in JAX.

Rematerialized regions (``_REMAT_PRIMS``): the mode is not active while
``torch.utils.checkpoint`` recomputes in the backward, so
``models/_remat.py`` enters it again for the recompute
(:func:`recompute_context`).

Control flow: the JAX package runs scan/while/cond bodies at their traced
dtypes (``tests/test_numerics.py:342``); eager loops here get the policy.

Outputs are cast back to the dtype ``fn`` returns without the policy
(:260-262). With no trace to read it from, that is the promotion of the
float tensors ``fn`` is given: under O1's fp32 masters, fp32. Gradients
reach the fp32 leaves through the casts.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.overrides import TorchFunctionMode

from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp.policy import as_dtype

__all__ = ["autocast", "AutocastMode", "custom_grad", "recompute_context"]

# calls whose second tensor gives only a dtype, shape or destination
_NO_PROMOTE = frozenset((
    "to", "type", "type_as", "copy_", "set_", "expand_as", "view_as",
    "reshape_as", "new_empty", "new_zeros", "new_ones", "new_full",
    "new_tensor", "__setitem__", "__get__", "__set__"))

_tls = threading.local()


def _modes() -> list:
    stack = getattr(_tls, "modes", None)
    if stack is None:
        stack = _tls.modes = []
    return stack


def _map(fn, tree):
    """``fn`` over the tensors of nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, t) for t in tree]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _floats(tree, out: list) -> list:
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _floats(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _floats(t, out)
    return out


def _cast(tree, dtype):
    return _map(lambda t: t.to(dtype) if t.is_floating_point()
                and t.dtype != dtype else t, tree)


def _widest(floats):
    return functools.reduce(torch.promote_types, (t.dtype for t in floats))


def _add(a, b):
    """``a + b`` promoted to the wider of the two."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) + b.to(dt)


def _pop(args, kwargs, pos, key, drop):
    """``(args as a list, kwargs, the argument at pos or key, or None)``
    with that argument taken out: dropped with ``drop``, else left as None
    in its place."""
    args, kwargs = list(args), dict(kwargs)
    if key in kwargs:
        return args, kwargs, kwargs.pop(key)
    if pos >= len(args):
        return args, kwargs, None
    extra = args[pos]
    if drop:
        del args[pos]
    else:
        args[pos] = None
    return args, kwargs, extra


def _has_number(tree) -> bool:
    """A Python int or float (not a bool) among ``tree``'s arguments."""
    args, kwargs = tree
    return any(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in (*args, *kwargs.values()))


def _integer_pow(func, args, kwargs) -> bool:
    if func not in lists.POW:
        return False
    n = kwargs.get("exponent", args[1] if len(args) > 1 else None)
    return isinstance(n, int) and not isinstance(n, bool)


class AutocastMode(TorchFunctionMode):
    """The O1 policy over every torch call made while it is entered (see
    the module docstring). ``suspended`` > 0 lets calls through untouched:
    :func:`custom_grad` sets it around a boundary's body."""

    def __init__(self, compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = as_dtype(compute_dtype)
        self.suspended = 0

    def __enter__(self):
        _modes().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _modes().remove(self)
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.suspended or "out" in kwargs or kwargs.get("inplace"):
            return func(*args, **kwargs)
        if func in lists.HALF:
            return self._half(func, args, kwargs)
        if func in lists.FP32 and not _integer_pow(func, args, kwargs):
            args, kwargs = _cast((args, kwargs), torch.float32)
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if name in _NO_PROMOTE or (name.endswith("_")
                                   and not name.endswith("__")) \
                or name.startswith("__i"):
            return func(*args, **kwargs)
        floats = _floats((args, kwargs), [])
        if not floats:
            return func(*args, **kwargs)
        target = _widest(floats)
        if name in lists.CONSTANT or (name in lists.SCALAR_OPERAND
                                      and _has_number((args, kwargs))):
            target = torch.promote_types(target, torch.float32)
        if any(t.dtype != target for t in floats):
            args, kwargs = _cast((args, kwargs), target)
        return func(*args, **kwargs)

    def _half(self, func, args, kwargs):
        name = getattr(func, "__name__", "")
        extra = None
        if name in lists.BIAS_ARG:
            pos, key = lists.BIAS_ARG[name]
            args, kwargs, extra = _pop(args, kwargs, pos, key,
                                       drop=key == "input")
        # a convolution returns the half dtype; a product of JAX's jnp
        # carries preferred_element_type, the dtype it was traced at, so it
        # sums and returns in its operands' promotion (fp32 where an fp32
        # master takes part) over operands rounded to half: the products of
        # two half values are exact in fp32, so an fp32 product of the
        # rounded operands is that dot_general
        out_dt = self.compute_dtype
        floats = _floats((args, kwargs), [])
        if floats and not name.startswith("conv"):
            out_dt = torch.promote_types(_widest(floats), out_dt)
        args, kwargs = _cast((args, kwargs), self.compute_dtype)
        if out_dt != self.compute_dtype:
            args, kwargs = _cast((args, kwargs), out_dt)
        if name in ("addmm", "addmv", "baddbmm"):
            # beta * input + alpha * (the product)
            beta, alpha = kwargs.pop("beta", 1), kwargs.pop("alpha", 1)
            out = {"addmm": torch.mm, "addmv": torch.mv,
                   "baddbmm": torch.bmm}[name](*args, **kwargs)
            if alpha != 1:
                out = out * alpha
            if beta == 0:
                return out
            return _add(extra if beta == 1 else extra * beta, out)
        out = func(*args, **kwargs)
        if extra is None:
            return out
        if name != "linear":                    # bias over the channel dim
            extra = extra.reshape(-1, *([1] * (out.dim() - 2)))
        return _add(out, extra)


def custom_grad(fn):
    """Mark ``fn`` as the counterpart of a JAX ``custom_vjp``: under an
    active :class:`AutocastMode` its float tensor inputs are cast to fp32
    and its body, forward and backward, runs outside the policy; with no
    mode active it is ``fn`` itself."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        stack = _modes()
        if not stack or stack[-1].suspended:
            return fn(*args, **kwargs)
        for m in stack:
            m.suspended += 1
        try:
            args, kwargs = _cast((args, kwargs), torch.float32)
            return fn(*args, **kwargs)
        finally:
            for m in stack:
                m.suspended -= 1
    return wrapped


def recompute_context():
    """A context manager that re-enters the policy active on this thread
    now (a fresh :class:`AutocastMode` of the same compute dtype), or a
    null context when none is: for ``torch.utils.checkpoint``'s recompute,
    which runs without it."""
    stack = _modes()
    if not stack or stack[-1].suspended:
        return contextlib.nullcontext()
    return AutocastMode(stack[-1].compute_dtype)


def autocast(fn, compute_dtype=torch.bfloat16):
    """Wrap ``fn`` so its products and convolutions take ``compute_dtype``
    operands and its fragile ops fp32 ones, whatever dtypes reach them
    (``AutocastMode``); its float outputs come back
    in the promotion of its float tensor inputs' dtypes (fp32 for fp32
    masters)."""
    compute_dtype = as_dtype(compute_dtype)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        floats = _floats((args, kwargs), [])
        with AutocastMode(compute_dtype):
            out = fn(*args, **kwargs)
        if not floats:
            return out
        return _cast(out, _widest(floats))

    return wrapped
