"""Automatic mixed precision (counterpart of ``apex_tpu/amp``): policy,
device-resident loss scaler, ``initialize`` and its handle, O1's
``autocast`` with its op ``lists`` and the precision decorators, and
``master_params``. Names import lazily, but for ``autocast``: the
function shares its module's name, so it is bound here and stays the
package's attribute once the module is loaded."""

from __future__ import annotations

import importlib

from apex_tpu_torch.amp.autocast import autocast  # noqa: F401

_EXPORTS = {
    "AmpError": "policy", "Policy": "policy", "make_policy": "policy",
    "LossScaler": "scaler", "ScalerState": "scaler",
    "AmpHandle": "frontend", "initialize": "frontend",
    "cast_model_params": "frontend", "cast_inputs": "frontend",
    "cast_outputs_fp32": "frontend", "master_params": "frontend",
    "custom_grad": "autocast",
    "half_function": "functions", "float_function": "functions",
    "promote_function": "functions",
    "register_half_function": "functions",
    "register_float_function": "functions",
    "register_promote_function": "functions",
}

__all__ = sorted([*_EXPORTS, "autocast", "lists"])


def __getattr__(name: str):
    if name == "lists":
        return importlib.import_module(f"{__name__}.lists")
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
