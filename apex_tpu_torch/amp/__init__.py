"""Automatic mixed precision (counterpart of ``apex_tpu/amp``): policy,
device-resident loss scaler, ``initialize`` and its handle. Names import
lazily."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "AmpError": "policy", "Policy": "policy", "make_policy": "policy",
    "LossScaler": "scaler", "ScalerState": "scaler",
    "AmpHandle": "frontend", "initialize": "frontend",
    "cast_model_params": "frontend", "cast_inputs": "frontend",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
