"""Opt-level precision policy — counterpart of ``apex_tpu/amp/policy.py``.

An immutable ``Policy`` resolved from O0–O3 presets plus overrides, with
the JAX package's validation rules and messages. ``half_dtype`` is
``torch.bfloat16`` (then loss scaling defaults off) or ``torch.float16``
(then it defaults to dynamic).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

__all__ = ["AmpError", "Policy", "make_policy", "as_dtype"]

LossScaleT = Union[str, float]  # "dynamic" or a static scale value


class AmpError(ValueError):
    pass


def as_dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype, a name ("float16",
    "torch.bfloat16", "half") or anything whose ``str`` is such a name
    (numpy and JAX dtypes)."""
    if isinstance(d, torch.dtype):
        return d
    name = getattr(d, "name", None) or str(d)
    name = name.rsplit(".", 1)[-1]
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise AmpError(f"not a dtype: {d!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class Policy:
    """Resolved precision policy; the fields of apex_tpu's ``Policy``
    (policy.py:25-67) with torch dtypes."""

    opt_level: str = "O1"
    cast_model_dtype: Optional[torch.dtype] = None
    autocast: bool = True
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: bool = False
    loss_scale: LossScaleT = "dynamic"
    half_dtype: torch.dtype = torch.bfloat16

    @property
    def compute_dtype(self) -> torch.dtype:
        """Half under O1 autocast or when the model is cast to half
        (O2/O3); fp32 otherwise (O0)."""
        if self.autocast:
            return self.half_dtype
        if self.cast_model_dtype is not None and \
                self.cast_model_dtype != torch.float32:
            return self.half_dtype
        return torch.float32

    @property
    def is_dynamic(self) -> bool:
        return self.loss_scale == "dynamic"

    @property
    def static_scale(self) -> float:
        return 1.0 if self.is_dynamic else float(self.loss_scale)


_VALID_LEVELS = ("O0", "O1", "O2", "O3")


def make_policy(opt_level: str = "O1", *, half_dtype=torch.bfloat16,
                cast_model_dtype="unset", autocast="unset",
                keep_batchnorm_fp32="unset", master_weights="unset",
                loss_scale="unset") -> Policy:
    """Resolve an opt level and overrides into a Policy (policy.py:73-169:
    the same presets, argparse-style strings and consistency checks)."""
    if opt_level not in _VALID_LEVELS:
        raise AmpError(
            f"Unexpected optimization level {opt_level!r}; options are "
            f"'O0', 'O1', 'O2', 'O3'. Note the letter O, not the number 0.")
    half_dtype = as_dtype(half_dtype)
    if half_dtype not in (torch.bfloat16, torch.float16):
        raise AmpError(f"half_dtype must be bfloat16 or float16, got "
                       f"{str(half_dtype).rsplit('.', 1)[-1]}")

    # fp16 needs scaling; bf16's range makes it pointless
    dyn_default = "dynamic" if half_dtype == torch.float16 else 1.0

    presets = {
        "O0": dict(cast_model_dtype=torch.float32, autocast=False,
                   keep_batchnorm_fp32=None, master_weights=False,
                   loss_scale=1.0),
        "O1": dict(cast_model_dtype=None, autocast=True,
                   keep_batchnorm_fp32=None, master_weights=False,
                   loss_scale=dyn_default),
        "O2": dict(cast_model_dtype=half_dtype, autocast=False,
                   keep_batchnorm_fp32=True, master_weights=True,
                   loss_scale=dyn_default),
        "O3": dict(cast_model_dtype=half_dtype, autocast=False,
                   keep_batchnorm_fp32=False, master_weights=False,
                   loss_scale=1.0),
    }
    cfg = presets[opt_level]

    def _parse_bool(name, val):
        if isinstance(val, str):
            if val == "True":
                return True
            if val == "False":
                return False
            raise AmpError(
                f"{name} must be a bool or 'True'/'False', got {val!r}")
        return val

    overrides = {}
    if keep_batchnorm_fp32 != "unset":
        overrides["keep_batchnorm_fp32"] = _parse_bool(
            "keep_batchnorm_fp32", keep_batchnorm_fp32)
    if cast_model_dtype != "unset":
        overrides["cast_model_dtype"] = (None if cast_model_dtype is None
                                         else as_dtype(cast_model_dtype))
    if autocast != "unset":
        overrides["autocast"] = _parse_bool("autocast", autocast)
    if master_weights != "unset":
        overrides["master_weights"] = _parse_bool("master_weights",
                                                  master_weights)
    if loss_scale != "unset":
        if isinstance(loss_scale, str) and loss_scale != "dynamic":
            try:
                loss_scale = float(loss_scale)  # argparse interop
            except ValueError:
                raise AmpError(f"loss_scale must be a number or 'dynamic', "
                               f"got {loss_scale!r}")
        overrides["loss_scale"] = loss_scale

    cfg.update(overrides)

    if cfg["autocast"]:
        if cfg.get("cast_model_dtype") is not None:
            raise AmpError(
                "cast_model_dtype is not supported with autocast (O1); "
                "O1's per-op casting leaves model weights fp32.")
        if overrides.get("master_weights"):
            raise AmpError("master_weights is not supported with O1 "
                           "autocast.")
        if overrides.get("keep_batchnorm_fp32", None) is not None:
            raise AmpError(
                "keep_batchnorm_fp32 is not supported with O1 autocast; "
                "batchnorm stays fp32 automatically.")
    if cfg.get("keep_batchnorm_fp32") is not None \
            and cfg["cast_model_dtype"] is None and not cfg["autocast"]:
        # O0 with a keep_batchnorm override: meaningless, normalized away
        cfg["keep_batchnorm_fp32"] = None

    return Policy(opt_level=opt_level, half_dtype=half_dtype, **cfg)
