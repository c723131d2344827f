"""Parameter conversion from the JAX package.

``params_from_jax`` takes an ``apex_tpu`` init tree (``TransformerLM``'s,
``Seq2SeqTransformer``'s, an attention module's) with every leaf already
a numpy array (``jax.tree.map(np.asarray, params)``) and returns the same
nested dict of torch tensors. The JAX ``[in, out]``
weight layout is kept, so ``x @ W`` is the same product in both packages.
``resnet_from_jax`` does the same for ``ResNet.init``'s ``(params,
state)``, keeping HWIO conv kernels and the ``[in, out]`` fc, so the flat
buffers of the two packages agree element for element.
``opt_state_from_jax`` carries a fused optimizer's state over (any slots:
Adam's moments, FusedAdagrad's ``"sum"``), and
``fp16_optimizer_state_from_jax`` an ``FP16_Optimizer.state_dict()``
(scaler, overflow flag and the wrapped optimizer's state dict) for the
port's ``load_state_dict``. ``zero_state_dict_from_jax`` carries a ZeRO
optimizer's ``state_dict()`` / ``state_dict_arrays()`` (per-leaf trees,
so any shard count loads it) and ``sharded_state_from_jax`` its flat
``ShardedState``. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device

__all__ = ["params_from_jax", "resnet_from_jax", "opt_state_from_jax",
           "optimizer_state_dict_from_jax", "fp16_optimizer_state_from_jax",
           "zero_state_dict_from_jax", "sharded_state_from_jax"]


def _leaf(a, device: torch.device, dtype: Optional[torch.dtype]):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch counterpart in from_numpy;
        # widening to float32 is exact
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: dict, *, device=None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (the card unless ``device="cpu"`` is given). With ``dtype`` set,
    floating leaves are cast to it; integer leaves keep their type."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev, dtype)

    return conv(tree)


def resnet_from_jax(params: dict, state: dict, *, device=None,
                    dtype: Optional[torch.dtype] = None) -> tuple:
    """``(params, state)`` of ``apex_tpu``'s ``ResNet.init`` (numpy leaves)
    -> the port's trees on ``device``, layouts kept (conv HWIO, fc
    ``[in, out]``). ``dtype`` casts the params only; BN running stats stay
    fp32 and ``num_batches_tracked`` int32."""
    return (params_from_jax(params, device=device, dtype=dtype),
            params_from_jax(state, device=device))


def opt_state_from_jax(state, *, device=None) -> tuple:
    """A JAX fused optimizer's state — a sequence of per-group states with
    ``master``, ``slots`` (a dict) and ``step``, numpy leaves or arrays —
    -> the port's tuple of ``GroupState`` on ``device``, to assign to a
    port optimizer's ``state`` built over the same params tree (the two
    packages lay the flat buffer out alike)."""
    from apex_tpu_torch.optimizers.base import GroupState
    dev = resolve_device(device)
    return tuple(GroupState(
        master=_leaf(gs.master, dev, None),
        slots={k: _leaf(v, dev, None) for k, v in gs.slots.items()},
        step=torch.tensor(int(np.asarray(gs.step)), dtype=torch.int32,
                          device=dev)) for gs in state)


def optimizer_state_dict_from_jax(d: dict, *, device=None) -> dict:
    """A JAX fused optimizer's ``state_dict()`` (numpy masters and slots)
    -> the port's, tensors on ``device``, for ``load_state_dict``."""
    dev = resolve_device(device)
    return {"param_groups": [dict(hp) for hp in d["param_groups"]],
            "groups": [{"master": _leaf(g["master"], dev, None),
                        "slots": {k: _leaf(v, dev, None)
                                  for k, v in g["slots"].items()},
                        "step": int(g["step"])} for g in d["groups"]]}


def fp16_optimizer_state_from_jax(d: dict, *, device=None) -> dict:
    """A JAX ``FP16_Optimizer.state_dict()`` -> the port's: the scaler's
    host dict and the overflow flag as they are, the wrapped optimizer's
    state dict through :func:`optimizer_state_dict_from_jax`."""
    return {"loss_scaler": dict(d["loss_scaler"]),
            "dynamic": bool(d["dynamic"]), "overflow": bool(d["overflow"]),
            "optimizer_state_dict": optimizer_state_dict_from_jax(
                d["optimizer_state_dict"], device=device)}


def zero_state_dict_from_jax(d: dict, *, device=None) -> dict:
    """A JAX ``DistributedFusedAdam``/``LAMB`` ``state_dict()`` or
    ``state_dict_arrays()`` (per-leaf trees of numpy arrays or arrays) ->
    the port's, tensors on ``device``, for a port ZeRO optimizer's
    ``load_state_dict`` at any ``num_shards`` (the slots keep their names,
    ``m`` and ``v``)."""
    def conv(tree):
        return params_from_jax(tree, device=device)
    return {"format": d["format"], "master": conv(d["master"]),
            "slots": {k: conv(v) for k, v in d["slots"].items()},
            "step": int(np.asarray(d["step"])), "hp": dict(d["hp"]),
            "num_shards": int(d["num_shards"])}


def sharded_state_from_jax(state, *, device=None):
    """A JAX ``ShardedState`` (the full flat buffers, numpy leaves or
    arrays) -> the port's on ``device``, for a port optimizer built over
    the same params with the same ``num_shards`` (the two lay the flat
    buffer out alike); ``local_state`` then cuts a rank's shard."""
    from apex_tpu_torch.contrib.optimizers.distributed import ShardedState
    dev = resolve_device(device)
    return ShardedState(
        master=_leaf(state.master, dev, None),
        slots={k: _leaf(v, dev, None) for k, v in state.slots.items()},
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev))
