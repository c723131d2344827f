"""Manual mixed-precision helpers — counterpart of
``apex_tpu/fp16_utils/fp16util.py`` (:32-122).

Params are trees of tensors, so "convert the network" is a dtype map over
the tree with a keep-fp32 predicate on each leaf's key path (a tuple of
dict keys and list indices), and the master and model copies are a flat
fp32 buffer and a half tree over one ``SegmentTable``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.ops import flat as _flat

__all__ = ["tofp16", "network_to_half", "convert_network",
           "bn_convert_float", "prep_param_lists",
           "model_grads_to_master_grads", "master_params_to_model_params",
           "to_python_float", "BN_convert_float", "convert_module"]


def _default_keep_fp32(path) -> bool:
    """BatchNorm-like leaves stay fp32 (fp16util.py:32-37): a key path
    naming ``batchnorm``, ``bn`` or ``batch_stats``."""
    names = "/".join(str(k) for k in path).lower()
    return any(tag in names for tag in ("batchnorm", "bn", "batch_stats"))


def _map_with_path(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` over every leaf, the structure kept."""
    leaves, treedef = _flat.tree_flatten(tree)
    return _flat.tree_unflatten(treedef, [
        fn(p, x) for p, x in zip(_flat.tree_paths(treedef), leaves)])


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def tofp16(tree: Any, dtype=torch.float16) -> Any:
    """Cast every float leaf (fp16util.py:40-44)."""
    return _flat.tree_map(lambda x: x.to(dtype) if _is_float(x) else x,
                          tree)


def bn_convert_float(tree: Any, keep_fp32: Optional[Callable] = None) -> Any:
    """Bring the BN leaves of a half tree back to fp32 (fp16util.py:47-52)."""
    keep = keep_fp32 or _default_keep_fp32
    return _map_with_path(
        lambda path, x: x.float() if keep(path) else x, tree)


def convert_network(tree: Any, dtype, keep_fp32: Optional[Callable] = None
                    ) -> Any:
    """Half-cast a param tree, keeping the BN leaves fp32
    (fp16util.py:55-68)."""
    keep = keep_fp32 or _default_keep_fp32

    def cast(path, x):
        if not _is_float(x):
            return x
        return x.float() if keep(path) else x.to(dtype)

    return _map_with_path(cast, tree)


def network_to_half(tree: Any, dtype=torch.bfloat16) -> Any:
    """``convert_network(tree, dtype)``, bf16 by default as in the JAX
    package (fp16util.py:71-75); pass ``torch.float16`` for the
    reference's."""
    return convert_network(tree, dtype)


def prep_param_lists(params: Any, flat_master: bool = True,
                     model_dtype=torch.bfloat16):
    """``(model params in model_dtype, fp32 master, table)`` from an fp32
    param tree (fp16util.py:78-92): the master is the flat buffer, or with
    ``flat_master=False`` an fp32 tree."""
    master_flat, table = _flat.flatten(params, dtype=torch.float32)
    model = tofp16(params, model_dtype)
    if not flat_master:
        return model, _flat.unflatten(master_flat, table), table
    return model, master_flat, table


def model_grads_to_master_grads(model_grads: Any,
                                table: _flat.SegmentTable) -> torch.Tensor:
    """Half model grads -> one fp32 flat master-grad buffer
    (fp16util.py:95-99)."""
    return _flat.flatten(model_grads, table=table, dtype=torch.float32)[0]


def master_params_to_model_params(master_flat: torch.Tensor,
                                  table: _flat.SegmentTable,
                                  model_dtype=torch.bfloat16) -> Any:
    """fp32 master buffer -> half model param tree (fp16util.py:102-107)."""
    return _flat.unflatten(master_flat, table, dtype=model_dtype)


def to_python_float(x) -> float:
    """One value as a Python float (fp16util.py:110-112)."""
    return float(torch.as_tensor(x).reshape(()))


# the reference's names: ``BN_convert_float``, and ``convert_module``,
# which casts every float leaf, BN included (fp16util.py:114-121)
BN_convert_float = bn_convert_float
convert_module = tofp16
