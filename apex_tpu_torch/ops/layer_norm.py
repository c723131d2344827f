"""LayerNorm forward over rows: the kernel wrapper and its plain PyTorch
version.

Counterpart of ``apex_tpu/ops/pallas/layer_norm.py`` ``_ln_fwd_single`` /
``_fwd_kernel`` (F <= 8192, one pass); the kernel is
``ops/cuda/csrc/layer_norm.cu``. The wide (F > 8192) and backward kernels
come with the training slice.

For a tensor on the CPU :func:`ln_fwd` runs the plain version; for a
tensor on the card it launches the kernel, or raises when the kernel does
not take the dtype, shape or layout. ``ln_fwd.launches`` counts launches.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import cuda as _cuda
from apex_tpu_torch.ops import dispatch

__all__ = ["F_SINGLE_MAX", "ln_fwd", "ln_fwd_plain"]

F_SINGLE_MAX = 8192   # widest row the one-pass kernel holds on chip


def ln_fwd_plain(x2d: torch.Tensor, weight, bias, eps: float):
    """Plain version: x2d [rows, F]; weight/bias [F] or None. fp32 math in
    the order of ``_fwd_kernel`` (layer_norm.py:56-66). Returns (y in x's
    dtype, mean f32 [rows], invvar f32 [rows])."""
    xf = x2d.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    out = (xf - mean) * inv
    if weight is not None:
        out = out * weight.float() + bias.float()
    return out.to(x2d.dtype), mean[:, 0], inv[:, 0]


def ln_fwd(x2d: torch.Tensor, weight, bias, eps: float):
    """LayerNorm forward of each row of x2d [rows, F]; weight/bias [F]
    (both or neither). Returns (y, mean, invvar) like :func:`ln_fwd_plain`."""
    if not dispatch.use_kernel(x2d):
        return ln_fwd_plain(x2d, weight, bias, eps)
    rows, f = x2d.shape
    if not x2d.is_contiguous():
        raise ValueError("ln_fwd: x must be contiguous")
    if not 0 < f <= F_SINGLE_MAX:
        raise NotImplementedError(
            f"ln_fwd: rows wider than {F_SINGLE_MAX} need the wide kernels, "
            f"which are not ported yet (ROADMAP.md Queue 1, slice 4); got "
            f"F={f}")
    if (weight is None) != (bias is None):
        raise ValueError("ln_fwd: pass weight and bias together")
    xc = _cuda.dtype_code(x2d.dtype, "ln_fwd")
    wc = 0
    if weight is not None:
        for t, what in ((weight, "weight"), (bias, "bias")):
            if t.device != x2d.device or not t.is_contiguous() \
                    or t.shape != (f,):
                raise ValueError(f"ln_fwd: {what} must be a contiguous "
                                 f"[{f}] tensor on {x2d.device}")
        if bias.dtype != weight.dtype:
            raise TypeError("ln_fwd: weight and bias dtypes differ")
        wc = _cuda.dtype_code(weight.dtype, "ln_fwd weight")
    y = torch.empty_like(x2d)
    mean, inv = torch.empty((2, rows), dtype=torch.float32,
                            device=x2d.device)   # one allocation, two rows
    if rows == 0:
        return y, mean, inv
    err = _cuda.lib().apex_layer_norm_fwd(
        xc, wc, x2d.data_ptr(),
        weight.data_ptr() if weight is not None else None,
        bias.data_ptr() if bias is not None else None,
        y.data_ptr(), mean.data_ptr(), inv.data_ptr(), rows, f, float(eps),
        _cuda.stream(x2d.device))
    _cuda.check(err, "ln_fwd")
    ln_fwd.launches += 1
    return y, mean, inv


ln_fwd.launches = 0
