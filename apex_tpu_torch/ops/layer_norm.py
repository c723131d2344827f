"""LayerNorm over rows: the kernel wrappers and their plain PyTorch
versions.

Counterpart of ``apex_tpu/ops/pallas/layer_norm.py`` ``_ln_fwd_single`` /
``_fwd_kernel`` and ``_ln_bwd_single`` / ``_bwd_kernel`` (F <= 8192, one
pass); the kernels are ``ops/cuda/csrc/layer_norm.cu``. The wide
(F > 8192) kernels are not ported yet.

For a tensor on the CPU :func:`ln_fwd` and :func:`ln_bwd` run their plain
versions; for a tensor on the card they launch their kernels, or raise
when the kernel does not take the dtype, shape or layout. ``.launches``
counts launches.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import cuda as _cuda
from apex_tpu_torch.ops import dispatch

__all__ = ["F_SINGLE_MAX", "ln_fwd", "ln_fwd_plain", "ln_bwd",
           "ln_bwd_plain"]

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


def ln_bwd_plain(dy2d, x2d, weight, mean, invvar):
    """Plain version of ``_bwd_kernel`` (layer_norm.py:105-135) in fp32:
    dx in x's dtype and, with ``weight``, the fp32 column sums
    ``sum(dy·xhat)`` and ``sum(dy)`` (None without)."""
    xf, dyf = x2d.float(), dy2d.float()
    inv = invvar[:, None]
    xhat = (xf - mean[:, None]) * inv
    dxhat = dyf * weight.float() if weight is not None else dyf
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    dx = (inv * (dxhat - m1 - xhat * m2)).to(x2d.dtype)
    if weight is None:
        return dx, None, None
    return dx, (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


# the column sums' first pass: about four blocks an SM on the H100
_BWD_CHUNKS = 4 * 132


def ln_bwd(dy2d, x2d, weight, mean, invvar):
    """LayerNorm backward of rows dy2d, x2d [rows, F] from the forward's
    fp32 mean and invvar [rows]; weight [F] or None. Returns (dx, gw, gb)
    like :func:`ln_bwd_plain`. The kernel's column sums add fixed chunks
    of rows in a fixed order, so they repeat bit for bit."""
    if not dispatch.use_kernel(x2d):
        return ln_bwd_plain(dy2d, x2d, weight, mean, invvar)
    rows, f = x2d.shape
    if dy2d.shape != x2d.shape or dy2d.dtype != x2d.dtype:
        raise ValueError("ln_bwd: dy and x must share one shape and dtype")
    for t, what in ((dy2d, "dy"), (x2d, "x")):
        if t.device != x2d.device or not t.is_contiguous() \
                or t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"ln_bwd: {what} must be contiguous and "
                             f"4-element aligned on one device")
    if not 0 < f <= F_SINGLE_MAX:
        raise NotImplementedError(
            f"ln_bwd: rows wider than {F_SINGLE_MAX} need the wide kernels, "
            f"which are not ported yet (ROADMAP.md Queue 1, item 13); got "
            f"F={f}")
    if f % 4:
        raise ValueError(f"ln_bwd: the kernel takes F a multiple of 4, "
                         f"got {f}")
    for t, what in ((mean, "mean"), (invvar, "invvar")):
        if t.dtype != torch.float32 or t.shape != (rows,) \
                or t.device != x2d.device:
            raise ValueError(f"ln_bwd: {what} must be fp32 [{rows}]")
    xc = _cuda.dtype_code(x2d.dtype, "ln_bwd")
    wc = 0
    if weight is not None:
        if weight.device != x2d.device or not weight.is_contiguous() \
                or weight.shape != (f,) \
                or weight.data_ptr() % (4 * weight.element_size()):
            raise ValueError(f"ln_bwd: weight must be a contiguous, aligned "
                             f"[{f}] tensor on {x2d.device}")
        wc = _cuda.dtype_code(weight.dtype, "ln_bwd weight")
    dx = torch.empty_like(x2d)
    if rows == 0:       # nothing to launch: empty dx, zero column sums
        if weight is None:
            return dx, None, None
        gw, gb = torch.zeros((2, f), dtype=torch.float32, device=x2d.device)
        return dx, gw, gb
    rpc = -(-rows // _BWD_CHUNKS)
    nchunk = -(-rows // rpc)
    ws = torch.empty((2, nchunk, f) if weight is not None else (1,),
                     dtype=torch.float32, device=x2d.device)
    sums = torch.empty((2, f), dtype=torch.float32, device=x2d.device)
    mean, invvar = mean.contiguous(), invvar.contiguous()
    err = _cuda.lib().apex_layer_norm_bwd(
        xc, wc, dy2d.data_ptr(), x2d.data_ptr(),
        weight.data_ptr() if weight is not None else None,
        mean.data_ptr(), invvar.data_ptr(),
        dx.data_ptr(), ws.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
        rows, f, rpc, nchunk, _cuda.stream(x2d.device))
    _cuda.check(err, "ln_bwd")
    ln_bwd.launches += 1
    if weight is None:
        return dx, None, None
    return dx, sums[0], sums[1]


ln_bwd.launches = 0
