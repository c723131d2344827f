"""Per-channel BatchNorm passes over channels-last rows: the kernel
wrappers and their plain PyTorch versions.

Counterpart of ``apex_tpu/ops/pallas/welford.py``; the kernels are
``ops/cuda/csrc/welford.cu``:

- :func:`bn_moments` replaces ``bn_moments`` → ``_moments_kernel``
  (welford.py:60): per-channel ``(sum x, sum x²)`` in fp32;
- :func:`bn_backward_fused_reduce` replaces ``bn_backward_fused_reduce`` →
  ``_bwd_fused_reduce_kernel`` (:94): per-channel ``(sum dy, sum dy·xhat)``
  with xhat recomputed from the saved input and the relu mask read from
  the saved output;
- :func:`bn_backward_dx` replaces ``bn_backward_dx`` → ``_bwd_dx_kernel``
  (:152): ``dx = invvar·w·(dy − mean(dy) − xhat·mean(dy·xhat))`` and, for a
  fused residual, ``dz`` = the masked dy;
- :func:`bn_backward_reduce` replaces ``bn_backward_reduce`` →
  ``_bwd_reduce_kernel`` (:216), the reference Apex's ``reduce_bn``
  partial pass: per-channel ``(sum dy, sum dy·xhat)`` from a materialized
  xhat (the fused reduce's kernel body reading xhat instead of x).

Every tensor is a ``[rows, C]`` view (NHWC, or NCHW in channels_last
memory, flattened over N·H·W), of any C. The kernels take four channels a
thread with vector loads where C is a multiple of 4 and every tensor is
4-element aligned, else one channel a thread (the C side picks the form,
as it does for the LayerNorm kernels). For a
tensor on the CPU each wrapper runs its plain version; for a tensor on the
card it launches its kernel, or raises on what the kernel does not take
(no channels, mixed dtypes where one dtype is asked for, a strided view).
Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import functools

import torch

from apex_tpu_torch.ops import cuda as _cuda
from apex_tpu_torch.ops import dispatch

__all__ = ["bn_moments", "bn_moments_plain", "bn_backward_fused_reduce",
           "bn_backward_fused_reduce_plain", "bn_backward_dx",
           "bn_backward_dx_plain", "bn_backward_reduce",
           "bn_backward_reduce_plain"]

_BLOCKS_PER_SM = 8     # 256-thread blocks: a full SM's worth of threads


# -- plain versions -------------------------------------------------------------

def bn_moments_plain(x2d: torch.Tensor):
    """Plain version of ``_moments_kernel``: fp32 ``(sum x, sum x²)`` over
    the rows of x2d [rows, C]."""
    xf = x2d.float()
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def _masked_dy(dy2d, out2d):
    dyf = dy2d.float()
    if out2d is not None:      # fused relu: the output is 0 where it clipped
        dyf = torch.where(out2d.float() > 0, dyf,
                          torch.zeros((), device=dyf.device))
    return dyf


def bn_backward_fused_reduce_plain(dy2d, x2d, mean, invvar, out2d=None):
    """Plain version of ``_bwd_fused_reduce_kernel``: fp32 ``(sum dy,
    sum dy·xhat)`` with ``xhat = (x − mean)·invvar``; ``out2d`` masks dy
    where a fused relu clipped."""
    dyf = _masked_dy(dy2d, out2d)
    xhat = (x2d.float() - mean) * invvar
    return dyf.sum(dim=0), (dyf * xhat).sum(dim=0)


def bn_backward_reduce_plain(dy2d, xhat2d):
    """Plain version of ``_bwd_reduce_kernel``: fp32 ``(sum dy,
    sum dy·xhat)`` over the rows of dy2d, xhat2d [rows, C]."""
    dyf = dy2d.float()
    return dyf.sum(dim=0), (dyf * xhat2d.float()).sum(dim=0)


def bn_backward_dx_plain(dy2d, x2d, mean, invvar, winv, mean_dy,
                         mean_dy_xhat, out2d=None, emit_dz: bool = False):
    """Plain version of ``_bwd_dx_kernel``: ``dx`` (and ``dz``, the masked
    dy, when ``emit_dz``) in x's dtype; ``winv`` = invvar · weight."""
    dyf = _masked_dy(dy2d, out2d)
    xhat = (x2d.float() - mean) * invvar
    dx = (winv * (dyf - mean_dy - xhat * mean_dy_xhat)).to(x2d.dtype)
    return dx, (dyf.to(x2d.dtype) if emit_dz else None)


# -- kernel wrappers --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _chunks(rows: int, c: int, device: torch.device) -> int:
    """Row chunks of the grid: about eight blocks per SM over the channel
    tiles (32 threads across C's 4-channel vectors where C is a multiple
    of 4, across its channels otherwise, as the C side's two forms take
    them), each thread walking at least eight rows. A function of the
    shape only, so the sums' order, and their bits, repeat."""
    vecs = c // 4 if c % 4 == 0 else c
    tx = min(32, vecs)
    tiles = -(-vecs // tx)
    ty = 256 // tx
    want = -(-_BLOCKS_PER_SM * _sm_count(device) // tiles)
    return max(1, min(want, -(-rows // (8 * ty)), 65535))


def _check_rows(what: str, x2d: torch.Tensor, *others,
                one_dtype: bool = True):
    """The dtype code of contiguous [rows, C] inputs on one device."""
    if x2d.dim() != 2:
        raise ValueError(f"{what}: x must be a [rows, C] view")
    c = x2d.shape[1]
    if c == 0:
        raise ValueError(f"{what}: C=0, no channels to reduce")
    for t in (x2d, *others):
        if t is None:
            continue
        if t.shape != x2d.shape or t.device != x2d.device \
                or (one_dtype and t.dtype != x2d.dtype):
            raise ValueError(f"{what}: the inputs must be [rows, C] "
                             f"tensors{' of one dtype' * one_dtype} on one "
                             f"device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    return _cuda.dtype_code(x2d.dtype, what)


def _chan(what: str, c: int, device, *vecs) -> torch.Tensor:
    """The per-channel fp32 vectors as one contiguous [k, C] array."""
    for v in vecs:
        if v.shape != (c,) or v.device != device:
            raise ValueError(f"{what}: per-channel vectors must be [{c}] on "
                             f"{device}")
    return torch.stack([v.float() for v in vecs])


def bn_moments(x2d: torch.Tensor):
    """``(sum x, sum x²)`` fp32 [C] over the rows of x2d [rows, C]."""
    if not dispatch.use_kernel(x2d):
        return bn_moments_plain(x2d)
    code = _check_rows("bn_moments", x2d)
    rows, c = x2d.shape
    out = (torch.empty if rows else torch.zeros)(
        (2, c), dtype=torch.float32, device=x2d.device)
    if rows:
        n = _chunks(rows, c, x2d.device)
        ws = torch.empty((2, n, c), dtype=torch.float32, device=x2d.device)
        err = _cuda.lib().apex_bn_moments(
            code, x2d.data_ptr(), rows, c, n, ws.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), _cuda.stream(x2d.device))
        _cuda.check(err, "bn_moments")
        bn_moments.launches += 1
    return out[0], out[1]


bn_moments.launches = 0


def bn_backward_fused_reduce(dy2d, x2d, mean, invvar, out2d=None):
    """``(sum dy, sum dy·xhat)`` fp32 [C]; ``out2d`` (the primal output)
    masks dy where a fused relu clipped."""
    if not dispatch.use_kernel(x2d):
        return bn_backward_fused_reduce_plain(dy2d, x2d, mean, invvar, out2d)
    code = _check_rows("bn_backward_fused_reduce", x2d, dy2d, out2d)
    rows, c = x2d.shape
    pc = _chan("bn_backward_fused_reduce", c, x2d.device, mean, invvar)
    out = (torch.empty if rows else torch.zeros)(
        (2, c), dtype=torch.float32, device=x2d.device)
    if rows:
        n = _chunks(rows, c, x2d.device)
        ws = torch.empty((2, n, c), dtype=torch.float32, device=x2d.device)
        err = _cuda.lib().apex_bn_bwd_reduce(
            code, dy2d.data_ptr(), x2d.data_ptr(),
            out2d.data_ptr() if out2d is not None else None,
            pc[0].data_ptr(), pc[1].data_ptr(), rows, c, n, ws.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), _cuda.stream(x2d.device))
        _cuda.check(err, "bn_backward_fused_reduce")
        bn_backward_fused_reduce.launches += 1
    return out[0], out[1]


bn_backward_fused_reduce.launches = 0


def bn_backward_dx(dy2d, x2d, mean, invvar, winv, mean_dy, mean_dy_xhat,
                   out2d=None, emit_dz: bool = False):
    """``(dx, dz)`` in x's dtype (``dz`` None unless ``emit_dz``), as
    :func:`bn_backward_dx_plain`."""
    if not dispatch.use_kernel(x2d):
        return bn_backward_dx_plain(dy2d, x2d, mean, invvar, winv, mean_dy,
                                    mean_dy_xhat, out2d, emit_dz)
    code = _check_rows("bn_backward_dx", x2d, dy2d, out2d)
    rows, c = x2d.shape
    pc = _chan("bn_backward_dx", c, x2d.device, mean, invvar, winv, mean_dy,
               mean_dy_xhat)
    dx = torch.empty_like(x2d)
    dz = torch.empty_like(x2d) if emit_dz else None
    if rows:
        err = _cuda.lib().apex_bn_bwd_dx(
            code, dy2d.data_ptr(), x2d.data_ptr(),
            out2d.data_ptr() if out2d is not None else None, pc.data_ptr(),
            dx.data_ptr(), dz.data_ptr() if dz is not None else None, rows,
            c, _chunks(rows, c, x2d.device), _cuda.stream(x2d.device))
        _cuda.check(err, "bn_backward_dx")
        bn_backward_dx.launches += 1
    return dx, dz


bn_backward_dx.launches = 0


def bn_backward_reduce(dy2d, xhat2d):
    """``(sum dy, sum dy·xhat)`` fp32 [C] over the rows of dy2d and the
    materialized xhat2d [rows, C]; each may be fp32, bf16 or fp16."""
    if not dispatch.use_kernel(dy2d):
        return bn_backward_reduce_plain(dy2d, xhat2d)
    xc = _check_rows("bn_backward_reduce", xhat2d, dy2d, one_dtype=False)
    dc = _cuda.dtype_code(dy2d.dtype, "bn_backward_reduce")
    rows, c = xhat2d.shape
    out = (torch.empty if rows else torch.zeros)(
        (2, c), dtype=torch.float32, device=dy2d.device)
    if rows:
        n = _chunks(rows, c, dy2d.device)
        ws = torch.empty((2, n, c), dtype=torch.float32, device=dy2d.device)
        err = _cuda.lib().apex_bn_bwd_reduce_xhat(
            dc, xc, dy2d.data_ptr(), xhat2d.data_ptr(), rows, c, n,
            ws.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            _cuda.stream(dy2d.device))
        _cuda.check(err, "bn_backward_reduce")
        bn_backward_reduce.launches += 1
    return out[0], out[1]


bn_backward_reduce.launches = 0
