"""LayerNorm over rows: the kernel wrappers and their plain PyTorch
versions.

Counterpart of ``apex_tpu/ops/pallas/layer_norm.py``; the kernels are
``ops/cuda/csrc/layer_norm.cu``:

- rows of F <= 8192 (``F_SINGLE_MAX``): ``_ln_fwd_single`` /
  ``_fwd_kernel`` and ``_ln_bwd_single`` / ``_bwd_kernel``, one pass;
- wider rows: ``_ln_fwd_wide`` (the moments, then y) and ``_ln_bwd_wide``
  (the row sums, the gamma/beta gradients, then dx) (:func:`ln_fwd_wide`,
  :func:`ln_bwd_wide`). Up to 16384 values the forward holds a row in one
  block and the backward streams rows through shared memory
  (``csrc/ln_bwd_row.cu``), each reading its rows once; wider rows are
  cut into chunks of 1024 columns.

Every kernel takes any F: four columns a load where F is a multiple of 4
and every buffer is 4-element aligned, one otherwise; the chunked wide
backward takes two where F is even and every buffer 2-element aligned, the
one-pass one the widest of 16 bytes, 8, 4 and one value that F and every
buffer allow (the C side picks the form).

:func:`ln_fwd` and :func:`ln_bwd` take a row's width to one or the other.
For a tensor on the CPU every wrapper runs its plain version; for a tensor
on the card it launches its kernels, or raises when they do not take the
dtype, shape or layout. ``.launches`` counts a wrapper's calls that
launched.
"""

from __future__ import annotations

import ctypes

import torch

from apex_tpu_torch.ops import cuda as _cuda
from apex_tpu_torch.ops import dispatch

__all__ = ["F_SINGLE_MAX", "ROW_MAX", "ln_fwd", "ln_fwd_plain",
           "ln_fwd_wide", "ln_bwd", "ln_bwd_plain", "ln_bwd_wide",
           "row_plan"]

F_SINGLE_MAX = 8192   # widest row the one-pass kernels hold on chip
_WIDE_COLS = 1024     # a wide kernel's chunk of a row (kWideCols)
# the chunked wide backward's first pass: about eight blocks an SM on the
# H100, a function of the shape only, so the column sums' order repeats
_WIDE_BLOCKS = 8 * 132
ROW_MAX = 16384       # widest row of the one-pass wide kernels (kRowMax)
# the one-pass backward's grid is at most the H100's 132 SMs (kLnbSms)
_ROW_GRID = 132


def row_plan(rows: int, f: int, x_size: int, w_size: int) -> dict:
    """The launch the one-pass wide backward makes at F <= ``ROW_MAX``
    (``csrc/ln_row_plan.cuh``), from the shape and the element sizes of x
    and of gamma (0 without) only: ``cluster`` blocks share a row (1, or 2
    that take its halves), ``stages`` rows in each block's ring,
    ``clusters`` in the grid, ``smem`` bytes of shared memory a block, and
    ``vec`` values a load on 16-byte-aligned buffers. Asks the built
    kernels, so it needs the card's toolchain."""
    out = (ctypes.c_int * 5)()
    if _cuda.lib().apex_layer_norm_bwd_row_plan(rows, f, x_size, w_size,
                                                out):
        raise ValueError(f"row_plan: no one-pass launch at rows {rows}, "
                         f"F {f}")
    return dict(zip(("cluster", "stages", "clusters", "smem", "vec"), out))


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


def _affine_code(what, x2d, weight, bias) -> int:
    """The dtype code of gamma and beta (0 without them), after checking
    that they come together as contiguous [F] tensors on x's device."""
    if (weight is None) != (bias is None):
        raise ValueError(f"{what}: pass weight and bias together")
    if weight is None:
        return 0
    f = x2d.shape[1]
    for t, name in ((weight, "weight"), (bias, "bias")):
        if t.device != x2d.device or not t.is_contiguous() \
                or t.shape != (f,):
            raise ValueError(f"{what}: {name} must be a contiguous [{f}] "
                             f"tensor on {x2d.device}")
    if bias.dtype != weight.dtype:
        raise TypeError(f"{what}: weight and bias dtypes differ")
    return _cuda.dtype_code(weight.dtype, f"{what} weight")


def _check_rows(what, x2d, *others):
    """The rows' layout the backward kernels and the wide forward take:
    F >= 1, every tensor contiguous, on x's device. Alignment only picks
    the kernels' form."""
    if x2d.shape[1] == 0:
        raise ValueError(f"{what}: rows of width 0")
    for t, name in ((x2d, "x"), *others):
        if t.device != x2d.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{x2d.device}")


def ln_fwd(x2d: torch.Tensor, weight, bias, eps: float):
    """LayerNorm forward of each row of x2d [rows, F]; weight/bias [F]
    (both or neither). Returns (y, mean, invvar) like :func:`ln_fwd_plain`."""
    if not dispatch.use_kernel(x2d):
        return ln_fwd_plain(x2d, weight, bias, eps)
    rows, f = x2d.shape
    if f > F_SINGLE_MAX:
        return ln_fwd_wide(x2d, weight, bias, eps)
    if not x2d.is_contiguous():
        raise ValueError("ln_fwd: x must be contiguous")
    if f == 0:
        raise ValueError("ln_fwd: rows of width 0")
    xc = _cuda.dtype_code(x2d.dtype, "ln_fwd")
    wc = _affine_code("ln_fwd", x2d, weight, bias)
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


def ln_fwd_wide(x2d: torch.Tensor, weight, bias, eps: float):
    """:func:`ln_fwd` by the wide kernels, which take a row of any width,
    its statistics after a shift by the row's first
    value: up to 16384 one block a row, x read once into registers, the
    mean and the centred sum of squares taken from them and y written;
    wider, per chunk of 1024 columns the sum and the centred sum of
    squares, then each chunk's y from the row's merged statistics (two
    launches; the C side picks the form). Returns (y, mean, invvar) like
    :func:`ln_fwd_plain`; one count."""
    if not dispatch.use_kernel(x2d):
        return ln_fwd_plain(x2d, weight, bias, eps)
    rows, f = x2d.shape
    _check_rows("ln_fwd", x2d)
    xc = _cuda.dtype_code(x2d.dtype, "ln_fwd")
    wc = _affine_code("ln_fwd", x2d, weight, bias)
    y = torch.empty_like(x2d)
    mean, inv = torch.empty((2, rows), dtype=torch.float32,
                            device=x2d.device)
    if rows == 0:
        return y, mean, inv
    # the chunked form's scratch (under 1 MB at the wide LM's shape), unused
    # by the one-pass form
    part = torch.empty((rows, -(-f // _WIDE_COLS), 2), dtype=torch.float32,
                       device=x2d.device)
    err = _cuda.lib().apex_layer_norm_fwd_wide(
        xc, wc, x2d.data_ptr(),
        weight.data_ptr() if weight is not None else None,
        bias.data_ptr() if bias is not None else None,
        y.data_ptr(), mean.data_ptr(), inv.data_ptr(), part.data_ptr(),
        rows, f, float(eps), _cuda.stream(x2d.device))
    _cuda.check(err, "ln_fwd_wide")
    ln_fwd_wide.launches += 1
    return y, mean, inv


ln_fwd_wide.launches = 0


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


def _bwd_codes(what, dy2d, x2d, weight, mean, invvar):
    """(x's, weight's dtype code) after the backward's checks of dy, the
    row statistics and the weight."""
    rows, f = x2d.shape
    if dy2d.shape != x2d.shape or dy2d.dtype != x2d.dtype:
        raise ValueError(f"{what}: dy and x must share one shape and dtype")
    for t, name in ((mean, "mean"), (invvar, "invvar")):
        if t.dtype != torch.float32 or t.shape != (rows,) \
                or t.device != x2d.device:
            raise ValueError(f"{what}: {name} must be fp32 [{rows}]")
    xc = _cuda.dtype_code(x2d.dtype, what)
    if weight is None:
        return xc, 0
    if weight.device != x2d.device or not weight.is_contiguous() \
            or weight.shape != (f,):
        raise ValueError(f"{what}: weight must be a contiguous [{f}] "
                         f"tensor on {x2d.device}")
    return xc, _cuda.dtype_code(weight.dtype, f"{what} weight")


def _no_rows(dx, weight):
    """Nothing to launch: the empty dx and zero column sums."""
    if weight is None:
        return dx, None, None
    gw, gb = torch.zeros((2, dx.shape[1]), dtype=torch.float32,
                         device=dx.device)
    return dx, gw, gb


def ln_bwd(dy2d, x2d, weight, mean, invvar):
    """LayerNorm backward of rows dy2d, x2d [rows, F] from the forward's
    fp32 mean and invvar [rows]; weight [F] or None. Returns (dx, gw, gb)
    like :func:`ln_bwd_plain`. The kernel's column sums add fixed chunks
    of rows in a fixed order, so they repeat bit for bit."""
    if not dispatch.use_kernel(x2d):
        return ln_bwd_plain(dy2d, x2d, weight, mean, invvar)
    rows, f = x2d.shape
    if f > F_SINGLE_MAX:
        return ln_bwd_wide(dy2d, x2d, weight, mean, invvar)
    xc, wc = _bwd_codes("ln_bwd", dy2d, x2d, weight, mean, invvar)
    _check_rows("ln_bwd", x2d, (dy2d, "dy"))
    dx = torch.empty_like(x2d)
    if rows == 0:
        return _no_rows(dx, weight)
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


def ln_bwd_wide(dy2d, x2d, weight, mean, invvar):
    """:func:`ln_bwd` by the wide kernels. Up to ``ROW_MAX`` one pass
    (its launch: :func:`row_plan`): a persistent grid, each block a fixed
    run of rows through a ring of shared-memory stages filled by TMA, dy
    and x read once, each row's sums of dy·γ and dy·γ·xhat, then its dx,
    and the column sums of dy·xhat and dy in registers across the run,
    whose partials add over the blocks in a fixed order. Wider rows: one
    pass over (row block, chunk) tiles writes each row's chunk sums and
    each row block's column sums, the column sums add in a fixed order,
    then each chunk's dx from its row's merged sums. Returns (dx, gw, gb)
    like :func:`ln_bwd_plain`, bit for bit the same on a repeat; two
    launches (one without weight) to ``ROW_MAX``, three (two) past it; one
    count."""
    if not dispatch.use_kernel(x2d):
        return ln_bwd_plain(dy2d, x2d, weight, mean, invvar)
    rows, f = x2d.shape
    xc, wc = _bwd_codes("ln_bwd", dy2d, x2d, weight, mean, invvar)
    _check_rows("ln_bwd", x2d, (dy2d, "dy"))
    dx = torch.empty_like(x2d)
    if rows == 0:
        return _no_rows(dx, weight)
    sums = torch.empty((2, f) if weight is not None else (1,),
                       dtype=torch.float32, device=x2d.device)
    mean, invvar = mean.contiguous(), invvar.contiguous()
    ptrs = (dy2d.data_ptr(), x2d.data_ptr(),
            weight.data_ptr() if weight is not None else None,
            mean.data_ptr(), invvar.data_ptr(), dx.data_ptr())
    out = ((sums[0].data_ptr(), sums[1].data_ptr()) if weight is not None
           else (None, None))
    if f <= ROW_MAX:
        # the C side plans the launch; its partials fit in min(rows, 132)
        ws = torch.empty((2, min(rows, _ROW_GRID), f) if weight is not None
                         else (1,), dtype=torch.float32, device=x2d.device)
        err = _cuda.lib().apex_layer_norm_bwd_row(
            xc, wc, *ptrs, ws.data_ptr(), *out, rows, f,
            _cuda.stream(x2d.device))
    else:
        nchunk = -(-f // _WIDE_COLS)
        nrb = min(-(-_WIDE_BLOCKS // nchunk), -(-rows // 8), 65535)
        rpc = -(-rows // nrb)
        nrb = -(-rows // rpc)
        rpart = torch.empty((rows, nchunk, 2), dtype=torch.float32,
                            device=x2d.device)
        ws = torch.empty((2, nrb, f) if weight is not None else (1,),
                         dtype=torch.float32, device=x2d.device)
        err = _cuda.lib().apex_layer_norm_bwd_wide(
            xc, wc, *ptrs, rpart.data_ptr(), ws.data_ptr(), *out, rows, f,
            rpc, nrb, _cuda.stream(x2d.device))
    _cuda.check(err, "ln_bwd_wide")
    ln_bwd_wide.launches += 1
    if weight is None:
        return dx, None, None
    return dx, sums[0], sums[1]


ln_bwd_wide.launches = 0
