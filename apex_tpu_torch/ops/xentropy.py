"""Softmax cross-entropy over rows: the kernel wrappers and their plain
PyTorch versions.

Counterpart of ``apex_tpu/ops/pallas/xentropy.py`` (the kernels are
``ops/cuda/csrc/xentropy.cu``):

- :func:`xent_fwd` replaces ``xent_fwd`` → ``_fwd_kernel`` (:55): each
  row's label-smoothed loss ``lse − (1−ε)·x_y − ε·Σx/V`` and its
  logsumexp;
- :func:`xent_bwd` replaces ``xent_bwd`` → ``_bwd_kernel`` (:131):
  ``dx = g·(exp(x − lse) − (1−ε)·onehot − ε/V)`` in the logits' dtype.

A label outside ``[0, V)`` matches no column, so its ``x_y`` is 0, as the
Pallas kernels' compare with the column index gives. Rows whose loss must
be masked (``padding_idx``) are the caller's: the forward computes every
row, and the backward's ``g`` is already zero on them.

For tensors on the CPU each wrapper runs its plain version; for tensors
on the card it launches its kernel, which takes fp32 or bf16 logits [N, V]
read through their row stride (the columns contiguous; a view that is not
so is copied once) and int32 or int64 labels, any N >= 0 and V >= 1, and
raises on anything else. Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import cuda as _cuda
from apex_tpu_torch.ops import dispatch

__all__ = ["label_logits", "xent_fwd", "xent_fwd_plain", "xent_bwd",
           "xent_bwd_plain"]

_LOGIT_DTYPES = (torch.float32, torch.bfloat16)


def label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """fp32 ``logits[..., i, labels[i]]``, 0 where the label is outside
    [0, V): what the JAX package's compare with the class index and
    masked sum give (``select_label_logits``, the kernels' ``x_y``).
    Differentiable; ``labels`` has the logits' leading shape."""
    lf = logits.float()
    v = lf.shape[-1]
    lab = labels.long()
    inside = (lab >= 0) & (lab < v)
    got = lf.gather(-1, lab.clamp(0, v - 1)[..., None])[..., 0]
    return torch.where(inside, got, torch.zeros_like(got))


def xent_fwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                   smoothing: float):
    """Plain version of ``_fwd_kernel`` in fp32: (losses [N], lse [N])."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    loss = lse - (1.0 - smoothing) * label_logits(lf, labels)
    if smoothing > 0.0:
        loss = loss - smoothing * lf.sum(dim=-1) / lf.shape[1]
    return loss, lse


def xent_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                   lse: torch.Tensor, g: torch.Tensor, smoothing: float):
    """Plain version of ``_bwd_kernel``: dx [N, V] in the logits' dtype, in
    the kernel's order of operations (fp32, in place on one buffer)."""
    n, v = logits.shape
    dx = logits.float() - lse.float()[:, None]
    dx.exp_()
    lab = labels.long()
    rows = torch.nonzero((lab >= 0) & (lab < v))[:, 0]
    dx[rows, lab[rows]] -= 1.0 - smoothing
    if smoothing > 0.0:
        dx.sub_(smoothing / v)
    dx.mul_(g.float()[:, None])
    return dx.to(logits.dtype)


def _args(what: str, logits: torch.Tensor, labels: torch.Tensor):
    """The kernels' contract: (logits with contiguous columns, contiguous
    labels, whether the row start, row stride and V allow 16-byte
    loads)."""
    if logits.dim() != 2 or logits.shape[1] < 1:
        raise ValueError(f"{what}: logits must be [N, V] with V >= 1, got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in _LOGIT_DTYPES:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16 "
                        f"logits, got {logits.dtype}")
    n, v = logits.shape
    if n > 2 ** 31 - 1:
        raise ValueError(f"{what}: at most 2**31 - 1 rows")
    if labels.dtype not in (torch.int32, torch.int64) \
            or tuple(labels.shape) != (n,) \
            or labels.device != logits.device:
        raise ValueError(f"{what}: labels must be int32 or int64 [{n}] on "
                         f"{logits.device}")
    if logits.stride(1) != 1:
        logits = logits.contiguous()
    per = 16 // logits.element_size()
    vec = logits.data_ptr() % 16 == 0 and logits.stride(0) % per == 0 \
        and v % per == 0
    return logits, labels.contiguous(), vec


def _row_values(what: str, t: torch.Tensor, n: int, device):
    if tuple(t.shape) != (n,) or t.device != device:
        raise ValueError(f"{what}: must be [{n}] on {device}")
    return t.float().contiguous()


def xent_fwd(logits: torch.Tensor, labels: torch.Tensor, smoothing: float):
    """(losses fp32 [N], lse fp32 [N]) of logits [N, V] and labels [N]."""
    if not dispatch.use_kernel(logits):
        return xent_fwd_plain(logits, labels, smoothing)
    logits, labels, vec = _args("xent_fwd", logits, labels)
    n, v = logits.shape
    loss, lse = torch.empty((2, n), dtype=torch.float32,
                            device=logits.device)
    if n == 0:
        return loss, lse
    err = _cuda.lib().apex_xent_fwd(
        _cuda.dtype_code(logits.dtype, "xent_fwd"), logits.data_ptr(),
        logits.stride(0), labels.data_ptr(),
        int(labels.dtype == torch.int64), n, v, int(vec), float(smoothing),
        1.0 - float(smoothing), loss.data_ptr(), lse.data_ptr(),
        _cuda.stream(logits.device))
    _cuda.check(err, "xent_fwd")
    xent_fwd.launches += 1
    return loss, lse


xent_fwd.launches = 0


def xent_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
             g: torch.Tensor, smoothing: float):
    """dx [N, V] in the logits' dtype from the forward's lse and the loss
    cotangent ``g`` [N] (already zero on masked rows)."""
    if not dispatch.use_kernel(logits):
        return xent_bwd_plain(logits, labels, lse, g, smoothing)
    logits, labels, vec = _args("xent_bwd", logits, labels)
    n, v = logits.shape
    lse = _row_values("xent_bwd lse", lse, n, logits.device)
    g = _row_values("xent_bwd g", g, n, logits.device)
    dx = torch.empty((n, v), dtype=logits.dtype, device=logits.device)
    if n == 0:
        return dx
    err = _cuda.lib().apex_xent_bwd(
        _cuda.dtype_code(logits.dtype, "xent_bwd"), logits.data_ptr(),
        logits.stride(0), labels.data_ptr(),
        int(labels.dtype == torch.int64), lse.data_ptr(), g.data_ptr(), n,
        v, int(vec), 1.0 - float(smoothing), float(smoothing) / v,
        int(smoothing > 0.0), dx.data_ptr(), _cuda.stream(logits.device))
    _cuda.check(err, "xent_bwd")
    xent_bwd.launches += 1
    return dx


xent_bwd.launches = 0
