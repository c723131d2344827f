"""Flash attention over ``[BH, S, D]``: the kernel wrappers and their plain
PyTorch versions.

Counterpart of the Pallas kernels in
``apex_tpu/contrib/multihead_attn/flash_attention.py`` (the kernels are
``ops/cuda/csrc/flash_attn.cu``):

- :func:`flash_fwd` replaces ``_flash_fwd`` → ``_fwd_kernel`` (:181): the
  output and the per-row logsumexp; its plain version is
  :func:`reference_attention` with ``return_lse=True`` (:586-631);
- :func:`flash_bwd_dq` replaces ``_bwd_dq_kernel`` (:349) and
  :func:`flash_bwd_dkv` ``_bwd_dkv_kernel`` (:392); their plain version is
  :func:`flash_bwd_plain`, a port of ``_bwd_chunked`` (:634-729), chunked
  over the keys so that it fits at full length on the card.

The backward takes ``delta = rowsum(dO·O) − dlse`` (:474-479, computed
here in plain PyTorch by :func:`flash_delta`), so a cotangent of the lse
folds into the same per-row term.

``kv_bias`` [1|BH, Sk] is a per-key additive score bias (key-padding
masks: 0 or -1e30), added before the softmax and broadcast over the
queries, as ``kv_bias[..., None, :]`` at :607 and :682; its bh index is
b·H + h, the order of ``_split_heads``. It is mask data: no gradient
flows to it.

For tensors on the CPU each wrapper runs its plain version; for tensors on
the card it launches its kernel, which takes bf16 and a head dim of 64 or
128 and raises on anything else. The kernels read q, k, v and dO through
their strides (the last dim contiguous, every stride a multiple of 8
elements, the base 16-byte aligned); a view that is not so is copied once
to a contiguous tensor. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import cuda as _cuda
from apex_tpu_torch.ops import dispatch

__all__ = ["NEG_INF", "KERNEL_HEAD_DIMS", "reference_attention",
           "flash_fwd", "flash_delta", "flash_bwd_plain", "flash_bwd_dq",
           "flash_bwd_dkv"]

# finite -inf stand-in: exp(NEG_INF - m) is exactly 0.0 in fp32, so a fully
# masked row yields zeros instead of NaN
NEG_INF = -1.0e30
KERNEL_HEAD_DIMS = (64, 128)


def _causal_mask(sq: int, sk: int, q_start: int, k_start: int, device):
    q_pos = q_start + torch.arange(sq, device=device)[:, None]
    k_pos = k_start + torch.arange(sk, device=device)[None, :]
    return q_pos >= k_pos


def reference_attention(q, k, v, bias=None, *, kv_bias=None,
                        causal: bool = False, scale=None,
                        q_start: int = 0, k_start: int = 0,
                        return_lse: bool = False):
    """Unfused attention: q [..., Sq, d], k/v [..., Sk, d]; ``bias`` an
    additive score bias broadcastable to [..., Sq, Sk], ``kv_bias`` a
    per-key one [..., Sk] broadcast over the queries. With ``causal``,
    query row i (absolute position ``q_start + i``) sees keys at absolute
    positions ``k_start + j <= q_start + i``. Returns [..., Sq, d] in q's
    dtype and, with ``return_lse``, the fp32 per-row logsumexp [..., Sq]
    (``NEG_INF`` for a row that sees nothing). Op for op the JAX package's
    ``reference_attention`` (flash_attention.py:586-631): fp32 scores, the
    biases, finite ``NEG_INF`` masking, max, exp under where, sum, guarded
    divide."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if kv_bias is not None:
        s = s + kv_bias.float()[..., None, :]
    if causal:
        s = torch.where(_causal_mask(sq, sk, q_start, k_start, q.device), s,
                        torch.full_like(s, NEG_INF))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m),
                    torch.zeros_like(s))
    l_sum = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l_sum > 0.0, l_sum, torch.ones_like(l_sum))
    o = torch.matmul(p / safe, v.float()).to(q.dtype)
    if return_lse:
        lse = torch.where(l_sum > 0.0, m + torch.log(safe),
                          torch.full_like(m, NEG_INF))[..., 0]
        return o, lse
    return o


def flash_delta(o, do, dlse=None):
    """fp32 [BH, Sq]: ``rowsum(dO·O)``, minus the lse cotangent when there
    is one."""
    delta = torch.sum(do.float() * o.float(), dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


def flash_bwd_plain(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                    q_start: int = 0, k_start: int = 0, kv_bias=None,
                    block_k: int = 128):
    """Plain version of both backward kernels, ``_bwd_chunked``'s recurrence
    (flash_attention.py:634-729) over key chunks of ``block_k``: p is
    recomputed from lse (0 where the biased, masked score is below
    ``NEG_INF / 2``, so a row whose every key is masked gets none),
    ``ds = p·(dP − delta)``. Returns (dq, dk, dv) in q's, k's and v's
    dtypes."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qf, dof = q.float(), do.float()
    lse_c, dlt_c = lse.float()[..., None], delta.float()[..., None]
    dq = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((bh, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for j0 in range(0, sk, block_k):
        j1 = min(j0 + block_k, sk)
        kj, vj = k[:, j0:j1].float(), v[:, j0:j1].float()
        s = torch.matmul(qf, kj.transpose(1, 2)) * scale
        if kv_bias is not None:
            s = s + kv_bias[:, None, j0:j1].float()
        if causal:
            s = torch.where(_causal_mask(sq, j1 - j0, q_start, k_start + j0,
                                         q.device), s,
                            torch.full_like(s, NEG_INF))
        p = torch.where(s > NEG_INF * 0.5, torch.exp(s - lse_c),
                        torch.zeros_like(s))
        dp = torch.matmul(dof, vj.transpose(1, 2))
        dv[:, j0:j1] = torch.matmul(p.transpose(1, 2), dof)
        ds = p * (dp - dlt_c) * scale
        dq += torch.matmul(ds, kj)
        dk[:, j0:j1] = torch.matmul(ds.transpose(1, 2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(what: str, *ts):
    """The kernels' contract: bf16 [BH, S, D] on one card, D 64 or 128."""
    dev, d = ts[0].device, ts[0].shape[-1]
    for t in ts:
        if t.dim() != 3 or t.shape[-1] != d or t.shape[0] != ts[0].shape[0]:
            raise ValueError(f"{what}: expected [BH, S, D] tensors of one "
                             f"BH and D, got {[tuple(x.shape) for x in ts]}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors must share one device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the kernel takes bfloat16, got "
                            f"{t.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if ts[0].shape[0] > 65535 or ts[0].shape[1] == 0 or ts[1].shape[1] == 0:
        raise ValueError(f"{what}: needs 1 <= S and BH <= 65535")


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` when the kernel can read it through its strides, else one
    contiguous copy."""
    if t.stride(-1) == 1 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0 \
            and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def _kv_bias(what: str, kv_bias, bh: int, sk: int, device):
    """(pointer, bh stride, tensor) of a kv_bias [1|BH, Sk] as fp32 with
    contiguous keys, the tensor kept by the caller until the launch;
    (None, 0, None) without one."""
    if kv_bias is None:
        return None, 0, None
    if kv_bias.dim() != 2 or kv_bias.shape[0] not in (1, bh) \
            or kv_bias.shape[1] != sk or kv_bias.device != device:
        raise ValueError(f"{what}: kv_bias must be [1 or {bh}, {sk}] on "
                         f"{device}, got {tuple(kv_bias.shape)}")
    kvb = kv_bias.float().contiguous()
    return kvb.data_ptr(), (sk if kvb.shape[0] == bh else 0), kvb


def _row_stats(what: str, t: torch.Tensor, bh: int, sq: int, device):
    if t.dtype != torch.float32 or tuple(t.shape) != (bh, sq) \
            or t.device != device:
        raise ValueError(f"{what}: must be fp32 [{bh}, {sq}] on {device}")
    return t.contiguous()


def flash_fwd(q, k, v, *, causal: bool = False, scale=None,
              q_start: int = 0, k_start: int = 0, kv_bias=None):
    """(o [BH, Sq, D] in q's dtype, lse fp32 [BH, Sq]) of softmax attention
    over q [BH, Sq, D], k/v [BH, Sk, D], with an optional per-key
    ``kv_bias`` [1|BH, Sk]."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if not dispatch.use_kernel(q):
        return reference_attention(q, k, v, kv_bias=kv_bias, causal=causal,
                                   scale=scale, q_start=q_start,
                                   k_start=k_start, return_lse=True)
    _check("flash_fwd", q, k, v)
    q, k, v = _readable(q), _readable(k), _readable(v)
    bh, sq, d = q.shape
    kvb_ptr, kvb_bh, _keep = _kv_bias("flash_fwd", kv_bias, bh, k.shape[1],
                                      q.device)
    o = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    err = _cuda.lib().apex_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), kvb_ptr, kvb_bh, bh, sq, k.shape[1], d,
        int(q_start), int(k_start), int(bool(causal)), float(scale),
        _cuda.stream(q.device))
    _cuda.check(err, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def _bwd_args(what, q, k, v, do, lse, delta):
    _check(what, q, k, v, do)
    bh, sq, _ = q.shape
    q, k, v, do = (_readable(t) for t in (q, k, v, do))
    lse = _row_stats(f"{what} lse", lse, bh, sq, q.device)
    delta = _row_stats(f"{what} delta", delta, bh, sq, q.device)
    return q, k, v, do, lse, delta


def _common(q, k, v, do, kvb, causal, scale, q_start, k_start):
    return (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), do.stride(0), do.stride(1), *kvb[:2], q.shape[0],
            q.shape[1], k.shape[1], q.shape[2], int(q_start), int(k_start),
            int(bool(causal)), float(scale), _cuda.stream(q.device))


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                 q_start: int = 0, k_start: int = 0, kv_bias=None):
    """dq [BH, Sq, D] in q's dtype from the forward's lse and
    :func:`flash_delta`."""
    if not dispatch.use_kernel(q):
        return flash_bwd_plain(q, k, v, do, lse, delta, causal=causal,
                               scale=scale, q_start=q_start,
                               k_start=k_start, kv_bias=kv_bias)[0]
    q, k, v, do, lse, delta = _bwd_args("flash_bwd_dq", q, k, v, do, lse,
                                        delta)
    kvb = _kv_bias("flash_bwd_dq", kv_bias, q.shape[0], k.shape[1],
                   q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _cuda.lib().apex_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_common(q, k, v, do, kvb, causal, scale, q_start, k_start))
    _cuda.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                  q_start: int = 0, k_start: int = 0, kv_bias=None):
    """(dk, dv) [BH, Sk, D] in k's and v's dtypes."""
    if not dispatch.use_kernel(q):
        return flash_bwd_plain(q, k, v, do, lse, delta, causal=causal,
                               scale=scale, q_start=q_start,
                               k_start=k_start, kv_bias=kv_bias)[1:]
    q, k, v, do, lse, delta = _bwd_args("flash_bwd_dkv", q, k, v, do, lse,
                                        delta)
    kvb = _kv_bias("flash_bwd_dkv", kv_bias, q.shape[0], k.shape[1],
                   q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _cuda.lib().apex_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_common(q, k, v, do, kvb, causal, scale, q_start, k_start))
    _cuda.check(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0
