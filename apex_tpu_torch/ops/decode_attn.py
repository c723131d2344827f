"""Single-query slot attention over the dense and paged KV arenas: the
kernel wrappers and their plain PyTorch versions.

Counterpart of ``apex_tpu/ops/pallas/decode_attn.py``. The two Pallas
kernels (``_decode_kernel``, ``_paged_decode_kernel``) become ONE CUDA
kernel body with two index modes (``ops/cuda/csrc/decode_attn.cu``), so a
paged decode sums in the same order as a dense one and the two agree
bitwise on the card.

For a tensor on the CPU a wrapper runs the plain version; for a tensor on
the card it launches the kernel, or raises when the kernel does not take
the dtype, shape or layout. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import cuda as _cuda
from apex_tpu_torch.ops import dispatch

__all__ = ["NEG_INF", "HEAD_DIM", "PAGE_MULTIPLE", "gather_pages",
           "decode_attention", "paged_decode_attention",
           "decode_attention_plain", "paged_decode_attention_plain"]

# the flash kernel's finite -inf stand-in (exp() of it is exactly 0.0 in
# fp32); shared so masked-lane math is bit-identical across versions
NEG_INF = -1.0e30

HEAD_DIM = 128     # the head_dim the kernel is written for
PAGE_MULTIPLE = 8  # the paged kernel's page_size must be a multiple of it


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Per-slot logical K or V views from a page pool: pool [P_phys, H,
    page, hd] + page_table i32 [S, P] -> [S, H, P*page, hd] (counterpart
    of ``contrib/multihead_attn/decode_attention.py:gather_pages``).
    Unmapped entries point at the null page 0, whose contents lie past
    every slot's length and are masked."""
    s, p = page_table.shape
    _, h, page, hd = pool.shape
    lanes = pool[page_table.long()]               # [S, P, H, page, hd]
    return lanes.movedim(2, 1).reshape(s, h, p * page, hd)


def decode_attention_plain(q, k, v, lengths, *, scale=None):
    """Plain version: q [S, H, hd], k/v [S, H, L, hd], lengths i32 [S].
    Op for op the math of ``reference_slot_decode_attention``
    (decode_attention.py:88-136): fp32 scores, finite NEG_INF masking,
    max, exp under where, sum, guarded divide. Returns [S, H, hd] in q's
    dtype."""
    hd = q.shape[-1]
    l_dim = k.shape[-2]
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    qf = q[:, :, None, :].float()                         # [S, H, 1, hd]
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale  # [S,H,1,L]
    k_pos = torch.arange(l_dim, device=q.device)[None, None, None, :]
    lmask = lengths.to(q.device)[:, None, None, None]
    s = torch.where(k_pos < lmask, s, torch.full_like(s, NEG_INF))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m),
                    torch.zeros_like(s))
    l_sum = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(l_sum > 0.0, l_sum, torch.ones_like(l_sum))
    o = torch.matmul(probs, v.float()).to(q.dtype)
    return o[:, :, 0, :]


def paged_decode_attention_plain(q, k, v, lengths, *, scale=None,
                                 page_table):
    """Plain version over page pools: gather each slot's logical view,
    then the dense plain math — bitwise equal to the dense plain version
    whenever the mapped pages hold the same bytes."""
    return decode_attention_plain(q, gather_pages(k, page_table),
                                  gather_pages(v, page_table), lengths,
                                  scale=scale)


def _check(name, q, k, v, lengths, page_table=None):
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (lengths, "lengths")):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {what} must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim {HEAD_DIM}, "
                         f"got {q.shape[-1]}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32")
    if lengths.shape != q.shape[:1]:
        raise ValueError(f"{name}: lengths must be [{q.shape[0]}], got "
                         f"{tuple(lengths.shape)}")
    if page_table is not None:
        if not page_table.is_cuda or page_table.device != q.device \
                or not page_table.is_contiguous() \
                or page_table.dtype != torch.int32:
            raise ValueError(f"{name}: page_table must be a contiguous "
                             f"int32 tensor on {q.device}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: q/k/v must be 16-byte aligned")


def _launch(q, k, v, lengths, page_table, scale, l_dim, page, max_pages):
    s_dim, h, hd = q.shape
    out = torch.empty_like(q)
    if s_dim * h == 0:
        return out
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    err = _cuda.lib().apex_decode_attention(
        _cuda.dtype_code(q.dtype, "decode_attention"), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        page_table.data_ptr() if page_table is not None else None,
        out.data_ptr(), s_dim, h, l_dim, page, max_pages,
        int(page_table is not None), float(scale), _cuda.stream(q.device))
    _cuda.check(err, "decode_attention")
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: "float | None" = None) -> torch.Tensor:
    """Single-query attention over the dense arena. q: [S, H, hd]; k/v:
    [S, H, L, hd] (garbage past each slot's length is never read);
    lengths: i32 [S]. Returns [S, H, hd] in q's dtype."""
    if not dispatch.use_kernel(q):
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    _check("decode_attention", q, k, v, lengths)
    s_dim, h, _ = q.shape
    if k.shape[:2] != (s_dim, h) or k.shape != v.shape:
        raise ValueError(f"decode_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    out = _launch(q, k, v, lengths, None, scale, k.shape[2], 1, 0)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           scale: "float | None" = None,
                           page_table: torch.Tensor) -> torch.Tensor:
    """Single-query attention over the PAGED arena. q: [S, H, hd]; k/v:
    page pools [P_phys, H, page, hd]; lengths: i32 [S]; page_table: i32
    [S, P_logical] (0 = the null page, always past a slot's length).
    The kernel follows the page table itself: no gathered view is ever
    built. Returns [S, H, hd] in q's dtype."""
    if not dispatch.use_kernel(q):
        return paged_decode_attention_plain(q, k, v, lengths, scale=scale,
                                            page_table=page_table)
    _check("paged_decode_attention", q, k, v, lengths, page_table)
    s_dim, h, _ = q.shape
    if k.shape[1] != h or k.shape != v.shape \
            or page_table.shape[0] != s_dim:
        raise ValueError(
            f"paged_decode_attention: k/v {tuple(k.shape)} or page_table "
            f"{tuple(page_table.shape)} do not match q {tuple(q.shape)}")
    if k.shape[2] % PAGE_MULTIPLE:
        raise ValueError(
            f"paged_decode_attention: the kernel takes page_size % "
            f"{PAGE_MULTIPLE} == 0, got {k.shape[2]}")
    out = _launch(q, k, v, lengths, page_table, scale, 0, k.shape[2],
                  page_table.shape[1])
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
