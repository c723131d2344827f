"""Slot attention over the dense and paged KV arenas, one query a slot or
Q rows a slot: the kernel wrappers and their plain PyTorch versions.

Counterpart of ``apex_tpu/ops/pallas/decode_attn.py``. The two Pallas
kernels (``_decode_kernel``, ``_paged_decode_kernel``) become ONE CUDA
kernel body with two index modes (``ops/cuda/csrc/decode_attn.cu``), its
keys split across blocks in chunks of :data:`DECODE_CHUNK` positions
(:func:`decode_chunks`), and a merge kernel (:func:`decode_merge`) that
adds a row's chunks in chunk order. The chunks depend on the positions
only, so a paged decode sums in the same order as a dense one and the two
agree bitwise on the card.

For a tensor on the CPU a wrapper runs the plain version; for a tensor on
the card it launches the kernel (head dims :data:`HEAD_DIMS`; fp32, bf16,
fp16), or raises when the kernel does not take the dtype, shape or layout.
Each wrapper counts its launches in ``<wrapper>.launches``.

The multi-row form (speculative scoring: q [S, Q, H, hd], lengths [S, Q],
each row masked to its own length) is the same kernel reading each K/V
chunk once for all the slot's rows (:func:`decode_attention_rows`,
:func:`paged_decode_attention_rows`; ``decode_attention`` and
``paged_decode_attention`` hand a 4-D q to them). Each row's output is
bit-equal to the 1-query call's at that row's length.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import cuda as _cuda
from apex_tpu_torch.ops import dispatch

__all__ = ["NEG_INF", "HEAD_DIMS", "DECODE_CHUNK", "MAX_ROWS",
           "decode_chunks", "chunk_spans", "gather_pages",
           "decode_attention", "paged_decode_attention",
           "decode_attention_rows", "paged_decode_attention_rows",
           "decode_attention_plain", "paged_decode_attention_plain",
           "decode_merge", "decode_merge_plain"]

# the flash kernel's finite -inf stand-in (exp() of it is exactly 0.0 in
# fp32); shared so masked-lane math is bit-identical across versions
NEG_INF = -1.0e30

HEAD_DIMS = (64, 128)   # the head dims the kernel is written for
DECODE_CHUNK = 64       # key positions a block of the kernel takes
MAX_ROWS = 8            # query rows a slot may bring to the kernel


def decode_chunks(capacity: int) -> int:
    """The kernel's chunks along an arena row of ``capacity`` positions
    (dense: max_len; paged: pages × page_size): the grid's second dim, and
    the workspace's chunk count."""
    return max(1, -(-int(capacity) // DECODE_CHUNK))


def chunk_spans(length: int) -> list:
    """The key positions [start, end) each chunk of a row of ``length``
    live keys takes, in the order the merge adds them: fixed multiples of
    :data:`DECODE_CHUNK`, whatever arena holds the row. A row of 0 keys
    has one empty chunk (its output is 0)."""
    n = max(0, int(length))
    if n == 0:
        return [(0, 0)]
    return [(c, min(c + DECODE_CHUNK, n)) for c in range(0, n, DECODE_CHUNK)]


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
    dtype. With q [S, Q, H, hd] and lengths [S, Q] the same ops run once
    with a real query axis, row j masked to its own length; returns [S,
    Q, H, hd]."""
    multi = q.dim() == 4
    hd = q.shape[-1]
    l_dim = k.shape[-2]
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    lengths = lengths.to(q.device)
    if multi:
        qf = q.transpose(1, 2).float()                    # [S, H, Q, hd]
        lmask = lengths[:, None, :, None]
    else:
        qf = q[:, :, None, :].float()                     # [S, H, 1, hd]
        lmask = lengths[:, None, None, None]
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale  # [S,H,Q,L]
    k_pos = torch.arange(l_dim, device=q.device)[None, None, None, :]
    s = torch.where(k_pos < lmask, s, torch.full_like(s, NEG_INF))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m),
                    torch.zeros_like(s))
    l_sum = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(l_sum > 0.0, l_sum, torch.ones_like(l_sum))
    o = torch.matmul(probs, v.float()).to(q.dtype)
    if multi:
        return o.transpose(1, 2)                          # [S, Q, H, hd]
    return o[:, :, 0, :]


def paged_decode_attention_plain(q, k, v, lengths, *, scale=None,
                                 page_table):
    """Plain version over page pools: gather each slot's logical view,
    then the dense plain math — bitwise equal to the dense plain version
    whenever the mapped pages hold the same bytes. q may be [S, Q, H, hd]
    with lengths [S, Q], as for :func:`decode_attention_plain`."""
    return decode_attention_plain(q, gather_pages(k, page_table),
                                  gather_pages(v, page_table), lengths,
                                  scale=scale)


def decode_merge_plain(part, lengths, out, capacity: int):
    """Plain version of :func:`decode_merge`: ``part`` fp32 [S, H, nchunk,
    hd + 2] holds each (row, chunk)'s (m, l, acc[hd]); the rows of more
    than one live chunk get o = sum_c acc_c e^(m_c - M) / sum_c l_c
    e^(m_c - M) (M the max over the row's live chunks) in ``out``'s dtype,
    written into ``out`` [S, H, hd]; the other rows are left."""
    s_dim, h, nchunk, _ = part.shape
    n = lengths.to(part.device).long().clamp(0, capacity)
    live = -(-n // DECODE_CHUNK)                                  # [S]
    mask = (torch.arange(nchunk, device=part.device)[None, :]
            < live[:, None])[:, None, :]                      # [S, 1, C]
    # chunks past a row's length were never written: masked out first
    zero = torch.zeros((), device=part.device)
    m = torch.where(mask, part[..., 0], torch.full_like(part[..., 0],
                                                        NEG_INF))
    top = m.amax(dim=-1, keepdim=True)
    f = torch.where(mask, torch.exp(m - top), zero)
    lt = (torch.where(mask, part[..., 1], zero) * f).sum(dim=-1)  # [S, H]
    o = (torch.where(mask[..., None], part[..., 2:], zero)
         * f[..., None]).sum(dim=-2)                           # [S, H, hd]
    o = o / torch.where(lt > 0.0, lt, torch.ones_like(lt))[..., None]
    rows = live > 1
    out[rows] = o[rows].to(out.dtype)
    return out


def _check(name, q, k, v, lengths, page_table=None):
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (lengths, "lengths")):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {what} must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32")
    want = tuple(q.shape[:2]) if q.dim() == 4 else tuple(q.shape[:1])
    if tuple(lengths.shape) != want:
        raise ValueError(f"{name}: lengths must be {list(want)}, got "
                         f"{tuple(lengths.shape)}")
    if q.dim() == 4 and not 1 <= q.shape[1] <= MAX_ROWS:
        raise ValueError(f"{name}: the kernel takes 1 to {MAX_ROWS} query "
                         f"rows a slot, got {q.shape[1]}")
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
    """The chunk kernel, then (past one chunk) the merge: each launch
    counts on its own wrapper. q [S, H, hd] or [S, Q, H, hd]; the merge
    takes the Q rows of a slot as S * Q rows of a 1-query call."""
    nq = q.shape[1] if q.dim() == 4 else 1
    s_dim, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    out = torch.empty_like(q)
    if s_dim * nq * h == 0:
        return out
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    cap = l_dim if page_table is None else max_pages * page
    if cap < 1:
        raise ValueError("decode_attention: an arena of no positions")
    nchunk = decode_chunks(cap)
    part = torch.empty((s_dim * nq, h, nchunk, hd + 2),
                       dtype=torch.float32,
                       device=q.device) if nchunk > 1 else None
    err = _cuda.lib().apex_decode_attention(
        _cuda.dtype_code(q.dtype, "decode_attention"), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        page_table.data_ptr() if page_table is not None else None,
        out.data_ptr(), part.data_ptr() if part is not None else None,
        s_dim, h, hd, l_dim, page, max_pages, int(page_table is not None),
        nchunk, nq, float(scale), _cuda.stream(q.device))
    _cuda.check(err, "decode_attention")
    if part is not None:
        decode_merge(part, lengths.reshape(-1), out.view(-1, h, hd), cap)
    return out


def decode_merge(part, lengths, out, capacity: int):
    """The merge kernel: for the rows of more than one chunk, their
    chunks' partials ``part`` fp32 [S, H, nchunk, hd + 2] added in chunk
    order into ``out`` [S, H, hd] (in place, returned), as
    :func:`decode_merge_plain`."""
    if not dispatch.use_kernel(part):
        return decode_merge_plain(part, lengths, out, capacity)
    s_dim, h, nchunk, width = part.shape
    if not part.is_contiguous() or part.dtype != torch.float32 \
            or tuple(out.shape) != (s_dim, h, width - 2) \
            or not out.is_contiguous() or lengths.dtype != torch.int32:
        raise ValueError("decode_merge: part fp32 [S, H, nchunk, hd + 2], "
                         "out [S, H, hd] contiguous, lengths int32")
    err = _cuda.lib().apex_decode_merge(
        _cuda.dtype_code(out.dtype, "decode_merge"), part.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), s_dim, h, width - 2,
        int(capacity), nchunk, _cuda.stream(part.device))
    _cuda.check(err, "decode_merge")
    decode_merge.launches += 1
    return out


decode_merge.launches = 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: "float | None" = None) -> torch.Tensor:
    """Single-query attention over the dense arena. q: [S, H, hd]; k/v:
    [S, H, L, hd] (garbage past each slot's length is never read);
    lengths: i32 [S]. Returns [S, H, hd] in q's dtype. A q of [S, Q, H,
    hd] goes to :func:`decode_attention_rows`."""
    if q.dim() == 4:
        return decode_attention_rows(q, k, v, lengths, scale=scale)
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
    built. Returns [S, H, hd] in q's dtype. A q of [S, Q, H, hd] goes to
    :func:`paged_decode_attention_rows`."""
    if q.dim() == 4:
        return paged_decode_attention_rows(q, k, v, lengths, scale=scale,
                                           page_table=page_table)
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
    out = _launch(q, k, v, lengths, page_table, scale, 0, k.shape[2],
                  page_table.shape[1])
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def decode_attention_rows(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lengths: torch.Tensor, *,
                          scale: "float | None" = None) -> torch.Tensor:
    """Q query rows a slot over the dense arena (speculative scoring).
    q: [S, Q, H, hd], 1 <= Q <= :data:`MAX_ROWS`; k/v: [S, H, L, hd];
    lengths: i32 [S, Q], row j masked to its own length. A block reads
    each K/V chunk once for all the slot's rows. Returns [S, Q, H, hd]
    in q's dtype, each row bit-equal to :func:`decode_attention` at that
    row's length."""
    if not dispatch.use_kernel(q):
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    if q.dim() != 4:
        raise ValueError(f"decode_attention_rows: q must be [S, Q, H, hd], "
                         f"got {tuple(q.shape)}")
    _check("decode_attention_rows", q, k, v, lengths)
    s_dim, _, h, _ = q.shape
    if k.shape[:2] != (s_dim, h) or k.shape != v.shape:
        raise ValueError(f"decode_attention_rows: k/v {tuple(k.shape)} do "
                         f"not match q {tuple(q.shape)}")
    out = _launch(q, k, v, lengths, None, scale, k.shape[2], 1, 0)
    decode_attention_rows.launches += 1
    return out


decode_attention_rows.launches = 0


def paged_decode_attention_rows(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, lengths: torch.Tensor, *,
                                scale: "float | None" = None,
                                page_table: torch.Tensor) -> torch.Tensor:
    """Q query rows a slot over the PAGED arena: q [S, Q, H, hd]; k/v page
    pools [P_phys, H, page, hd]; lengths i32 [S, Q]; page_table i32 [S,
    P_logical], one row a slot shared by its Q rows. Returns [S, Q, H,
    hd], bitwise equal to :func:`decode_attention_rows` over the same
    bytes."""
    if not dispatch.use_kernel(q):
        return paged_decode_attention_plain(q, k, v, lengths, scale=scale,
                                            page_table=page_table)
    if q.dim() != 4:
        raise ValueError(f"paged_decode_attention_rows: q must be [S, Q, "
                         f"H, hd], got {tuple(q.shape)}")
    _check("paged_decode_attention_rows", q, k, v, lengths, page_table)
    s_dim, _, h, _ = q.shape
    if k.shape[1] != h or k.shape != v.shape \
            or page_table.shape[0] != s_dim:
        raise ValueError(
            f"paged_decode_attention_rows: k/v {tuple(k.shape)} or "
            f"page_table {tuple(page_table.shape)} do not match q "
            f"{tuple(q.shape)}")
    out = _launch(q, k, v, lengths, page_table, scale, 0, k.shape[2],
                  page_table.shape[1])
    paged_decode_attention_rows.launches += 1
    return out


paged_decode_attention_rows.launches = 0
