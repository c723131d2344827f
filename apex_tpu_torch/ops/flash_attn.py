"""Flash attention over ``[BH, S, D]``: the kernel wrappers and their plain
PyTorch versions.

Counterpart of the Pallas kernels in
``apex_tpu/contrib/multihead_attn/flash_attention.py`` (the kernels are
``ops/cuda/csrc/flash_fwd.cu``, the forward, ``ops/cuda/csrc/flash_bwd.cu``,
dq and dk/dv, and ``ops/cuda/csrc/flash_dbias.cu``, the shared-bias
gradient):

- :func:`flash_fwd` replaces ``_flash_fwd`` → ``_fwd_kernel`` (:181): the
  output and the per-row logsumexp; its plain version is
  :func:`reference_attention` with ``return_lse=True`` (:586-631);
- :func:`flash_bwd_dq` replaces ``_bwd_dq_kernel`` (:349), with the
  per-bh bias gradient dS when asked (``dbias_in_dq``, :471, :519-533),
  and :func:`flash_bwd_dkv` ``_bwd_dkv_kernel`` (:392); their plain
  version is :func:`flash_bwd_plain`, a port of ``_bwd_chunked``
  (:634-729), chunked over the keys so that it fits at full length on the
  card;
- :func:`flash_bwd_dbias` replaces ``_bwd_dbias_kernel`` (:427): the
  gradient of a bias [1, Sq, Sk] shared over bh, dS summed over bh; its
  plain version is :func:`flash_bwd_dbias_plain`.

Forms of kernel serve them, each kernel's own (:func:`kernel_form` picks
for the forward, dq, dk/dv and the shared-bias gradient):

========  =======  ===============  ===============  ===============  =====
dtype     head     forward          dq               dk/dv            dbias
          dim
========  =======  ===============  ===============  ===============  =====
bf16/f16  1-128    "tc" (64, 128)   "tc" (64, 128)   "tc" (64, 128)   "tc"
bf16/f16  129-256  "tc256" (256)    "tc256" (256)    "tc256" (256)    "tc"
bf16/f16  257-512  "tc512" (384,    "tc512" (384,    "tc512" (384,    "tc"
                   512)             512)             512)
fp32      1-128    "f32" (64, 128)  "f32" (64, 128)  "f32" (64, 128)  "f32"
fp32      129-256  "f32" (256)      "f32" (256)      "f32" (256)      "f32"
fp32      257-512  "f32_512" (384,  "f32_512" (384,  "f32_512" (384,  "f32"
                   512)             512)             512)
========  =======  ===============  ===============  ===============  =====

"tc" is the Hopper kernels above at D 64 or 128 and "tc256" the same
files' kernels at D 256 (:func:`flash_d256_fwd`, :func:`flash_d256_dq`,
:func:`flash_d256_dkv`); "tc512" is ``ops/cuda/csrc/flash_d512.cu``'s
forward and dq at D 384 and 512 (:func:`flash_d512_fwd`,
:func:`flash_d512_dq`: blocks of 64 query rows, D split over the two
consumer warpgroups) and ``ops/cuda/csrc/flash_d512_dkv.cu``'s dk/dv there
(:func:`flash_d512_dkv`: a dv and a dk kernel over blocks of 64 keys, D
split alike); the kernels run at the head dim in brackets, the
inputs zero-padded to it (the JAX package pads D to a multiple of 128
lanes; zero columns add nothing to QKᵀ and give zero output columns,
sliced off) — at 384 and 512 only to a multiple of 8, the kernels' TMA
copies filling the rest with zeros (:func:`_kernel_width`) — and the real
D's scale passed.
"f32" is ``ops/cuda/csrc/flash_f32.cu``, 3xTF32 products on the tensor
cores (:func:`flash_f32_fwd`, :func:`flash_f32_dq`, :func:`flash_f32_dkv`),
padded alike; "f32_512" is ``ops/cuda/csrc/flash_f32_d512.cu``'s forward,
dq and dk/dv in 3xTF32 at D 384 and 512 (:func:`flash_f32_d512_fwd`,
:func:`flash_f32_d512_dq`: pairs of warps over 16 query rows, D split
between the two; :func:`flash_f32_d512_dkv`: quads of warps over 16 keys,
each warp half of dk's or dv's columns), the tensors handed at their
width rounded up to a multiple of 4 (:func:`_f32x_ready`: the kernels zero
the columns past it).
The shared-bias gradient's forms are ``ops/cuda/csrc/flash_dbias.cu``'s
two kernels, both at every head dim up to 512 (D streamed through shared
memory in chunks, so no padding but to 16 bytes: :func:`flash_bwd_dbias`):
"tc" bf16/fp16 on ``wgmma``, "f32" fp32 in 3xTF32.
"simt" is the simple form of ``ops/cuda/csrc/flash_simt.cu``:
fp32 FMAs, a warp a row (:func:`flash_simt_fwd`, :func:`flash_simt_dq`,
:func:`flash_simt_dkv`, and :func:`flash_simt_dbias`, its dq kernel's dS
summed over bh), which no dtype or head dim is routed to: it stays as the
yardstick the tensor-core forms are timed against. Each of these wrappers
counts its own launches.

The backward takes ``delta = rowsum(dO·O) − dlse`` (:474-479, computed
here in plain PyTorch by :func:`flash_delta`), so a cotangent of the lse
folds into the same per-row term.

Every function takes the JAX kernels' inputs:

- ``bias`` [1|BH, Sq, Sk], a full additive score bias, shared over bh
  when its first dim is 1;
- ``kv_bias`` [1|BH, Sk], a per-key additive score bias (key-padding
  masks: 0 or -1e30), broadcast over the queries, as
  ``kv_bias[..., None, :]`` at :607 and :682; it is mask data, so no
  gradient flows to it;
- ``dropout_rate`` and ``dropout_seed``: dropout on the softmax
  probabilities with the JAX package's coordinate hash
  (:func:`dropout_bits`, :107-126), so the kernels, the plain versions and
  the JAX package drop the same elements. The softmax sum keeps every
  probability (lse is dropout-free); the kept ones are scaled by
  1 / (1 − rate) (:223-231, :338-345). The seed is an int in
  [−2³¹, 2³²), taken mod 2³² (JAX passes a signed int32).

Their bh index is b·H + h, the order of ``_split_heads``.

For tensors on the CPU each wrapper runs its plain version; for tensors on
the card it launches its kernel, and raises on a dtype other than fp32,
bf16 and fp16 or a head dim past 512. The kernels read q, k, v and dO through
their strides (the last dim contiguous, every stride a multiple of 16
bytes, the base 16-byte aligned); a view that is not so is copied once to
a contiguous tensor. The forward, dq and dk/dv copy their tiles by TMA,
which also takes no broadcast view: the wrappers describe each tensor's
map (:func:`tma_layout`: dims, byte strides, the box) and the grid's
blocks of rows (:func:`row_blocks`). The biases are cast once to
contiguous fp32. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from apex_tpu_torch.ops import cuda as _cuda
from apex_tpu_torch.ops import dispatch

__all__ = ["NEG_INF", "KERNEL_HEAD_DIMS", "DKV_HEAD_DIMS", "F32_HEAD_DIMS",
           "SIMT_MAX_HEAD_DIM", "dropout_bits",
           "drop_threshold", "reference_attention", "flash_fwd", "flash_delta",
           "flash_bwd_plain", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_dbias", "flash_bwd_dbias_plain", "flash_simt_dbias",
           "flash_d256_fwd",
           "flash_d256_dq", "flash_d256_dkv", "flash_d512_fwd",
           "flash_d512_dq", "flash_d512_dkv", "flash_simt_fwd",
           "flash_simt_dq", "flash_simt_dkv", "flash_f32_fwd", "flash_f32_dq",
           "flash_f32_dkv", "flash_f32_d512_fwd", "flash_f32_d512_dq",
           "flash_f32_d512_dkv",
           "kernel_form", "tensor_cores", "padded_head_dim",
           "BLOCK_ROWS", "TMA_BOX", "DQ_D256_KEYS", "DKV_D256_KEYS",
           "D512_ROWS", "FWD_D512_KEYS", "DQ_D512_KEYS", "tma_layout",
           "row_blocks"]

# finite -inf stand-in: exp(NEG_INF - m) is exactly 0.0 in fp32, so a fully
# masked row yields zeros instead of NaN
NEG_INF = -1.0e30
# the head dims the bf16/fp16 tensor-core kernels of the forward, dq and
# dk/dv are written for (a smaller D is padded up to one of them): the
# forward and dq take all five, dk/dv the first three; the fp32 ones'
# (3xTF32: the forward, dq and dk/dv); and the widest any form takes (the
# shared-bias gradient's kernels take every D up to it)
KERNEL_HEAD_DIMS = (64, 128, 256, 384, 512)
DKV_HEAD_DIMS = (64, 128, 256)
F32_HEAD_DIMS = (64, 128, 256)
SIMT_MAX_HEAD_DIM = 512
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

# the Hopper kernels' tiling (csrc/flash_fwd.cu, csrc/flash_bwd.cu): a
# block owns BLOCK_ROWS rows (queries in the forward and dq, keys in dk/dv)
# and TMA copies the tensors in boxes of TMA_BOX elements, innermost first:
# 64 of the head dim (128 bytes, the span of the tiles' swizzle), 64 rows,
# one bh (a row of D 256 is four boxes across); dq at D 256 stages
# DQ_D256_KEYS keys a tile, its boxes as many rows, and a block of dk/dv
# at D 256 owns DKV_D256_KEYS keys. At D 384 and 512 a block of the
# forward and dq owns D512_ROWS query rows and a block of dk/dv as many
# keys; the forward stages FWD_D512_KEYS keys a tile, dq DQ_D512_KEYS[D]
# keys and dk/dv's dk kernel as many queries, the boxes of every map as
# many rows (the forward's: FWD_D512_KEYS)
BLOCK_ROWS = 128
TMA_BOX = (64, 64, 1)
DQ_D256_KEYS = 32
DKV_D256_KEYS = 64
D512_ROWS = 64
FWD_D512_KEYS = 32
DQ_D512_KEYS = {384: 32, 512: 16}

_M32 = 0xFFFFFFFF


def _causal_mask(sq: int, sk: int, q_start: int, k_start: int, device):
    q_pos = q_start + torch.arange(sq, device=device)[:, None]
    k_pos = k_start + torch.arange(sk, device=device)[None, :]
    return q_pos >= k_pos


def _mul32(x, c: int):
    """``x · c mod 2³²`` for int64 ``x`` in [0, 2³²): in two 16-bit halves
    of ``c``, so no product passes 2⁴⁹."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def dropout_bits(seed, bh, q_pos, k_pos):
    """The JAX package's uint32 coordinate hash (flash_attention.py:107-126)
    of broadcastable ints or int tensors, as int64 in [0, 2³²): uint32
    arithmetic done in int64, masked after every multiply and before every
    shift (a negative int64 would shift in ones)."""
    dev = next((t.device for t in (q_pos, k_pos, bh, seed)
                if isinstance(t, torch.Tensor)), None)

    def u32(t):
        return torch.as_tensor(t, dtype=torch.int64, device=dev) & _M32

    x = (_mul32(u32(q_pos), 0x9E3779B1) + _mul32(u32(k_pos), 0x85EBCA77)
         + _mul32(u32(bh), 0xC2B2AE3D) + _mul32(u32(seed), 0x27D4EB2F)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def drop_threshold(rate: float) -> int:
    """An element is kept when its hash is at least this
    (``_drop_threshold``, :129-130)."""
    return min(int(rate * 4294967296.0), 4294967295)


def _dropout(rate: float, seed) -> tuple:
    """(seed mod 2³², threshold, 1 / (1 − rate) or 0 without dropout)."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"dropout_seed must be in [-2**31, 2**32), got "
                         f"{seed}")
    if rate == 0.0:
        return 0, 0, 0.0
    return seed & _M32, drop_threshold(rate), 1.0 / (1.0 - rate)


def _keep(bh_idx, q_pos, k_pos, rate: float, seed):
    """The keep-mask of dropout at ``rate`` for broadcastable coordinates."""
    return dropout_bits(seed, bh_idx, q_pos, k_pos) >= drop_threshold(rate)


def reference_attention(q, k, v, bias=None, *, kv_bias=None,
                        causal: bool = False, scale=None,
                        q_start: int = 0, k_start: int = 0,
                        return_lse: bool = False,
                        dropout_rate: float = 0.0, dropout_seed=0):
    """Unfused attention: q [..., Sq, d], k/v [..., Sk, d]; ``bias`` an
    additive score bias broadcastable to [..., Sq, Sk], ``kv_bias`` a
    per-key one [..., Sk] broadcast over the queries. With ``causal``,
    query row i (absolute position ``q_start + i``) sees keys at absolute
    positions ``k_start + j <= q_start + i``. ``dropout_rate`` drops the
    normalized probabilities with the kernels' hash, the leading dims
    flattened to the bh index. Returns [..., Sq, d] in q's dtype and, with
    ``return_lse``, the fp32 per-row logsumexp [..., Sq] (``NEG_INF`` for a
    row that sees nothing; dropout-free). Op for op the JAX package's
    ``reference_attention`` (flash_attention.py:586-631): fp32 scores, the
    biases, finite ``NEG_INF`` masking, max, exp under where, sum, guarded
    divide, dropout."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    _dropout(dropout_rate, dropout_seed)              # validates both
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
    probs = p / safe
    if dropout_rate > 0.0:
        lead = s.shape[:-2]
        bh_idx = torch.arange(math.prod(lead), device=q.device).reshape(
            *lead, 1, 1)
        keep = _keep(bh_idx,
                     q_start + torch.arange(sq, device=q.device)[:, None],
                     k_start + torch.arange(sk, device=q.device)[None, :],
                     dropout_rate, dropout_seed)
        probs = torch.where(keep, probs, torch.zeros_like(probs)) * (
            1.0 / (1.0 - dropout_rate))
    o = torch.matmul(probs, v.float()).to(q.dtype)
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
                    bias=None, dropout_rate: float = 0.0, dropout_seed=0,
                    return_ds: bool = False, block_k: int = 128):
    """Plain version of the backward kernels, ``_bwd_chunked``'s recurrence
    (flash_attention.py:634-729) over key chunks of ``block_k``: p is
    recomputed from lse (0 where the biased, masked score is below
    ``NEG_INF / 2``, so a row whose every key is masked gets none), with
    dropout ``pd = keep·p/(1−rate)`` for dv and ``dP' = keep·dP/(1−rate)``,
    ``dS = p·(dP' − delta)``, dq and dk from ``dS·scale``. Returns (dq, dk,
    dv) in q's, k's and v's dtypes and, with ``return_ds``, dS fp32 [BH,
    Sq, Sk] (the gradient of a per-bh bias)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    dev = q.device
    qf, dof = q.float(), do.float()
    lse_c, dlt_c = lse.float()[..., None], delta.float()[..., None]
    dq = torch.zeros((bh, sq, d), dtype=torch.float32, device=dev)
    dk = torch.empty((bh, sk, d), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    ds_all = torch.empty((bh, sq, sk), dtype=torch.float32, device=dev) \
        if return_ds else None
    _dropout(dropout_rate, dropout_seed)
    if dropout_rate > 0.0:
        inv = 1.0 / (1.0 - dropout_rate)
        bh_idx = torch.arange(bh, device=dev)[:, None, None]
        q_pos = q_start + torch.arange(sq, device=dev)[None, :, None]
    for j0 in range(0, sk, block_k):
        j1 = min(j0 + block_k, sk)
        kj, vj = k[:, j0:j1].float(), v[:, j0:j1].float()
        s = torch.matmul(qf, kj.transpose(1, 2)) * scale
        if bias is not None:
            s = s + bias[:, :, j0:j1].float()
        if kv_bias is not None:
            s = s + kv_bias[:, None, j0:j1].float()
        if causal:
            s = torch.where(_causal_mask(sq, j1 - j0, q_start, k_start + j0,
                                         dev), s,
                            torch.full_like(s, NEG_INF))
        p = torch.where(s > NEG_INF * 0.5, torch.exp(s - lse_c),
                        torch.zeros_like(s))
        dp = torch.matmul(dof, vj.transpose(1, 2))
        pd = p
        if dropout_rate > 0.0:
            k_pos = k_start + torch.arange(j0, j1, device=dev)[None, None, :]
            keep = _keep(bh_idx, q_pos, k_pos, dropout_rate, dropout_seed)
            pd = torch.where(keep, p, torch.zeros_like(p)) * inv
            dp = torch.where(keep, dp, torch.zeros_like(dp)) * inv
        dv[:, j0:j1] = torch.matmul(pd.transpose(1, 2), dof)
        ds = p * (dp - dlt_c)
        if return_ds:
            ds_all[:, :, j0:j1] = ds
        ds = ds * scale
        dq += torch.matmul(ds, kj)
        dk[:, j0:j1] = torch.matmul(ds.transpose(1, 2), qf)
    out = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    return out + (ds_all,) if return_ds else out


def flash_bwd_dbias_plain(q, k, v, do, lse, delta, *, causal: bool,
                          scale: float, bias, q_start: int = 0,
                          k_start: int = 0, kv_bias=None,
                          dropout_rate: float = 0.0, dropout_seed=0):
    """Plain version of :func:`flash_bwd_dbias`: dS of
    :func:`flash_bwd_plain` summed over bh, fp32 [1, Sq, Sk]."""
    ds = flash_bwd_plain(q, k, v, do, lse, delta, causal=causal,
                         scale=scale, q_start=q_start, k_start=k_start,
                         kv_bias=kv_bias, bias=bias,
                         dropout_rate=dropout_rate,
                         dropout_seed=dropout_seed, return_ds=True)[3]
    return ds.sum(dim=0, keepdim=True)


def _check(what: str, *ts):
    """The kernels' contract: [BH, S, D] tensors of one float dtype (fp32,
    bf16, fp16) on one card, D up to :data:`SIMT_MAX_HEAD_DIM`, S >= 1."""
    dev, d = ts[0].device, ts[0].shape[-1]
    for t in ts:
        if t.dim() != 3 or t.shape[-1] != d or t.shape[0] != ts[0].shape[0]:
            raise ValueError(f"{what}: expected [BH, S, D] tensors of one "
                             f"BH and D, got {[tuple(x.shape) for x in ts]}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors must share one device")
        if t.dtype not in _FLOATS or t.dtype != ts[0].dtype:
            raise TypeError(f"{what}: the kernels take float32, bfloat16 or "
                            f"float16 tensors of one dtype, got "
                            f"{[x.dtype for x in ts]}")
    if not 1 <= d <= SIMT_MAX_HEAD_DIM:
        raise ValueError(f"{what}: the kernels take a head dim of 1 to "
                         f"{SIMT_MAX_HEAD_DIM}, got {d}")
    if ts[0].shape[0] == 0 or ts[0].shape[1] == 0 or ts[1].shape[1] == 0:
        raise ValueError(f"{what}: needs 1 <= S and 1 <= BH")


def tensor_cores(q: torch.Tensor) -> bool:
    """Whether the 16-bit Hopper forward, dq and dk/dv take q's dtype and
    head dim in their first form ("tc"): bf16 or fp16, D <= 128, padded
    up to 64 or 128 (past 128 their D-256 and D-384/512 forms do:
    :func:`kernel_form`). The shared-bias gradient does not ask: its
    kernels take every D up to 512 in either dtype family."""
    return q.dtype in (torch.bfloat16, torch.float16) \
        and q.shape[-1] <= KERNEL_HEAD_DIMS[1]


def padded_head_dim(d: int) -> int:
    """The head dim the tensor-core kernels run a D <= 512 at: 64, 128,
    256, 384 or 512 (the JAX package's padding to a multiple of 128 lanes
    above 128)."""
    return next(k for k in KERNEL_HEAD_DIMS if d <= k)


def _kernel_width(d: int) -> int:
    """The width the tensor-core kernels are handed a D at: padded to
    :func:`padded_head_dim` up to 256; past it only to a multiple of 8 (16
    bytes, the unit of TMA's strides), the D-384 and D-512 kernels' maps
    filling the columns up to 384 or 512 with zeros as they copy."""
    dp = padded_head_dim(d)
    return dp if dp <= KERNEL_HEAD_DIMS[2] else -(-d // 8) * 8


def _pad_d(t: torch.Tensor, dp: int) -> torch.Tensor:
    """t with its last dim zero-padded to dp (t itself when it is dp)."""
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


def _unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` when the kernel can read it through its strides in 16-byte
    pieces (the last dim contiguous, every other stride a multiple of 16
    bytes, the base 16-byte aligned), else one contiguous copy (a fresh
    one: a contiguous view at a misaligned base is its own
    ``contiguous()``)."""
    unit = 16 // t.element_size()
    if t.stride(-1) == 1 and t.stride(0) % unit == 0 \
            and t.stride(1) % unit == 0 and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _tma_readable(t: torch.Tensor) -> torch.Tensor:
    """:func:`_readable` for the TMA copies of the forward, dq and dk/dv,
    which also copy a broadcast view (a stride of 0 over more than one
    element)."""
    t = _readable(t)
    if any(t.stride(i) == 0 and t.shape[i] > 1 for i in (0, 1)):
        return t.contiguous()
    return t


def tma_layout(t: torch.Tensor, box_rows: int = TMA_BOX[1]) -> tuple:
    """The tensor map the Hopper kernels copy a [BH, S, D] 16-bit tensor
    by: its dims innermost first (D, S, BH), its row and bh strides in
    bytes, and the box (:data:`TMA_BOX`, or ``box_rows`` rows: dq at D
    256's :data:`DQ_D256_KEYS`, the D-384 and D-512 kernels' key tiles). A dim of size 1 takes the stride of the
    tensor's packed layout (its own is arbitrary and never used)."""
    bh, s, d = t.shape
    es = t.element_size()
    row = t.stride(1) if s > 1 else d
    bhs = t.stride(0) if bh > 1 else s * row
    return (d, s, bh, row * es, bhs * es, TMA_BOX[0], box_rows, TMA_BOX[2])


def row_blocks(rows: int, block: int = BLOCK_ROWS) -> int:
    """The grid's blocks along the rows a block owns (``rows``: Sq for the
    forward and dq, Sk for dk/dv), ``block`` rows a block
    (:data:`BLOCK_ROWS`; dk/dv at D 256 :data:`DKV_D256_KEYS`; the forward
    and dq at D 384 and 512 :data:`D512_ROWS`)."""
    return -(-rows // block)


def _tma_maps(*ts, box_rows: int = TMA_BOX[1]):
    """The tensor maps of q, k, v (and dO), one C array of 8 ints a
    tensor."""
    vals = [x for t in ts for x in tma_layout(t, box_rows)]
    return (ctypes.c_longlong * len(vals))(*vals)


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
    return kvb.data_ptr(), (sk if kvb.shape[0] != 1 else 0), kvb


def _full_bias(what: str, bias, bh: int, sq: int, sk: int, device):
    """(pointer, bh stride, tensor) of a bias [1|BH, Sq, Sk] as contiguous
    fp32; (None, 0, None) without one."""
    if bias is None:
        return None, 0, None
    if bias.dim() != 3 or bias.shape[0] not in (1, bh) \
            or tuple(bias.shape[1:]) != (sq, sk) or bias.device != device:
        raise ValueError(f"{what}: bias must be [1 or {bh}, {sq}, {sk}] on "
                         f"{device}, got {tuple(bias.shape)}")
    b = bias.float().contiguous()
    return b.data_ptr(), (sq * sk if b.shape[0] != 1 else 0), b


def _row_stats(what: str, t: torch.Tensor, bh: int, sq: int, device):
    if t.dtype != torch.float32 or tuple(t.shape) != (bh, sq) \
            or t.device != device:
        raise ValueError(f"{what}: must be fp32 [{bh}, {sq}] on {device}")
    return t.contiguous()


def _tail(what, q, k, kv_bias, bias, dropout_rate, dropout_seed, causal,
          scale, q_start, k_start):
    """The C entry points' common trailing arguments, and the fp32 bias
    tensors they point into (kept alive by the caller until the launch)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    kvb = _kv_bias(what, kv_bias, bh, sk, q.device)
    fb = _full_bias(what, bias, bh, sq, sk, q.device)
    seed, thresh, inv = _dropout(dropout_rate, dropout_seed)
    args = (kvb[0], kvb[1], fb[0], fb[1], seed, thresh, inv, bh, sq, sk, d,
            int(q_start), int(k_start), int(bool(causal)), float(scale),
            _cuda.stream(q.device))
    return args, (kvb[2], fb[2])


def _strides(*ts):
    return tuple(x for t in ts for x in (t.stride(0), t.stride(1)))


def flash_fwd(q, k, v, *, causal: bool = False, scale=None,
              q_start: int = 0, k_start: int = 0, kv_bias=None, bias=None,
              dropout_rate: float = 0.0, dropout_seed=0):
    """(o [BH, Sq, D] in q's dtype, lse fp32 [BH, Sq]) of softmax attention
    over q [BH, Sq, D], k/v [BH, Sk, D], with the optional ``kv_bias``
    [1|BH, Sk], ``bias`` [1|BH, Sq, Sk] and dropout. On the card, as
    :func:`kernel_form` picks: the tensor-core kernel at D <= 128 (counted
    here), :func:`flash_d256_fwd`, :func:`flash_d512_fwd`,
    :func:`flash_f32_fwd` or :func:`flash_f32_d512_fwd`."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    cfg = dict(causal=causal, scale=scale, q_start=q_start, k_start=k_start,
               kv_bias=kv_bias, bias=bias, dropout_rate=dropout_rate,
               dropout_seed=dropout_seed)
    if not dispatch.use_kernel(q):
        return _fwd_plain(q, k, v, **cfg)
    _check("flash_fwd", q, k, v)
    form = kernel_form(q, "fwd")
    if form != "tc":
        return {"tc256": flash_d256_fwd, "tc512": flash_d512_fwd,
                "f32": flash_f32_fwd,
                "f32_512": flash_f32_d512_fwd}[form](q, k, v, **cfg)
    return _tc_fwd(flash_fwd, q, k, v, **cfg)


flash_fwd.launches = 0


def _tc_fwd(wrapper, q, k, v, *, causal, scale, q_start, k_start, kv_bias,
            bias, dropout_rate, dropout_seed):
    """The 16-bit tensor-core forward (``flash_fwd.cu``; at D 384 and 512
    ``flash_d512.cu``) at q's head dim padded to :func:`_kernel_width`;
    ``wrapper`` counts the launch."""
    what = wrapper.__name__
    d = q.shape[-1]
    dw = _kernel_width(d)
    q, k, v = (_tma_readable(_pad_d(t, dw)) for t in (q, k, v))
    bh, sq, _ = q.shape
    tail, _keep_alive = _tail(what, q, k, kv_bias, bias, dropout_rate,
                              dropout_seed, causal, scale, q_start, k_start)
    o = torch.empty((bh, sq, dw), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if dw > KERNEL_HEAD_DIMS[2]:
        entry, box, block = "apex_flash_d512_fwd", FWD_D512_KEYS, D512_ROWS
    else:
        entry, box, block = "apex_flash_fwd", TMA_BOX[1], BLOCK_ROWS
    err = getattr(_cuda.lib(), entry)(
        _cuda.dtype_code(q.dtype, what), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _tma_maps(q, k, v, box_rows=box), row_blocks(sq, block), *tail)
    _cuda.check(err, what)
    wrapper.launches += 1
    return _unpad(o, d), lse


def _wide_ready(what: str, form: str, *ts) -> None:
    """The contract of the kernels of ``form``: "tc256" (the D-256
    forward, dq and dk/dv alike) bf16 or fp16 at a head dim of 129 to 256
    (padded to 256); "tc512" (the D-384 and D-512 forward and dq) at 257 to
    512 (run at 384 or 512)."""
    _check(what, *ts)
    q = ts[0]
    if kernel_form(q, "fwd") != form:
        lo, hi = {"tc256": (KERNEL_HEAD_DIMS[1], KERNEL_HEAD_DIMS[2]),
                  "tc512": (KERNEL_HEAD_DIMS[2], KERNEL_HEAD_DIMS[4])}[form]
        raise ValueError(f"{what}: takes bf16 or fp16 at a head dim of "
                         f"{lo + 1} to {hi}, got {q.dtype} at "
                         f"{q.shape[-1]}")


def flash_d256_fwd(q, k, v, *, causal: bool = False, scale=None,
                   q_start: int = 0, k_start: int = 0, kv_bias=None,
                   bias=None, dropout_rate: float = 0.0, dropout_seed=0):
    """:func:`flash_fwd` on the tensor cores at D 256 (``flash_fwd.cu``'s
    64-key form): bf16 or fp16 at a head dim of 129 to 256, padded to 256
    (the real D's scale passed)."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    cfg = dict(causal=causal, scale=scale, q_start=q_start, k_start=k_start,
               kv_bias=kv_bias, bias=bias, dropout_rate=dropout_rate,
               dropout_seed=dropout_seed)
    if not dispatch.use_kernel(q):
        return _fwd_plain(q, k, v, **cfg)
    _wide_ready("flash_d256_fwd", "tc256", q, k, v)
    return _tc_fwd(flash_d256_fwd, q, k, v, **cfg)


flash_d256_fwd.launches = 0


def flash_d512_fwd(q, k, v, *, causal: bool = False, scale=None,
                   q_start: int = 0, k_start: int = 0, kv_bias=None,
                   bias=None, dropout_rate: float = 0.0, dropout_seed=0):
    """:func:`flash_fwd` on the tensor cores at D 384 and 512
    (``flash_d512.cu``: blocks of 64 query rows, each consumer warpgroup
    holding half of O's columns, partial scores traded): bf16 or fp16 at a
    head dim of 257 to 512, run at 384 or 512 (the inputs padded only to a
    multiple of 8, :func:`_kernel_width`; the real D's scale passed)."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    cfg = dict(causal=causal, scale=scale, q_start=q_start, k_start=k_start,
               kv_bias=kv_bias, bias=bias, dropout_rate=dropout_rate,
               dropout_seed=dropout_seed)
    if not dispatch.use_kernel(q):
        return _fwd_plain(q, k, v, **cfg)
    _wide_ready("flash_d512_fwd", "tc512", q, k, v)
    return _tc_fwd(flash_d512_fwd, q, k, v, **cfg)


flash_d512_fwd.launches = 0


def _fwd_plain(q, k, v, *, causal, scale, q_start, k_start, kv_bias, bias,
               dropout_rate, dropout_seed):
    return reference_attention(q, k, v, bias, kv_bias=kv_bias,
                               causal=causal, scale=scale, q_start=q_start,
                               k_start=k_start, return_lse=True,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)


def _simt_strides(*ts):
    """(tensors readable by the simple form: the last dim contiguous),
    and their bh and row strides in elements."""
    ts = tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)
    return ts, _strides(*ts)


def flash_simt_fwd(q, k, v, *, causal: bool = False, scale=None,
                   q_start: int = 0, k_start: int = 0, kv_bias=None,
                   bias=None, dropout_rate: float = 0.0, dropout_seed=0):
    """:func:`flash_fwd` by the simple form (``flash_simt.cu``): any of
    fp32, bf16, fp16 and a head dim up to 512 (:func:`flash_fwd` sends it
    nothing: every dtype and head dim has a tensor-core form)."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if not dispatch.use_kernel(q):
        return _fwd_plain(q, k, v, causal=causal, scale=scale,
                          q_start=q_start, k_start=k_start, kv_bias=kv_bias,
                          bias=bias, dropout_rate=dropout_rate,
                          dropout_seed=dropout_seed)
    _check("flash_simt_fwd", q, k, v)
    (q, k, v), strides = _simt_strides(q, k, v)
    bh, sq, d = q.shape
    tail, _keep_alive = _tail("flash_simt_fwd", q, k, kv_bias, bias,
                              dropout_rate, dropout_seed, causal, scale,
                              q_start, k_start)
    o = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    err = _cuda.lib().apex_flash_simt_fwd(
        _cuda.dtype_code(q.dtype, "flash_simt_fwd"), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), *strides,
        *tail)
    _cuda.check(err, "flash_simt_fwd")
    flash_simt_fwd.launches += 1
    return o, lse


flash_simt_fwd.launches = 0


def _f32_ready(what: str, *ts):
    """q, k, v (and dO) for the fp32 tensor-core kernels: checked, padded
    to :func:`padded_head_dim` and readable by their 16-byte copies."""
    _check(what, *ts)
    if kernel_form(ts[0]) != "f32":
        raise ValueError(f"{what}: takes fp32 at a head dim up to "
                         f"{F32_HEAD_DIMS[-1]}, got {ts[0].dtype} at "
                         f"{ts[0].shape[-1]}")
    dp = padded_head_dim(ts[0].shape[-1])
    return tuple(_readable(_pad_d(t, dp)) for t in ts)


def flash_f32_fwd(q, k, v, *, causal: bool = False, scale=None,
                  q_start: int = 0, k_start: int = 0, kv_bias=None,
                  bias=None, dropout_rate: float = 0.0, dropout_seed=0):
    """:func:`flash_fwd` in fp32 on the tensor cores in 3xTF32
    (``flash_f32.cu``): fp32 at a head dim up to 256, padded to 64, 128 or
    256 (the real D's scale passed)."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if not dispatch.use_kernel(q):
        return _fwd_plain(q, k, v, causal=causal, scale=scale,
                          q_start=q_start, k_start=k_start, kv_bias=kv_bias,
                          bias=bias, dropout_rate=dropout_rate,
                          dropout_seed=dropout_seed)
    d = q.shape[-1]
    q, k, v = _f32_ready("flash_f32_fwd", q, k, v)
    bh, sq, dp = q.shape
    tail, _keep_alive = _tail("flash_f32_fwd", q, k, kv_bias, bias,
                              dropout_rate, dropout_seed, causal, scale,
                              q_start, k_start)
    o = torch.empty((bh, sq, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    err = _cuda.lib().apex_flash_f32_fwd(
        _cuda.dtype_code(q.dtype, "flash_f32_fwd"), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_strides(q, k, v), *tail)
    _cuda.check(err, "flash_f32_fwd")
    flash_f32_fwd.launches += 1
    return _unpad(o, d), lse


flash_f32_fwd.launches = 0


def _f32x_ready(what: str, *ts):
    """q, k, v (and dO) for the fp32 forward and dq at D 257-512
    (``flash_f32_d512.cu``): checked, a head dim that is not a multiple of
    4 zero-padded to the next one, and readable by their 16-byte copies
    (:func:`_readable`). The kernels zero the columns from there to 384 or
    512 themselves."""
    _check(what, *ts)
    q = ts[0]
    if kernel_form(q, "fwd") != "f32_512":
        raise ValueError(f"{what}: takes fp32 at a head dim of "
                         f"{KERNEL_HEAD_DIMS[2] + 1} to {KERNEL_HEAD_DIMS[4]}"
                         f", got {q.dtype} at {q.shape[-1]}")
    dw = -(-q.shape[-1] // 4) * 4
    return tuple(_readable(_pad_d(t, dw)) for t in ts)


def flash_f32_d512_fwd(q, k, v, *, causal: bool = False, scale=None,
                       q_start: int = 0, k_start: int = 0, kv_bias=None,
                       bias=None, dropout_rate: float = 0.0,
                       dropout_seed=0):
    """:func:`flash_fwd` in fp32 on the tensor cores in 3xTF32 at D 384
    and 512 (``flash_f32_d512.cu``: pairs of warps over 16 query rows, each
    warp holding half of O's columns, the partial scores traded): fp32 at a
    head dim of 257 to 512, handed at a multiple of 4 (:func:`_f32x_ready`;
    the real D's scale passed)."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if not dispatch.use_kernel(q):
        return _fwd_plain(q, k, v, causal=causal, scale=scale,
                          q_start=q_start, k_start=k_start, kv_bias=kv_bias,
                          bias=bias, dropout_rate=dropout_rate,
                          dropout_seed=dropout_seed)
    what = "flash_f32_d512_fwd"
    d = q.shape[-1]
    q, k, v = _f32x_ready(what, q, k, v)
    bh, sq, dw = q.shape
    tail, _keep_alive = _tail(what, q, k, kv_bias, bias, dropout_rate,
                              dropout_seed, causal, scale, q_start, k_start)
    o = torch.empty((bh, sq, dw), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    err = _cuda.lib().apex_flash_f32_d512_fwd(
        _cuda.dtype_code(q.dtype, what), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), *_strides(q, k, v),
        *tail)
    _cuda.check(err, what)
    flash_f32_d512_fwd.launches += 1
    return _unpad(o, d), lse


flash_f32_d512_fwd.launches = 0


_KERNELS = ("fwd", "dq", "dkv", "dbias")


def kernel_form(q: torch.Tensor, kernel: str = "fwd") -> str:
    """The form that takes ``kernel`` ("fwd", "dq", "dkv" or "dbias") of
    q's dtype and head dim (the module's table): "tc", the bf16/fp16
    tensor-core kernels at D <= 128; "tc256", the same at D 129-256
    (padded to 256); "tc512", the bf16/fp16 kernels at D 257-512 (run at
    384 or 512); "f32", the fp32 ones (3xTF32 on the tensor cores,
    ``flash_f32.cu``) at D <= 256; "f32_512", the fp32 ones at D 257-512
    (3xTF32 at 384 or 512, ``flash_f32_d512.cu``). The shared-bias
    gradient ("dbias") takes "tc" (bf16/fp16) or "f32" (fp32) at every D
    up to 512: ``flash_dbias.cu``'s kernels. Every kernel of every dtype
    and head dim up to 512 has a tensor-core form; the simple form
    ("simt") is returned for none. Past 512 (which :func:`_check` refuses)
    the answer is "simt"."""
    if kernel not in _KERNELS:
        raise ValueError(f"kernel_form: kernel must be one of {_KERNELS}, "
                         f"got {kernel!r}")
    d = q.shape[-1]
    half = q.dtype in (torch.bfloat16, torch.float16)
    if kernel == "dbias" and d <= KERNEL_HEAD_DIMS[4]:
        if half:
            return "tc"
        if q.dtype == torch.float32:
            return "f32"
    if kernel == "dbias":
        return "simt"
    if tensor_cores(q):
        return "tc"
    if half and d <= KERNEL_HEAD_DIMS[2]:
        return "tc256"
    if half and d <= KERNEL_HEAD_DIMS[4]:
        return "tc512"
    if q.dtype == torch.float32 and d <= F32_HEAD_DIMS[-1]:
        return "f32"
    if q.dtype == torch.float32 and d <= KERNEL_HEAD_DIMS[4]:
        return "f32_512"
    return "simt"


def _bwd_args(what, q, k, v, do, lse, delta, form="simt"):
    """The checked backward inputs of the kernels of ``form`` (as
    :func:`kernel_form` names them): q, k, v, dO padded to
    :func:`_kernel_width` and readable by TMA ("tc", "tc256", "tc512") or
    by 16-byte copies ("f32", :func:`_f32_ready`; "f32_512",
    :func:`_f32x_ready`), or with their last dim contiguous ("simt"); lse
    and delta fp32 [BH, Sq]."""
    if form == "f32":
        q, k, v, do = _f32_ready(what, q, k, v, do)
    elif form == "f32_512":
        q, k, v, do = _f32x_ready(what, q, k, v, do)
    else:
        _check(what, q, k, v, do)
    if form == "simt":
        q, k, v, do = _simt_strides(q, k, v, do)[0]
    elif form in ("tc", "tc256", "tc512"):
        dw = _kernel_width(q.shape[-1])
        q, k, v, do = (_tma_readable(_pad_d(t, dw)) for t in (q, k, v, do))
    bh, sq, _ = q.shape
    lse = _row_stats(f"{what} lse", lse, bh, sq, q.device)
    delta = _row_stats(f"{what} delta", delta, bh, sq, q.device)
    return q, k, v, do, lse, delta


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                 q_start: int = 0, k_start: int = 0, kv_bias=None,
                 bias=None, dropout_rate: float = 0.0, dropout_seed=0,
                 return_ds: bool = False):
    """dq [BH, Sq, D] in q's dtype from the forward's lse and
    :func:`flash_delta`; with ``return_ds`` (a ``bias`` given) also dS fp32
    [BH, Sq, Sk], the gradient of a per-bh bias. On the card, as
    :func:`kernel_form` picks: the tensor-core kernel at D <= 128 (counted
    here), :func:`flash_d256_dq`, :func:`flash_d512_dq`,
    :func:`flash_f32_dq` or :func:`flash_f32_d512_dq`."""
    kw = dict(causal=causal, scale=scale, q_start=q_start, k_start=k_start,
              kv_bias=kv_bias, bias=bias, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    if return_ds and bias is None:
        raise ValueError("flash_bwd_dq: return_ds needs the bias whose "
                         "gradient it is")
    if not dispatch.use_kernel(q):
        out = flash_bwd_plain(q, k, v, do, lse, delta, return_ds=return_ds,
                              **kw)
        return (out[0], out[3]) if return_ds else out[0]
    _check("flash_bwd_dq", q, k, v, do)
    form = kernel_form(q, "dq")
    if form != "tc":
        return {"tc256": flash_d256_dq, "tc512": flash_d512_dq,
                "f32": flash_f32_dq, "f32_512": flash_f32_d512_dq}[form](
            q, k, v, do, lse, delta, return_ds=return_ds, **kw)
    return _tc_dq(flash_bwd_dq, "tc", q, k, v, do, lse, delta,
                  return_ds=return_ds, **kw)


flash_bwd_dq.launches = 0


def _tc_dq(wrapper, form, q, k, v, do, lse, delta, *, return_ds, **kw):
    """dq (and dS) by the 16-bit tensor-core kernel (``flash_bwd.cu``; at
    D 384 and 512 ``flash_d512.cu``) at q's head dim padded to
    :func:`_kernel_width` (``form`` "tc", "tc256" or "tc512"); ``wrapper``
    counts the launch."""
    what = wrapper.__name__
    d = q.shape[-1]
    q, k, v, do, lse, delta = _bwd_args(what, q, k, v, do, lse, delta, form)
    tail, _keep_alive = _tail(what, q, k, kw["kv_bias"], kw["bias"],
                              kw["dropout_rate"], kw["dropout_seed"],
                              kw["causal"], kw["scale"], kw["q_start"],
                              kw["k_start"])
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ds = torch.empty((q.shape[0], q.shape[1], k.shape[1]),
                     dtype=torch.float32, device=q.device) \
        if return_ds else None
    dp = padded_head_dim(q.shape[-1])
    if dp > KERNEL_HEAD_DIMS[2]:
        entry, box, block = "apex_flash_d512_dq", DQ_D512_KEYS[dp], D512_ROWS
    else:
        entry, block = "apex_flash_bwd_dq", BLOCK_ROWS
        box = DQ_D256_KEYS if dp == 256 else TMA_BOX[1]
    err = getattr(_cuda.lib(), entry)(
        _cuda.dtype_code(q.dtype, what), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), None if ds is None else ds.data_ptr(),
        _tma_maps(q, k, v, do, box_rows=box), row_blocks(q.shape[1], block),
        *tail)
    _cuda.check(err, what)
    wrapper.launches += 1
    dq = _unpad(dq, d)
    return (dq, ds) if return_ds else dq


def flash_d256_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                  q_start: int = 0, k_start: int = 0, kv_bias=None,
                  bias=None, dropout_rate: float = 0.0, dropout_seed=0,
                  return_ds: bool = False):
    """:func:`flash_bwd_dq` on the tensor cores at D 256 (``flash_bwd.cu``'s
    32-key form): bf16 or fp16 at a head dim of 129 to 256, padded to 256
    (the real D's scale passed)."""
    kw = dict(causal=causal, scale=scale, q_start=q_start, k_start=k_start,
              kv_bias=kv_bias, bias=bias, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    if return_ds and bias is None:
        raise ValueError("flash_d256_dq: return_ds needs the bias whose "
                         "gradient it is")
    if not dispatch.use_kernel(q):
        out = flash_bwd_plain(q, k, v, do, lse, delta, return_ds=return_ds,
                              **kw)
        return (out[0], out[3]) if return_ds else out[0]
    _wide_ready("flash_d256_dq", "tc256", q, k, v, do)
    return _tc_dq(flash_d256_dq, "tc256", q, k, v, do, lse, delta,
                  return_ds=return_ds, **kw)


flash_d256_dq.launches = 0


def flash_d512_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                  q_start: int = 0, k_start: int = 0, kv_bias=None,
                  bias=None, dropout_rate: float = 0.0, dropout_seed=0,
                  return_ds: bool = False):
    """:func:`flash_bwd_dq` on the tensor cores at D 384 and 512
    (``flash_d512.cu``: blocks of 64 query rows, one consumer warpgroup
    making P, the other dP, each holding half of dq's columns): bf16 or
    fp16 at a head dim of 257 to 512, run at 384 or 512 as
    :func:`flash_d512_fwd` (the real D's scale passed)."""
    kw = dict(causal=causal, scale=scale, q_start=q_start, k_start=k_start,
              kv_bias=kv_bias, bias=bias, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    if return_ds and bias is None:
        raise ValueError("flash_d512_dq: return_ds needs the bias whose "
                         "gradient it is")
    if not dispatch.use_kernel(q):
        out = flash_bwd_plain(q, k, v, do, lse, delta, return_ds=return_ds,
                              **kw)
        return (out[0], out[3]) if return_ds else out[0]
    _wide_ready("flash_d512_dq", "tc512", q, k, v, do)
    return _tc_dq(flash_d512_dq, "tc512", q, k, v, do, lse, delta,
                  return_ds=return_ds, **kw)


flash_d512_dq.launches = 0


def _strided_dq(wrapper, entry: str, form: str, q, k, v, do, lse, delta,
                *, return_ds: bool, **kw):
    """dq (and dS) by a kernel that takes q, k, v and dO through their
    strides: the simple form (``form`` "simt") or the fp32 tensor-core forms
    ("f32", "f32_512"), C entry point ``entry``; ``wrapper`` counts the
    launch."""
    what = wrapper.__name__
    if return_ds and kw["bias"] is None:
        raise ValueError(f"{what}: return_ds needs the bias whose gradient "
                         f"it is")
    if not dispatch.use_kernel(q):
        out = flash_bwd_plain(q, k, v, do, lse, delta, return_ds=return_ds,
                              **kw)
        return (out[0], out[3]) if return_ds else out[0]
    d = q.shape[-1]
    q, k, v, do, lse, delta = _bwd_args(what, q, k, v, do, lse, delta, form)
    tail, _keep_alive = _tail(what, q, k, kw["kv_bias"], kw["bias"],
                              kw["dropout_rate"], kw["dropout_seed"],
                              kw["causal"], kw["scale"], kw["q_start"],
                              kw["k_start"])
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ds = torch.empty((q.shape[0], q.shape[1], k.shape[1]),
                     dtype=torch.float32, device=q.device) \
        if return_ds else None
    err = getattr(_cuda.lib(), entry)(
        _cuda.dtype_code(q.dtype, what), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), None if ds is None else ds.data_ptr(),
        *_strides(q, k, v, do), *tail)
    _cuda.check(err, what)
    wrapper.launches += 1
    dq = _unpad(dq, d)
    return (dq, ds) if return_ds else dq


def _strided_dkv(wrapper, entry: str, form: str, q, k, v, do, lse, delta,
                 **kw):
    """(dk, dv) by a kernel that takes its inputs through their strides,
    as :func:`_strided_dq`."""
    what = wrapper.__name__
    if not dispatch.use_kernel(q):
        return flash_bwd_plain(q, k, v, do, lse, delta, **kw)[1:]
    d = q.shape[-1]
    q, k, v, do, lse, delta = _bwd_args(what, q, k, v, do, lse, delta, form)
    tail, _keep_alive = _tail(what, q, k, kw["kv_bias"], kw["bias"],
                              kw["dropout_rate"], kw["dropout_seed"],
                              kw["causal"], kw["scale"], kw["q_start"],
                              kw["k_start"])
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = getattr(_cuda.lib(), entry)(
        _cuda.dtype_code(q.dtype, what), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_strides(q, k, v, do), *tail)
    _cuda.check(err, what)
    wrapper.launches += 1
    return _unpad(dk, d), _unpad(dv, d)


def flash_simt_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                  q_start: int = 0, k_start: int = 0, kv_bias=None,
                  bias=None, dropout_rate: float = 0.0, dropout_seed=0,
                  return_ds: bool = False):
    """:func:`flash_bwd_dq` by the simple form: any of fp32, bf16, fp16 and
    a head dim up to 512."""
    return _strided_dq(flash_simt_dq, "apex_flash_simt_dq", "simt", q, k, v,
                       do, lse, delta, causal=causal, scale=scale,
                       q_start=q_start, k_start=k_start, kv_bias=kv_bias,
                       bias=bias, dropout_rate=dropout_rate,
                       dropout_seed=dropout_seed, return_ds=return_ds)


flash_simt_dq.launches = 0


def flash_f32_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                 q_start: int = 0, k_start: int = 0, kv_bias=None,
                 bias=None, dropout_rate: float = 0.0, dropout_seed=0,
                 return_ds: bool = False):
    """:func:`flash_bwd_dq` in fp32 on the tensor cores in 3xTF32
    (``flash_f32.cu``; at D 256 by pairs of warps): fp32 at a head dim up
    to 256, padded to 64, 128 or 256 (the real D's scale passed)."""
    return _strided_dq(flash_f32_dq, "apex_flash_f32_dq", "f32", q, k, v, do,
                       lse, delta, causal=causal, scale=scale,
                       q_start=q_start, k_start=k_start, kv_bias=kv_bias,
                       bias=bias, dropout_rate=dropout_rate,
                       dropout_seed=dropout_seed, return_ds=return_ds)


flash_f32_dq.launches = 0


def flash_f32_d512_dq(q, k, v, do, lse, delta, *, causal: bool,
                      scale: float, q_start: int = 0, k_start: int = 0,
                      kv_bias=None, bias=None, dropout_rate: float = 0.0,
                      dropout_seed=0, return_ds: bool = False):
    """:func:`flash_bwd_dq` in fp32 on the tensor cores in 3xTF32 at D 384
    and 512 (``flash_f32_d512.cu``: pairs of warps over 16 query rows, one
    making S and P, the other dP, each holding half of dq's columns): fp32
    at a head dim of 257 to 512, handed as :func:`flash_f32_d512_fwd`
    (the real D's scale passed)."""
    return _strided_dq(flash_f32_d512_dq, "apex_flash_f32_d512_dq",
                       "f32_512", q, k, v, do, lse, delta, causal=causal,
                       scale=scale, q_start=q_start, k_start=k_start,
                       kv_bias=kv_bias, bias=bias, dropout_rate=dropout_rate,
                       dropout_seed=dropout_seed, return_ds=return_ds)


flash_f32_d512_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                  q_start: int = 0, k_start: int = 0, kv_bias=None,
                  bias=None, dropout_rate: float = 0.0, dropout_seed=0):
    """(dk, dv) [BH, Sk, D] in k's and v's dtypes. On the card, as
    :func:`kernel_form` picks for "dkv": the tensor-core kernel at D <= 128
    (counted here), :func:`flash_d256_dkv`, :func:`flash_d512_dkv`,
    :func:`flash_f32_dkv` or :func:`flash_f32_d512_dkv`."""
    kw = dict(causal=causal, scale=scale, q_start=q_start, k_start=k_start,
              kv_bias=kv_bias, bias=bias, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    if not dispatch.use_kernel(q):
        return flash_bwd_plain(q, k, v, do, lse, delta, **kw)[1:]
    _check("flash_bwd_dkv", q, k, v, do)
    form = kernel_form(q, "dkv")
    if form != "tc":
        return {"tc256": flash_d256_dkv, "tc512": flash_d512_dkv,
                "f32": flash_f32_dkv,
                "f32_512": flash_f32_d512_dkv}[form](q, k, v, do, lse, delta,
                                                     **kw)
    return _tc_dkv(flash_bwd_dkv, "tc", q, k, v, do, lse, delta, **kw)


flash_bwd_dkv.launches = 0


def _tc_dkv(wrapper, form, q, k, v, do, lse, delta, **kw):
    """(dk, dv) by the 16-bit tensor-core kernels (``flash_bwd.cu``; at D
    384 and 512 ``flash_d512_dkv.cu``'s dv and dk kernels, one C call) at
    q's head dim padded to :func:`_kernel_width` (``form`` "tc", "tc256"
    or "tc512": blocks of :data:`BLOCK_ROWS` keys, at D 256
    :data:`DKV_D256_KEYS`, at 384 and 512 :data:`D512_ROWS`); ``wrapper``
    counts the launch."""
    what = wrapper.__name__
    d = q.shape[-1]
    q, k, v, do, lse, delta = _bwd_args(what, q, k, v, do, lse, delta, form)
    tail, _keep_alive = _tail(what, q, k, kw["kv_bias"], kw["bias"],
                              kw["dropout_rate"], kw["dropout_seed"],
                              kw["causal"], kw["scale"], kw["q_start"],
                              kw["k_start"])
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dp = padded_head_dim(q.shape[-1])
    if dp > KERNEL_HEAD_DIMS[2]:
        entry, box, block = "apex_flash_d512_dkv", DQ_D512_KEYS[dp], \
            D512_ROWS
    else:
        entry, box = "apex_flash_bwd_dkv", TMA_BOX[1]
        block = DKV_D256_KEYS if dp == 256 else BLOCK_ROWS
    err = getattr(_cuda.lib(), entry)(
        _cuda.dtype_code(q.dtype, what), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _tma_maps(q, k, v, do, box_rows=box),
        row_blocks(k.shape[1], block), *tail)
    _cuda.check(err, what)
    wrapper.launches += 1
    return _unpad(dk, d), _unpad(dv, d)


def flash_d256_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                   q_start: int = 0, k_start: int = 0, kv_bias=None,
                   bias=None, dropout_rate: float = 0.0, dropout_seed=0):
    """:func:`flash_bwd_dkv` on the tensor cores at D 256
    (``flash_bwd.cu``'s split form: blocks of 64 keys, one consumer
    warpgroup making P and dv, the other dS and dk): bf16 or fp16 at a head
    dim of 129 to 256, padded to 256 (the real D's scale passed)."""
    kw = dict(causal=causal, scale=scale, q_start=q_start, k_start=k_start,
              kv_bias=kv_bias, bias=bias, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    if not dispatch.use_kernel(q):
        return flash_bwd_plain(q, k, v, do, lse, delta, **kw)[1:]
    _wide_ready("flash_d256_dkv", "tc256", q, k, v, do)
    return _tc_dkv(flash_d256_dkv, "tc256", q, k, v, do, lse, delta, **kw)


flash_d256_dkv.launches = 0


def flash_d512_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                   q_start: int = 0, k_start: int = 0, kv_bias=None,
                   bias=None, dropout_rate: float = 0.0, dropout_seed=0):
    """:func:`flash_bwd_dkv` on the tensor cores at D 384 and 512
    (``flash_d512_dkv.cu``: a dv kernel and a dk kernel, launched by one C
    call, over blocks of 64 keys, each consumer warpgroup holding half of
    dv's or dk's columns): bf16 or fp16 at a head dim of 257 to 512, run
    at 384 or 512 as :func:`flash_d512_fwd` (the real D's scale
    passed)."""
    kw = dict(causal=causal, scale=scale, q_start=q_start, k_start=k_start,
              kv_bias=kv_bias, bias=bias, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    if not dispatch.use_kernel(q):
        return flash_bwd_plain(q, k, v, do, lse, delta, **kw)[1:]
    _wide_ready("flash_d512_dkv", "tc512", q, k, v, do)
    return _tc_dkv(flash_d512_dkv, "tc512", q, k, v, do, lse, delta, **kw)


flash_d512_dkv.launches = 0


def flash_simt_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                   q_start: int = 0, k_start: int = 0, kv_bias=None,
                   bias=None, dropout_rate: float = 0.0, dropout_seed=0):
    """:func:`flash_bwd_dkv` by the simple form: any of fp32, bf16, fp16
    and a head dim up to 512 (:func:`flash_bwd_dkv` sends it nothing:
    every dtype and head dim has a tensor-core form)."""
    return _strided_dkv(flash_simt_dkv, "apex_flash_simt_dkv", "simt", q, k,
                        v, do, lse, delta, causal=causal, scale=scale,
                        q_start=q_start, k_start=k_start, kv_bias=kv_bias,
                        bias=bias, dropout_rate=dropout_rate,
                        dropout_seed=dropout_seed)


flash_simt_dkv.launches = 0


def flash_f32_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                  q_start: int = 0, k_start: int = 0, kv_bias=None,
                  bias=None, dropout_rate: float = 0.0, dropout_seed=0):
    """:func:`flash_bwd_dkv` in fp32 on the tensor cores in 3xTF32
    (``flash_f32.cu``; at D 256 by pairs of warps): fp32 at a head dim up
    to 256, padded to 64, 128 or 256."""
    return _strided_dkv(flash_f32_dkv, "apex_flash_f32_dkv", "f32", q, k, v,
                        do, lse, delta, causal=causal, scale=scale,
                        q_start=q_start, k_start=k_start, kv_bias=kv_bias,
                        bias=bias, dropout_rate=dropout_rate,
                        dropout_seed=dropout_seed)


flash_f32_dkv.launches = 0


def flash_f32_d512_dkv(q, k, v, do, lse, delta, *, causal: bool,
                       scale: float, q_start: int = 0, k_start: int = 0,
                       kv_bias=None, bias=None, dropout_rate: float = 0.0,
                       dropout_seed=0):
    """:func:`flash_bwd_dkv` in fp32 on the tensor cores in 3xTF32 at D 384
    and 512 (``flash_f32_d512.cu``: quads of warps over 16 keys, two
    warps holding dv's halves of the columns and two dk's, the partial
    products over halves of D traded): fp32 at a head dim of 257 to 512,
    handed as :func:`flash_f32_d512_fwd` (the real D's scale passed)."""
    return _strided_dkv(flash_f32_d512_dkv, "apex_flash_f32_d512_dkv",
                        "f32_512", q, k, v, do, lse, delta, causal=causal,
                        scale=scale, q_start=q_start, k_start=k_start,
                        kv_bias=kv_bias, bias=bias,
                        dropout_rate=dropout_rate, dropout_seed=dropout_seed)


flash_f32_d512_dkv.launches = 0

# resident blocks an SM is counted for when flash_bwd_dbias splits bh into
# runs: (query tiles) x (key tiles) x runs fills this many per SM
DBIAS_BLOCKS_PER_SM = 4


def dbias_runs(bh: int, sq: int, sk: int, sms: int) -> int:
    """How many runs of bh ``flash_bwd_dbias`` sums separately (then adds
    in run order) on a card of ``sms`` SMs: enough (query, key, run) blocks
    to fill it, every run nonempty."""
    tiles = -(-sq // 64) * -(-sk // 64)
    runs = max(1, min(bh, -(-DBIAS_BLOCKS_PER_SM * sms // tiles)))
    per = -(-bh // runs)
    return -(-bh // per)


def _check_shared_bias(what: str, bias) -> None:
    if bias is None or bias.dim() != 3 or bias.shape[0] != 1:
        raise ValueError(f"{what}: takes a bias [1, Sq, Sk]")


def flash_bwd_dbias(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                    bias, q_start: int = 0, k_start: int = 0, kv_bias=None,
                    dropout_rate: float = 0.0, dropout_seed=0):
    """The gradient of a ``bias`` [1, Sq, Sk] shared over bh: dS summed over
    bh, fp32 [1, Sq, Sk] (the caller casts it to the bias's dtype). On the
    card, as :func:`kernel_form` picks for "dbias", ``flash_dbias.cu``'s
    kernel of q's dtype family at any head dim up to 512: bf16/fp16 on
    ``wgmma`` ("tc": q, k, v and dO read by TMA at their width rounded up
    to a multiple of 8, the columns past it zero-filled by the copies), fp32
    in 3xTF32 ("f32": read through their strides at their width rounded up
    to a multiple of 4). Blocks of (64 queries, 64 keys, a run of bh) sum
    dS over their run in bh order, and a second pass adds the runs
    (:func:`dbias_runs`) in run order: no float atomics, so repeated calls
    are bitwise equal, and no [BH, Sq, Sk] tensor, the only scratch [runs,
    Sq, Sk]. Counted here, one launch a call."""
    what = "flash_bwd_dbias"
    _check_shared_bias(what, bias)
    if not dispatch.use_kernel(q):
        return flash_bwd_dbias_plain(q, k, v, do, lse, delta, causal=causal,
                                     scale=scale, bias=bias,
                                     q_start=q_start, k_start=k_start,
                                     kv_bias=kv_bias,
                                     dropout_rate=dropout_rate,
                                     dropout_seed=dropout_seed)
    _check(what, q, k, v, do)
    form = kernel_form(q, "dbias")
    # 16 bytes: the unit of TMA's strides ("tc") and of the 16-byte copies
    # ("f32")
    unit = 8 if form == "tc" else 4
    dw = -(-q.shape[-1] // unit) * unit
    ready = _tma_readable if form == "tc" else _readable
    q, k, v, do = (ready(_pad_d(t, dw)) for t in (q, k, v, do))
    bh, sq, _ = q.shape
    sk = k.shape[1]
    lse = _row_stats(f"{what} lse", lse, bh, sq, q.device)
    delta = _row_stats(f"{what} delta", delta, bh, sq, q.device)
    tail, _keep_alive = _tail(what, q, k, kv_bias, bias, dropout_rate,
                              dropout_seed, causal, scale, q_start, k_start)
    runs = dbias_runs(bh, sq, sk, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    dbias = torch.empty((1, sq, sk), dtype=torch.float32, device=q.device)
    part = torch.empty((runs, sq, sk), dtype=torch.float32,
                       device=q.device) if runs > 1 else None
    head = (_cuda.dtype_code(q.dtype, what), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dbias.data_ptr(), None if part is None else part.data_ptr())
    if form == "tc":
        err = _cuda.lib().apex_flash_tc_dbias(
            *head, _tma_maps(q, k, v, do), runs, *tail)
    else:
        err = _cuda.lib().apex_flash_f32_dbias(
            *head, runs, *_strides(q, k, v, do), *tail)
    _cuda.check(err, what)
    flash_bwd_dbias.launches += 1
    return dbias


flash_bwd_dbias.launches = 0


def flash_simt_dbias(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                     bias, q_start: int = 0, k_start: int = 0, kv_bias=None,
                     dropout_rate: float = 0.0, dropout_seed=0):
    """:func:`flash_bwd_dbias` by the simple form (``flash_simt.cu``): its
    dq kernel writes the per-bh dS [BH, Sq, Sk] fp32 and a second kernel
    sums it over bh in bh order, the pair counted as one launch. Any of
    fp32, bf16, fp16 and a head dim up to 512; :func:`flash_bwd_dbias`
    sends it nothing (it stays as the yardstick)."""
    what = "flash_simt_dbias"
    _check_shared_bias(what, bias)
    if not dispatch.use_kernel(q):
        return flash_bwd_dbias_plain(q, k, v, do, lse, delta, causal=causal,
                                     scale=scale, bias=bias,
                                     q_start=q_start, k_start=k_start,
                                     kv_bias=kv_bias,
                                     dropout_rate=dropout_rate,
                                     dropout_seed=dropout_seed)
    q, k, v, do, lse, delta = _bwd_args(what, q, k, v, do, lse, delta)
    bh, sq, _ = q.shape
    sk = k.shape[1]
    tail, _keep_alive = _tail(what, q, k, kv_bias, bias, dropout_rate,
                              dropout_seed, causal, scale, q_start, k_start)
    dbias = torch.empty((1, sq, sk), dtype=torch.float32, device=q.device)
    ds = torch.empty((bh, sq, sk), dtype=torch.float32, device=q.device)
    err = _cuda.lib().apex_flash_simt_dbias(
        _cuda.dtype_code(q.dtype, what), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dbias.data_ptr(), ds.data_ptr(), *_strides(q, k, v, do), *tail)
    _cuda.check(err, what)
    flash_simt_dbias.launches += 1
    return dbias


flash_simt_dbias.launches = 0
