"""Flash attention — counterpart of
``apex_tpu/contrib/multihead_attn/flash_attention.py``.

``flash_attention`` is a ``torch.autograd.Function`` whose forward is the
flash forward kernel and whose backward is the dq and dk/dv kernels, and
for a bias that needs a gradient either the dq kernel's per-bh dS (a
``[BH, Sq, Sk]`` bias) or the shared-bias gradient kernel (a ``[1, Sq,
Sk]`` one) (``ops/flash_attn.py``; the plain versions for CPU tensors):
``_flash_core`` and its forward and backward (:737-826). lse is a true
output whose cotangent folds into the backward's per-row term, and stays
dropout-free. A per-key ``kv_bias`` [1|BH, Sk] (key-padding masks) rides
into every kernel and gets no gradient, as ``_flash_core_bwd`` returns
zeros for it (:823-826); a ``bias`` gets one in its own dtype unless
``bias_grad=False`` declares it a mask (then zeros, without the O(Sq·Sk)
work). Dropout on the probabilities uses the JAX package's coordinate
hash, so the two packages drop the same elements for the same seed.

``reference_attention`` is the unfused path (``impl="default"``, prefill
and the numerics oracle). ``DEFAULT_FLASH_MIN_S`` is the port's own
crossover, measured on an H100 (``chip_smoke.py`` phase 2,
``flash_crossover``); the port reads no crossover file and no environment
variable: the JAX package's hold TPU measurements.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp.autocast import custom_grad
from apex_tpu_torch.ops import flash_attn as FA
from apex_tpu_torch.ops.flash_attn import (NEG_INF, dropout_bits,
                                           reference_attention)

__all__ = ["NEG_INF", "DEFAULT_FLASH_MIN_S", "dropout_bits",
           "reference_attention", "flash_attention"]

# the smallest max(Sq, Sk) that impl="auto" sends to the tensor-core flash
# kernels: the smallest S measured from which the kernels beat the plain
# path at every larger S, forward and forward + backward, causal and not,
# at [128, S, 64] for S 128-4096. On an NVIDIA H100 80GB HBM3 at 700 W
# they won at every S, in bf16 (chip_smoke.py phase 2; at [32, S, 256]
# too, the D-256 kernels) and in fp32 (the 3xTF32 kernels;
# chip_smoke.flash_crossover_phase(torch, "float32"); PERF.md); below 128
# nothing was measured, so those go plain. fp32 at [32, S, 256] has no
# such length (its forward loses from S 1024 without a causal mask), so
# impl="auto" gives fp32 past head dim 128 none (modules._flash_wins).
DEFAULT_FLASH_MIN_S = 128


class _FlashCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, kv_bias, cfg, bias_grad):
        o, lse = FA.flash_fwd(q, k, v, bias=bias, kv_bias=kv_bias, **cfg)
        ctx.save_for_backward(q, k, v, o, lse, bias, kv_bias)
        ctx.cfg, ctx.bias_grad = cfg, bias_grad
        ctx.set_materialize_grads(False)   # an unused lse costs nothing
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, bias, kv_bias = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        delta = FA.flash_delta(o, do, dlse)
        kw = dict(bias=bias, kv_bias=kv_bias, **ctx.cfg)
        dbias = None
        if not ctx.needs_input_grad[3]:
            dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        elif not ctx.bias_grad:               # a mask: zeros (:551-552)
            dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
            dbias = torch.zeros_like(bias)
        elif bias.shape[0] == 1 and q.shape[0] > 1:
            # summed over bh by its own kernel, no [BH, Sq, Sk] tensor
            dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
            dbias = FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw)
        else:                                  # per bh: the dq kernel's dS
            dq, dbias = FA.flash_bwd_dq(q, k, v, do, lse, delta,
                                        return_ds=True, **kw)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, dbias, None, None, None


@custom_grad
def flash_attention(q, k, v, bias=None, *, kv_bias=None,
                    causal: bool = False, scale=None, q_start: int = 0,
                    k_start: int = 0, return_lse: bool = False,
                    bias_grad: bool = True, dropout_rate: float = 0.0,
                    dropout_seed=0):
    """Fused attention over [B, H, S, D] (or [BH, S, D]) inputs, causal
    masking by absolute positions ``q_start + i`` / ``k_start + j``, an
    optional additive ``bias`` [1|BH, Sq, Sk] (or [B, H, Sq, Sk] with 4-D
    inputs; its gradient in its own dtype, or zeros with ``bias_grad=False``),
    an optional per-key additive ``kv_bias`` [1|BH, Sk] (no gradient), and
    dropout of the probabilities at ``dropout_rate`` from ``dropout_seed``
    (an int in [-2**31, 2**32)). Returns o in q's dtype and, with
    ``return_lse``, the fp32 lse (dropout-free)."""
    lead = q.shape[:-2]
    if q.dim() == 4:
        q, k, v = (t.reshape(-1, *t.shape[2:]) for t in (q, k, v))
        if bias is not None and bias.dim() == 4:
            bias = bias.reshape(-1, *bias.shape[2:])
    bh, sq, d = q.shape
    sk = k.shape[1]
    if bias is not None and (bias.dim() != 3 or bias.shape[0] not in (1, bh)
                             or tuple(bias.shape[1:]) != (sq, sk)):
        raise ValueError(f"flash_attention: bias must be [1 or {bh}, {sq}, "
                         f"{sk}] (or [B, H, Sq, Sk]), got "
                         f"{tuple(bias.shape)}")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    if kv_bias is not None:
        kv_bias = kv_bias.detach()
    cfg = dict(causal=bool(causal), scale=float(scale), q_start=int(q_start),
               k_start=int(k_start), dropout_rate=float(dropout_rate),
               dropout_seed=int(dropout_seed))
    o, lse = _FlashCore.apply(q, k, v, bias, kv_bias, cfg, bool(bias_grad))
    o = o.reshape(*lead, *o.shape[1:])
    if return_lse:
        return o, lse.reshape(*lead, lse.shape[-1])
    return o
