"""Flash attention — counterpart of
``apex_tpu/contrib/multihead_attn/flash_attention.py``.

``flash_attention`` is a ``torch.autograd.Function`` whose forward is the
flash forward kernel and whose backward is the dq and dk/dv kernels
(``ops/flash_attn.py``; the plain versions for CPU tensors), with lse as a
true output whose cotangent folds into the backward's per-row term.
``reference_attention`` is the unfused path (``impl="default"``, prefill
and the numerics oracle). A per-key ``kv_bias`` [1|BH, Sk] (key-padding
masks) rides into all three kernels and gets no gradient, as
``_flash_core_bwd`` returns zeros for it (:823-826).

Not ported yet, and refused: an additive ``bias`` and dropout (ROADMAP.md
Queue 1, item 15). ``DEFAULT_FLASH_MIN_S`` is the port's own crossover,
measured on an H100 (``chip_smoke.py`` phase 2, ``flash_crossover``); the
port reads no crossover file and no environment variable: the JAX
package's hold TPU measurements.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import flash_attn as FA
from apex_tpu_torch.ops.flash_attn import NEG_INF, reference_attention

__all__ = ["NEG_INF", "DEFAULT_FLASH_MIN_S", "reference_attention",
           "flash_attention"]

# the smallest max(Sq, Sk) that impl="auto" sends to the flash kernels:
# the smallest S measured from which the kernels beat the plain path at
# every larger S, forward and forward + backward, causal and not, at
# [128, S, 64] bf16 for S 128-4096. On an NVIDIA H100 80GB HBM3 at 700 W
# they won at every S (chip_smoke.py phase 2; PERF.md); below 128 nothing
# was measured, so those go plain.
DEFAULT_FLASH_MIN_S = 128


class _FlashCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_bias, causal, scale, q_start, k_start):
        cfg = dict(causal=causal, scale=scale, q_start=q_start,
                   k_start=k_start)
        o, lse = FA.flash_fwd(q, k, v, kv_bias=kv_bias, **cfg)
        ctx.save_for_backward(q, k, v, o, lse, kv_bias)
        ctx.cfg = cfg
        ctx.set_materialize_grads(False)   # an unused lse costs nothing
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, kv_bias = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        delta = FA.flash_delta(o, do, dlse)
        dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, kv_bias=kv_bias,
                             **ctx.cfg)
        dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, kv_bias=kv_bias,
                                  **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, bias=None, *, kv_bias=None,
                    causal: bool = False, scale=None, q_start: int = 0,
                    k_start: int = 0, return_lse: bool = False,
                    dropout_rate: float = 0.0):
    """Fused attention over [B, H, S, D] (or [BH, S, D]) inputs, causal
    masking by absolute positions ``q_start + i`` / ``k_start + j``, and
    an optional per-key additive ``kv_bias`` [1|BH, Sk] (no gradient).
    Returns o in q's dtype and, with ``return_lse``, the fp32 lse."""
    if bias is not None or dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_attention: the full bias and dropout are not ported yet "
            "(ROADMAP.md Queue 1, item 15)")
    lead = q.shape[:-2]
    if q.dim() == 4:
        q, k, v = (t.reshape(-1, *t.shape[2:]) for t in (q, k, v))
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if kv_bias is not None:
        kv_bias = kv_bias.detach()
    o, lse = _FlashCore.apply(q, k, v, kv_bias, bool(causal), float(scale),
                              int(q_start), int(k_start))
    o = o.reshape(*lead, *o.shape[1:])
    if return_lse:
        return o, lse.reshape(*lead, lse.shape[-1])
    return o
