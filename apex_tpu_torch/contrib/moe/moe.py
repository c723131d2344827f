"""Switch-style MoE MLP with optional expert parallelism — counterpart of
``apex_tpu/contrib/moe/moe.py`` (see the package docstring for the
design)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel import collectives as _C


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no order
    among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes, by comparison (no range
    check, so no host sync inside a captured program)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


@dataclasses.dataclass(frozen=True)
class MoEMLP:
    """Top-k mixture-of-experts FFN (moe.py:16-197): Switch top-1 by
    default, GShard top-2 with ``top_k=2``.

    ``apply(params, x)`` with x [tokens, hidden] returns ``(y, aux)``;
    ``aux`` holds the Switch load-balance loss (E · Σ_e f_e · p_e, f the
    fraction of first choices routed to e, p the mean router prob) and the
    dropped fraction of assignments. Top-k: each token's k experts get
    the gates ``p_i / Σ_j p_j``; queue seats go to every first choice
    before any second choice.

    Expert parallelism: with ``expert_axis`` / ``expert_axis_size`` every
    rank calls ``apply`` on the same tokens with its slice of the
    expert-stacked leaves (``w1``, ``b1``, ``w2``, ``b2``: experts
    ``r·E/n`` to ``(r+1)·E/n``) and the whole router. The dispatch
    buffer is marked ``collectives.pvary``, so the gradients of the
    tokens and of every replicated parameter come out whole on every
    rank; the expert slices' are exact.

    ``device``: where ``init`` puts the parameters (None: the card)."""

    hidden: int
    ffn: int
    num_experts: int
    capacity_factor: float = 1.25
    top_k: int = 1
    expert_axis: Optional[str] = None
    expert_axis_size: int = 0
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(f"top_k must be in [1, num_experts], "
                             f"got {self.top_k}")
        if self.expert_axis is not None:
            if self.expert_axis_size < 2:
                raise ValueError("expert_axis requires expert_axis_size >= 2")
            if self.num_experts % self.expert_axis_size:
                raise ValueError(
                    f"num_experts {self.num_experts} not divisible by "
                    f"expert_axis_size {self.expert_axis_size}")
        object.__setattr__(self, "device", resolve_device(self.device))

    def init(self, generator: Union[torch.Generator, int] = 0, *,
             dtype: torch.dtype = torch.float32) -> dict:
        """Random parameters with the JAX names and shapes (the router
        normal · 0.02, the experts normal · sqrt(2 / fan_in), zero
        biases), drawn on the CPU from ``generator`` and moved to
        ``self.device`` in ``dtype``."""
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        e, h, f = self.num_experts, self.hidden, self.ffn

        def normal(*shape):
            return torch.randn(shape, generator=generator)

        p = {"router": normal(h, e) * 0.02,
             "w1": normal(e, h, f) * (2.0 / h) ** 0.5,
             "b1": torch.zeros(e, 1, f),
             "w2": normal(e, f, h) * (2.0 / f) ** 0.5,
             "b2": torch.zeros(e, 1, h)}
        return {k: v.to(device=self.device, dtype=dtype)
                for k, v in p.items()}

    def capacity(self, n_tokens: int) -> int:
        # GShard sizing: k·N assignments, so the queues scale with k
        return max(1, math.ceil(
            n_tokens * self.top_k / self.num_experts
            * self.capacity_factor))

    def _route(self, params, x):
        """fp32 router probs [N, E], the top-k experts [N, K] and their
        gates [N, K] (renormalized over the selection for k > 1)."""
        logits = x.float() @ params["router"].float()
        probs = torch.softmax(logits, dim=-1)
        topp, tope = _top_k(probs, self.top_k)
        gates = topp if self.top_k == 1 else \
            topp / topp.sum(dim=-1, keepdim=True)
        return probs, tope, gates

    def apply(self, params: dict, x: torch.Tensor):
        """x: [N, hidden]. Returns (y [N, hidden] in x's dtype, aux dict
        of fp32 scalars)."""
        n, h = x.shape
        e, k = self.num_experts, self.top_k
        c = self.capacity(n)
        probs, tope, gates = self._route(params, x)

        # queue positions in choice-priority (k-major) order
        e_flat = tope.t().reshape(-1)                          # [K*N]
        onehot = _one_hot(e_flat, e)                           # [K*N, E]
        seen = torch.cumsum(onehot.to(torch.int32), dim=0) - \
            onehot.to(torch.int32)
        pos = (seen * onehot.to(torch.int32)).sum(dim=-1)      # [K*N]
        keep = pos < c

        # dispatch into [E*C + 1, H]; kept slots are unique, the overflow
        # row E*C is discarded
        slot = torch.where(keep, e_flat * c + pos,
                           torch.full_like(pos, e * c))
        x_rep = x.repeat(k, 1)                                 # [K*N, H]
        buf = torch.zeros((e * c + 1, h), dtype=x.dtype,
                          device=x.device).index_add(0, slot, x_rep)
        xe = buf[:e * c].reshape(e, c, h)                      # [E, C, H]
        gates_kn = gates.t().reshape(-1)                       # [K*N]

        if self.expert_axis is None:
            ye = self._ffn(params, xe)
            flat = ye.reshape(e * c, h)
            yk = flat[torch.clamp(slot, 0, e * c - 1)]
            yk = torch.where(keep[:, None], yk, torch.zeros_like(yk))
        else:
            el = e // self.expert_axis_size
            r = _C.axis_index(self.expert_axis)
            xe = _C.pvary(xe, self.expert_axis)
            ye = self._ffn(params, xe[r * el:(r + 1) * el])   # [El, C, H]
            flat = ye.reshape(el * c, h)
            local = slot - r * el * c
            mine = keep & (local >= 0) & (local < el * c)
            yk = flat[torch.clamp(local, 0, el * c - 1)].float()
            yk = torch.where(mine[:, None], yk, torch.zeros_like(yk))
            # each assignment is produced by exactly one rank: the sum is
            # exact (in fp32, which gloo reduces in any backend)
            yk = _C.psum(yk, self.expert_axis)
        yk = yk.float() * gates_kn[:, None]
        y = yk.reshape(k, n, h).sum(dim=0).to(x.dtype)

        frac_routed = onehot[:n].mean(dim=0)                   # f_e
        mean_prob = probs.mean(dim=0)                          # p_e
        aux = {"load_balance_loss": e * torch.sum(frac_routed * mean_prob),
               "dropped_fraction": 1.0 - keep.float().mean()}
        return y, aux

    def decode(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The capacity-free inference mixture (moe.py:147-178): every
        token served by its top-k experts, all experts computed densely
        over the [N, hidden] batch. Equals ``apply`` wherever apply's
        capacity does not bind. No host sync and no data-dependent shape,
        so a CUDA graph captures it. Single-device only."""
        if self.expert_axis is not None:
            raise NotImplementedError(
                "MoE decode() is single-device; run it outside expert "
                "parallelism")
        n, h = x.shape
        e = self.num_experts
        _, tope, gates = self._route(params, x)
        ye = self._ffn(params, x.expand(e, n, h))              # [E, N, H]
        sel = _one_hot(tope, e)                                # [N, K, E]
        y = torch.einsum("enh,nke,nk->nh", ye.float(), sel, gates)
        return y.to(x.dtype)

    def _ffn(self, params, xe):
        """The experts' FFN over [E', C, H] in fp32 (tanh GELU, as
        jax.nn.gelu), the weights sliced to the same E' experts under
        expert parallelism by the caller's params; returns xe's dtype."""
        hdn = F.gelu(torch.bmm(xe.float(), params["w1"].float())
                     + params["b1"], approximate="tanh")
        out = torch.bmm(hdn, params["w2"].float()) + params["b2"]
        return out.to(xe.dtype)

    __call__ = apply
