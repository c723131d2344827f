"""Transformer language model — counterpart of
``apex_tpu/models/transformer.py``: the serving path and the training
loss, with Switch/GShard MoE layers and sequence parallelism.

Pre-LN decoder-only architecture::

    x  = tok_emb + pos_emb
    x += MHA(LN(x))            # causal
    x += MLP(LN(x))            # GeLU (tanh form, as jax.nn.gelu)
    logits = LN(x) @ tok_emb.T

Ported: every config field, ``init`` (same names and shapes, drawn from
a ``torch.Generator``), ``apply`` (the forward, under autograd, with
attention dropout, ``remat`` / ``remat_policy``, MoE layers and their
aux terms (``return_aux``), and the time axis sharded over ``seq_axis``),
``loss`` (next-token cross entropy through the chunked fused head, or
with ``head_chunk=0`` over the full logits through the softmax
cross-entropy kernels; under ``seq_axis`` the targets shifted across the
shard boundary and the global mean), the KV-cache block stack
``_cached_blocks``, ``_decode_one``, the fused slot-batched decode step
``_decode_slots`` (1-query and the [S, Q] multi-row form of speculative
scoring, dense and paged arenas), ``_prefill``, the sampling filters
``_filter_logits`` and ``generate`` (greedy, or sampled at a temperature
with top-k / top-p from the counter stream of
``apex_tpu_torch._stream``). Parameters keep the JAX layout, weights
``[in, out]``, so ``x @ W`` is the same product in both packages.

Every LayerNorm goes through ``normalization.fused_layer_norm_affine``
(the LayerNorm kernels on the card), ``apply``'s attention through
``SelfMultiheadAttn`` with ``attn_impl`` (the flash kernels on the card
for "fast"; the ring of ``parallel.ring_attention`` under ``seq_axis``),
and the decode step's attention through ``slot_decode_attention`` (the
decode kernels on the card). Prefill attention is ``reference_attention``,
plain PyTorch, as in the JAX package. The QKV, out-projection, MLP and
head products are ``torch.matmul``, as they were plain XLA dots there;
an MoE layer (every ``moe_every``-th, ``contrib.moe.MoEMLP``) computes
its experts in fp32 products, capacity-bound in training
(``MoEMLP.apply``) and capacity-free at inference (``MoEMLP.decode``).

Sequence parallelism: every rank of ``seq_axis`` calls ``apply`` or
``loss`` with its shard of the time axis (``parallel.collectives`` binds
the axis); positions start at ``axis_index · t``. ``loss`` returns the
global mean on every rank, and under the collectives' rule each rank's
gradient is its partial: the global gradient is their sum over the axis
(``train.SeqParallelTrainer``). Expert parallelism (``expert_axis``):
every rank runs the same tokens with its slice of each MoE layer's
experts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._stream import gumbel_argmax, stream_uniforms
from apex_tpu_torch.contrib.moe import MoEMLP
from apex_tpu_torch.contrib.multihead_attn.decode_attention import (
    slot_decode_attention)
from apex_tpu_torch.contrib.multihead_attn.flash_attention import (
    reference_attention)
from apex_tpu_torch.contrib.multihead_attn.modules import SelfMultiheadAttn
from apex_tpu_torch.contrib.xentropy import (linear_cross_entropy,
                                             softmax_cross_entropy_loss)
from apex_tpu_torch.models import _remat
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.parallel import collectives as _C

__all__ = ["TransformerLM"]


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class TransformerLM:
    vocab_size: int
    max_seq_len: int = 2048
    embed_dim: int = 512
    num_heads: int = 8
    num_layers: int = 6
    ffn_mult: int = 4
    dropout: float = 0.0
    attn_impl: str = "auto"
    # > 0: the loss goes through linear_cross_entropy in vocab chunks of
    # this size and never builds the [B*T, V] logits
    head_chunk: int = 0
    # sequence parallelism: the time axis sharded over this named axis
    # (every rank calls apply/loss with its shard), attention the ring
    seq_axis: Optional[str] = None
    seq_axis_size: int = 0
    # Mixture-of-Experts: every moe_every-th MLP a Switch (top 1) or GShard
    # (top 2) MoE FFN of moe_experts experts; expert_axis/_size run the
    # experts expert-parallel (each rank its slice of the expert leaves)
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01     # Switch load-balance loss weight
    expert_axis: Optional[str] = None
    expert_axis_size: int = 0
    # rematerialize each block in the backward (models/_remat.py);
    # remat_policy names what is still saved inside it (a
    # jax.checkpoint_policies name; None saves nothing)
    remat: bool = False
    remat_policy: Optional[str] = None
    # where init() puts the parameters; None means the card
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        _remat.validate_remat_config(self.remat, self.remat_policy)
        if self.head_chunk > 0 and \
                self.vocab_size % min(self.head_chunk, self.vocab_size):
            raise ValueError(
                f"head_chunk ({self.head_chunk}) must divide "
                f"vocab_size ({self.vocab_size})")
        if self.moe_experts > 0:
            if self.moe_every < 1:
                raise ValueError(f"moe_every must be >= 1, "
                                 f"got {self.moe_every}")
            if self.num_layers < self.moe_every:
                raise ValueError(
                    f"moe_experts={self.moe_experts} requested but no "
                    f"layer index hits moe_every={self.moe_every} with "
                    f"num_layers={self.num_layers} — the model would be "
                    f"silently dense")
        if self.embed_dim % self.num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self._mha()                  # validates attn_impl and seq_axis
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.moe_experts > 0:
            self._moe()                      # validates top_k, the axis

    def _mha(self) -> SelfMultiheadAttn:
        return SelfMultiheadAttn(self.embed_dim, self.num_heads, bias=True,
                                 causal=True, dropout=self.dropout,
                                 impl=self.attn_impl, seq_axis=self.seq_axis,
                                 seq_axis_size=self.seq_axis_size)

    def _is_moe_layer(self, i: int) -> bool:
        return self.moe_experts > 0 and (i % self.moe_every
                                         == self.moe_every - 1)

    def _moe(self) -> MoEMLP:
        return MoEMLP(hidden=self.embed_dim,
                      ffn=self.ffn_mult * self.embed_dim,
                      num_experts=self.moe_experts, top_k=self.moe_top_k,
                      capacity_factor=self.moe_capacity_factor,
                      expert_axis=self.expert_axis,
                      expert_axis_size=self.expert_axis_size,
                      device=self.device)

    def init(self, generator: Union[torch.Generator, int] = 0, *,
             dtype: torch.dtype = torch.float32) -> dict:
        """Random parameters with the JAX names and shapes, drawn on the
        CPU from ``generator`` (a ``torch.Generator`` or a seed) and moved
        to ``self.device`` in ``dtype``. The draws differ from
        ``jax.random``'s; to hold the two packages on the same weights,
        convert the JAX tree with ``convert.params_from_jax``."""
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        e, v = self.embed_dim, self.vocab_size
        scale = 0.02

        def normal(*shape):
            return torch.randn(shape, generator=generator) * scale

        def ln():
            return {"g": torch.ones(e), "b": torch.zeros(e)}

        p = {"tok_emb": normal(v, e), "pos_emb": normal(self.max_seq_len, e),
             "ln_f": ln()}
        mha = self._mha()
        f = self.ffn_mult * e
        for i in range(self.num_layers):
            lp = {"ln1": ln(), "attn": mha.init(generator), "ln2": ln()}
            if self._is_moe_layer(i):
                lp["moe"] = self._moe().init(generator)
            else:
                lp["mlp"] = {"w1": normal(e, f), "b1": torch.zeros(f),
                             "w2": normal(f, e), "b2": torch.zeros(e)}
            p[f"layer_{i}"] = lp
        return _tree_to(p, self.device, dtype)

    def _ln(self, x, lnp):
        return fused_layer_norm_affine(x, (self.embed_dim,), lnp["g"],
                                       lnp["b"], 1e-5)

    def _mlp(self, x, mp):
        h = _gelu(x @ mp["w1"] + mp["b1"])
        return h @ mp["w2"] + mp["b2"]

    def _ffn_decode(self, i, lp, h):
        """Layer i's FFN at inference: the MLP, or the capacity-free MoE
        mixture over the flattened tokens."""
        if not self._is_moe_layer(i):
            return self._mlp(h, lp["mlp"])
        y = self._moe().decode(lp["moe"], h.reshape(-1, self.embed_dim))
        return y.reshape(h.shape)

    def apply(self, params: dict, tokens: torch.Tensor, *,
              is_training: bool = False, dropout_seeds=None,
              return_hidden: bool = False, return_aux: bool = False):
        """tokens: int [B, T] (under ``seq_axis`` this rank's shard).
        Returns logits fp32 [B, T, vocab] or, with ``return_hidden``, the
        final-LN hidden states [B, T, E] (for the chunked head loss); with
        ``return_aux`` also ``{"moe_load_balance_loss": the sum over MoE
        layers, "moe_dropped_fraction": their mean}``. Differentiable in
        ``params``. In training, ``dropout_seeds`` (one int per layer,
        where JAX folds the layer index into its key,
        transformer.py:189-193) drives the attention dropout; without
        seeds there is none."""
        b, t = tokens.shape
        seeds = _layer_seeds(dropout_seeds, self.num_layers)
        pos0, total = 0, t
        if self.seq_axis is not None:
            pos0 = _C.axis_index(self.seq_axis) * t
            total = t * max(1, self.seq_axis_size)
        if total > self.max_seq_len:
            raise ValueError(
                f"sequence length {total} exceeds max_seq_len="
                f"{self.max_seq_len}; raise max_seq_len at construction")
        tokens = tokens.to(params["tok_emb"].device, torch.long)
        # F.embedding: its backward sums the rows in a fixed order
        x = F.embedding(tokens, params["tok_emb"]) + \
            params["pos_emb"][pos0:pos0 + t]
        mha = self._mha()
        zero = torch.zeros((), dtype=torch.float32, device=x.device)

        def layer_body(x, lp, seed, moe):
            h = self._ln(x, lp["ln1"])
            # MHA modules are time-major [T, B, E]
            attn_out, _ = mha.apply(lp["attn"], h.transpose(0, 1),
                                    is_training=is_training,
                                    dropout_seed=seed)
            x = x + attn_out.transpose(0, 1)
            h = self._ln(x, lp["ln2"])
            if moe:
                y, aux = self._moe().apply(lp["moe"],
                                           h.reshape(-1, self.embed_dim))
                return (x + y.reshape(h.shape), aux["load_balance_loss"],
                        aux["dropped_fraction"])
            return x + self._mlp(h, lp["mlp"]), zero, zero

        if self.remat:
            layer_body = _remat.remat(layer_body, self.remat_policy)
        balance, dropped, n_moe = zero, zero, 0
        for i in range(self.num_layers):
            moe = self._is_moe_layer(i)
            x, bal, drop = layer_body(x, params[f"layer_{i}"], seeds[i],
                                      moe)
            if moe:
                balance, dropped, n_moe = balance + bal, dropped + drop, \
                    n_moe + 1
        x = self._ln(x, params["ln_f"])
        out = x if return_hidden else (x @ params["tok_emb"].T).float()
        if return_aux:
            return out, {"moe_load_balance_loss": balance,
                         "moe_dropped_fraction": dropped / max(n_moe, 1)}
        return out

    def _token_losses(self, params, out, targets_flat):
        """Per-token losses from apply()'s output: the fp32 logits through
        the softmax cross-entropy op (no padding token in this LM), or the
        final hidden states through the chunked fused head when
        ``head_chunk`` > 0 (transformer.py:240-252)."""
        if self.head_chunk <= 0:
            return softmax_cross_entropy_loss(
                out.reshape(-1, self.vocab_size), targets_flat,
                padding_idx=None)
        return linear_cross_entropy(out.reshape(-1, self.embed_dim),
                                    params["tok_emb"], targets_flat,
                                    chunk=self.head_chunk)

    def loss(self, params: dict, tokens: torch.Tensor, *,
             is_training: bool = True, dropout_seeds=None) -> torch.Tensor:
        """Mean next-token cross entropy of tokens int [B, T]
        (transformer.py:254-305), plus ``moe_aux_weight`` times the MoE
        load-balance loss. Without ``seq_axis`` the model reads
        ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``. Under
        ``seq_axis`` tokens is this rank's shard, read whole: the target
        of the shard's last position is the next shard's first token
        (``ppermute``), the global last position has none, and the result
        is the global mean, ``psum(total) / count``, on every rank; the
        load-balance term is its mean over the axis (each shard routes its
        own tokens), so the value is the same on every rank and the sum of
        the ranks' gradients is the step's (JAX adds each shard's own
        term, and ``train_ring.py``'s ``pmean`` of the gradients takes the
        same mean). ``dropout_seeds`` as for :meth:`apply`."""
        moe = self.moe_experts > 0
        hid = self.head_chunk > 0
        if self.seq_axis is None:
            out = self.apply(params, tokens[:, :-1], is_training=is_training,
                             dropout_seeds=dropout_seeds, return_hidden=hid,
                             return_aux=moe)
            out, aux = out if moe else (out, None)
            targets = tokens[:, 1:].to(out.device, torch.long)
            loss = torch.mean(self._token_losses(params, out,
                                                 targets.reshape(-1)))
            if moe:
                loss = loss + self.moe_aux_weight * \
                    aux["moe_load_balance_loss"]
            return loss
        n = self.seq_axis_size
        b, t = tokens.shape
        out = self.apply(params, tokens, is_training=is_training,
                         dropout_seeds=dropout_seeds, return_hidden=hid,
                         return_aux=moe)
        out, aux = out if moe else (out, None)
        tokens = tokens.to(out.device, torch.long)
        # the last local position's target is the next shard's first token
        nxt_first = _C.ppermute(tokens[:, :1], self.seq_axis,
                                [((i + 1) % n, i) for i in range(n)])
        targets = torch.cat([tokens[:, 1:], nxt_first], dim=1)
        losses = self._token_losses(params, out,
                                    targets.reshape(-1)).reshape(b, t)
        # the global final position (the last shard's last) has no target
        mask = torch.ones((b, t), dtype=losses.dtype, device=losses.device)
        if _C.axis_index(self.seq_axis) == n - 1:
            mask[:, -1] = 0.0
        total = _C.psum(torch.sum(losses * mask), self.seq_axis)
        # psum(count): every shard but the last counts all of its b·t
        loss = total / float(b * t * n - b)
        if moe:
            loss = loss + self.moe_aux_weight * _C.pmean(
                aux["moe_load_balance_loss"], self.seq_axis)
        return loss

    __call__ = apply

    # -- incremental decoding (KV cache) ---------------------------------

    @torch.no_grad()
    def _cached_blocks(self, params, x, pos0, caches):
        """The inference block stack shared by the one-token decode step
        and the chunked prompt prefill. x: [B, T, E] embedded inputs for
        absolute positions pos0..pos0+T-1; caches: ``layer_i -> (k, v)``
        each [B, H, T_max, hd]. This chunk's K/V are written IN PLACE at
        pos0 (the JAX version returns updated copies), then attention runs
        against the whole cache with absolute causal masking
        (``q_start=pos0`` hides the future and the unwritten tail).
        ``pos0`` is an int or an int64 tensor on the device, [1] (one
        start, as JAX traces it) or [B] (a start a lane: the serialized
        decode step); the tensor forms give the int form's bits and let
        one captured program serve every position. Returns (final-LN
        hidden [B, T, E], caches)."""
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        b, t, _ = x.shape
        if isinstance(pos0, torch.Tensor):
            start = pos0.reshape(-1).expand(b)                    # [B]
            lane = torch.arange(b, device=x.device)[:, None]
            win = start[:, None] + torch.arange(t, device=x.device)  # [B,T]
            q_start = start[:, None, None, None]     # mask [B, 1, T, T_max]
        for i in range(self.num_layers):
            lp = params[f"layer_{i}"]
            ap = lp["attn"]
            qkv = self._ln(x, lp["ln1"]) @ ap["in_proj"] + ap["in_proj_bias"]
            q, k, v = torch.split(qkv, e, dim=-1)              # [B, T, E]
            ck, cv = caches[f"layer_{i}"]
            if isinstance(pos0, torch.Tensor):
                ck[lane, :, win] = k.reshape(b, t, h, hd)
                cv[lane, :, win] = v.reshape(b, t, h, hd)
            else:
                q_start = pos0
                ck[:, :, pos0:pos0 + t] = k.reshape(b, t, h, hd).transpose(
                    1, 2)
                cv[:, :, pos0:pos0 + t] = v.reshape(b, t, h, hd).transpose(
                    1, 2)
            qh = q.reshape(b, t, h, hd).transpose(1, 2)
            a = reference_attention(qh, ck, cv, causal=True,
                                    q_start=q_start)
            a = a.transpose(1, 2).reshape(b, t, e) @ ap["out_proj"] \
                + ap["out_proj_bias"]
            x = x + a
            x = x + self._ffn_decode(i, lp, self._ln(x, lp["ln2"]))
        return self._ln(x, params["ln_f"]), caches

    def _decode_one(self, params, tok, pos: int, caches):
        """One-token decode step: tok int [B] at scalar position ``pos``.
        Returns (final-LN hidden [B, E], caches updated in place)."""
        x = (params["tok_emb"][tok.long()] + params["pos_emb"][pos])[:, None]
        hid, caches = self._cached_blocks(params, x, pos, caches)
        return hid[:, 0], caches

    @torch.no_grad()
    def _decode_slots(self, params, toks, pos, caches, *,
                      page_table=None, page_size: Optional[int] = None):
        """The fused slot-batched decode step, the serving engine's hot
        path: one token per slot at per-slot positions. toks, pos: int32
        [S]; caches ``layer_i -> (k, v)`` each [S, H, max_len, hd] (the
        dense arena) or, with ``page_table`` (int32 [S, max_pages]) and
        ``page_size``, page pools [P+1, H, page_size, hd] (the paged
        arena, page 0 the null sink). Per layer: one LayerNorm, one QKV
        product, the K/V write of each slot at its own position (in
        place), and attention through ``slot_decode_attention``. Returns
        (final-LN hidden [S, E], caches).

        ``toks``/``pos`` may instead be int32 [S, Q] (speculative
        scoring): Q query rows a slot at per-row positions, each row's
        K/V written before attention runs and each row masked to its own
        length (``pos + 1``), so row j sees the prefix the 1-query step
        would see after j commits. Returns ([S, Q, E], caches). Rows of a
        slot that share a position (the engine clamps positions past the
        arena's end to its last one) all write the first such row's K/V:
        ``index_put_`` leaves the order of duplicate targets undefined on
        the card, and so the bytes are the same whatever the order. No
        committed row reads such a position (transformer.py:436-441);
        the rows that do are past their request's budget."""
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        s = toks.shape[0]
        multi = toks.dim() == 2
        q_dim = toks.shape[1] if multi else 1
        paged = page_table is not None
        if paged and not page_size:
            raise ValueError("paged _decode_slots needs page_size")
        pos_l = pos.long().reshape(s, q_dim)
        x = (params["tok_emb"][toks.long().reshape(s, q_dim)]
             + params["pos_emb"][pos_l])                       # [S, Q, E]
        # each row attends its own prefix
        lengths = (pos_l + 1).to(torch.int32)
        lengths = lengths if multi else lengths[:, 0]
        if paged:
            lane = page_table.long().gather(1, pos_l // page_size)  # [S, Q]
            off = pos_l % page_size
        else:
            lane = torch.arange(s, device=pos.device)[:, None].expand(
                s, q_dim)
            off = pos_l
        first = None
        if multi:
            # for each row, the first row of its slot at the same position
            # (argmax returns the first of equal maxima)
            same = pos_l[:, :, None] == pos_l[:, None, :]          # [S,Q,Q]
            first = same.to(torch.int8).argmax(dim=-1)             # [S, Q]
            first = first[..., None].expand(s, q_dim, e)
        for i in range(self.num_layers):
            lp = params[f"layer_{i}"]
            ap = lp["attn"]
            qkv = self._ln(x, lp["ln1"]) @ ap["in_proj"] + ap["in_proj_bias"]
            q, k, v = torch.split(qkv, e, dim=-1)              # [S, Q, E]
            if first is not None:
                k, v = k.gather(1, first), v.gather(1, first)
            ck, cv = caches[f"layer_{i}"]
            # in place: one row per (slot, query row). Paged duplicates
            # across slots only ever hit the null page (retired slots),
            # which nothing reads unmasked.
            ck[lane, :, off, :] = k.reshape(s, q_dim, h, hd)
            cv[lane, :, off, :] = v.reshape(s, q_dim, h, hd)
            qh = q.reshape(s, q_dim, h, hd) if multi \
                else q.reshape(s, h, hd)
            a = slot_decode_attention(qh.contiguous(), ck, cv, lengths,
                                      page_table=page_table)
            a = a.reshape(s, q_dim, e) @ ap["out_proj"] + ap["out_proj_bias"]
            x = x + a
            x = x + self._ffn_decode(i, lp, self._ln(x, lp["ln2"]))
        out = self._ln(x, params["ln_f"])
        return (out if multi else out[:, 0]), caches

    @staticmethod
    def _filter_logits(logits, top_k, top_p):
        """The sampling filters of transformer.py:516-540: keep the
        ``top_k`` largest logits (ties at the k-th value kept) and/or the
        smallest nucleus whose probability reaches ``top_p`` (1 + the
        count of cumulative sums below it, clamped to the vocab; ties at
        the cutoff kept); everything else goes to -inf. logits fp32 [B,
        V]. The softmax is JAX's: exp(x - max) over its sum."""
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits >= kth, logits,
                                 torch.full_like(logits, -torch.inf))
        if top_p is not None:
            ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
            probs = ex / ex.sum(dim=-1, keepdim=True)
            sorted_p = torch.sort(probs, dim=-1, descending=True).values
            csum = torch.cumsum(sorted_p, dim=-1)
            n_keep = torch.clamp(
                1 + (csum < top_p).to(torch.int64).sum(dim=-1, keepdim=True),
                max=logits.shape[-1])
            cutoff = sorted_p.gather(-1, n_keep - 1)
            logits = torch.where(probs >= cutoff, logits,
                                 torch.full_like(logits, -torch.inf))
        return logits

    @torch.no_grad()
    def _prefill(self, params, prompt, total: int):
        """Batched prompt prefill: one causal pass over the prompt through
        ``_cached_blocks``, filling fresh caches sized to ``total``.
        Returns the final-LN hidden state of the last prompt position and
        the caches."""
        b, p = prompt.shape
        h = self.num_heads
        ref = params["tok_emb"]          # caches follow the param dtype
        caches = {f"layer_{i}": tuple(
                      torch.zeros((b, h, total, self.embed_dim // h),
                                  dtype=ref.dtype, device=ref.device)
                      for _ in range(2))
                  for i in range(self.num_layers)}
        x = params["tok_emb"][prompt.long()] + params["pos_emb"][:p]
        hid, caches = self._cached_blocks(params, x, 0, caches)
        return hid[:, -1], caches

    @torch.no_grad()
    def generate(self, params: dict, prompt, *, max_new_tokens: int,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 key: Optional[int] = None) -> torch.Tensor:
        """Autoregressive generation with per-layer K/V caches (the JAX
        version's, transformer.py:561-655). prompt: int [B, P]. Returns
        int32 [B, P + max_new_tokens]. ``temperature=0`` is greedy;
        ``temperature>0`` samples, ``key`` required: the seed of the
        counter stream, draw t of row b keyed ``(key, b, t)`` with t the
        position whose hidden state gives the token (JAX folds t into its
        key), so a run replays under the same key. ``top_k``/``top_p``
        restrict the draw to the k most likely tokens / the smallest
        nucleus with mass >= top_p (ignored when greedy). With ``eos_id`` a
        sequence that emits it keeps emitting it (the output stays
        rectangular). Single-device only (``seq_axis`` None); MoE layers
        decode capacity-free, so generation matches the training forward
        wherever apply()'s capacity does not bind."""
        if self.seq_axis is not None:
            raise NotImplementedError(
                "generate() decodes against a local KV cache; run it "
                "outside sequence parallelism (seq_axis=None)")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {temperature}")
        if temperature > 0.0 and key is None:
            # the key is the counter stream's seed
            raise ValueError("temperature > 0 requires a PRNG key")
        if top_k is not None and not 0 < top_k <= self.vocab_size:
            raise ValueError(f"top_k must be in [1, vocab_size], "
                             f"got {top_k}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if eos_id is not None and not 0 <= eos_id < self.vocab_size:
            raise ValueError(f"eos_id must be in [0, vocab_size), "
                             f"got {eos_id}")
        dev = params["tok_emb"].device
        prompt = torch.as_tensor(prompt).to(dev, torch.int32)
        b, p = prompt.shape
        total = p + max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt ({p}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len ({self.max_seq_len})")
        buf = torch.zeros((b, total), dtype=torch.int32, device=dev)
        buf[:, :p] = prompt
        rows = torch.arange(b, dtype=torch.int64, device=dev)

        def produce(t: int, hid):
            logits = (hid @ params["tok_emb"].T).float()
            if temperature > 0.0:
                filt = self._filter_logits(logits / temperature, top_k,
                                           top_p)
                u = stream_uniforms(int(key), rows, torch.full_like(rows, t),
                                    self.vocab_size)
                return gumbel_argmax(filt, u)
            return torch.argmax(logits, dim=-1).to(torch.int32)

        hid, caches = self._prefill(params, prompt, total)
        tok = produce(p - 1, hid)
        done = (tok == eos_id) if eos_id is not None else None
        buf[:, p] = tok
        for t in range(p, total - 1):
            hid, caches = self._decode_one(params, buf[:, t], t, caches)
            tok = produce(t, hid)
            if eos_id is not None:
                tok = torch.where(done, torch.full_like(tok, eos_id), tok)
                done = done | (tok == eos_id)
            buf[:, t + 1] = tok
        return buf


def _layer_seeds(seeds, n: int) -> list:
    """``n`` per-call dropout seeds (ints), or ``n`` Nones without any."""
    if seeds is None:
        return [None] * n
    seeds = [int(x) for x in seeds]
    if len(seeds) != n:
        raise ValueError(f"dropout_seeds: expected {n} seeds, got "
                         f"{len(seeds)}")
    return seeds


def _tree_to(tree, device, dtype):
    """Move a nested dict of tensors to ``device``, floats cast to
    ``dtype``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)
