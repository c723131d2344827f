"""Seq2Seq Transformer — counterpart of ``apex_tpu/models/seq2seq.py``:
the pre-LN encoder-decoder that ``EncdecMultiheadAttn`` exists for.

- The encoder runs non-causal ``SelfMultiheadAttn`` over the source with a
  key-padding mask (positions equal to ``pad_id``).
- The decoder interleaves causal ``SelfMultiheadAttn`` with
  ``EncdecMultiheadAttn`` cross-attention into the encoder memory, masked
  by the same source padding.
- The loss is teacher-forced next-token cross entropy over the non-pad
  target positions through ``SoftmaxCrossEntropyLoss`` (label smoothing,
  ``padding_idx=pad_id``).

Ported: the config (the JAX class's defaults are Transformer-base: 6 + 6
layers, width 512, 8 heads, FFN 2048), ``init`` (the JAX names and
shapes, drawn from a ``torch.Generator``), ``encode``, ``decode``,
``apply`` and ``loss`` under autograd with attention dropout, and greedy
decoding: ``_cross_kv``, ``_decode_one``, ``_self_caches``,
``_src_bias``, ``_resolve_max_len`` and ``greedy_decode``, a host loop
over ``_decode_one`` whose attention core is ``reference_attention``, as
in the JAX package (a one-row query has no use for the flash kernels);
``remat`` and ``remat_policy`` rematerialize each encoder and decoder
layer (``models/_remat.py``). ``beam_decode`` is not ported yet and
raises.

Every LayerNorm goes through ``normalization.fused_layer_norm_affine``
(the LayerNorm kernels on the card), the training attention through the
modules with ``attn_impl`` ("fast": the flash kernels with ``kv_bias``),
and the loss through the softmax cross-entropy kernels. The projections
and the head are ``torch.matmul``, as they were plain XLA dots there.
Parameters keep the JAX layout, weights ``[in, out]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib.multihead_attn.flash_attention import (
    NEG_INF, reference_attention)
from apex_tpu_torch.contrib.multihead_attn.modules import (
    EncdecMultiheadAttn, SelfMultiheadAttn)
from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss
from apex_tpu_torch.models import _remat
from apex_tpu_torch.models.transformer import (_gelu, _layer_seeds,
                                                _tree_to)
from apex_tpu_torch.normalization import fused_layer_norm_affine

__all__ = ["Seq2SeqTransformer"]


@dataclasses.dataclass(frozen=True)
class Seq2SeqTransformer:
    src_vocab_size: int
    tgt_vocab_size: int
    max_seq_len: int = 512
    embed_dim: int = 512
    num_heads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    ffn_mult: int = 4
    dropout: float = 0.0
    attn_impl: str = "auto"
    pad_id: int = 0          # padding token id in both vocabs
    remat: bool = False
    remat_policy: Optional[str] = None
    # where init() puts the parameters; None means the card
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        _remat.validate_remat_config(self.remat, self.remat_policy)
        self._self_attn(causal=False)        # validates widths and impl
        object.__setattr__(self, "device", resolve_device(self.device))

    def _self_attn(self, causal: bool) -> SelfMultiheadAttn:
        return SelfMultiheadAttn(self.embed_dim, self.num_heads, bias=True,
                                 causal=causal, dropout=self.dropout,
                                 impl=self.attn_impl)

    def _cross_attn(self) -> EncdecMultiheadAttn:
        return EncdecMultiheadAttn(self.embed_dim, self.num_heads,
                                   bias=True, dropout=self.dropout,
                                   impl=self.attn_impl)

    def init(self, generator: Union[torch.Generator, int] = 0, *,
             dtype: torch.dtype = torch.float32) -> dict:
        """Random parameters with the JAX names and shapes, drawn on the
        CPU from ``generator`` (a ``torch.Generator`` or a seed) and moved
        to ``self.device`` in ``dtype``. The draws differ from
        ``jax.random``'s; to hold the two packages on the same weights,
        convert the JAX tree with ``convert.params_from_jax``."""
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        e, f = self.embed_dim, self.ffn_mult * self.embed_dim

        def normal(*shape):
            return torch.randn(shape, generator=generator) * 0.02

        def ln():
            return {"g": torch.ones(e), "b": torch.zeros(e)}

        def mlp():
            return {"w1": normal(e, f), "b1": torch.zeros(f),
                    "w2": normal(f, e), "b2": torch.zeros(e)}

        p = {"src_emb": normal(self.src_vocab_size, e),
             "tgt_emb": normal(self.tgt_vocab_size, e),
             "pos_emb": normal(self.max_seq_len, e),
             "ln_enc": ln(), "ln_dec": ln()}
        enc_sa = self._self_attn(causal=False)
        for i in range(self.num_encoder_layers):
            p[f"enc_{i}"] = {"ln1": ln(), "attn": enc_sa.init(generator),
                             "ln2": ln(), "mlp": mlp()}
        dec_sa, dec_ca = self._self_attn(causal=True), self._cross_attn()
        for i in range(self.num_decoder_layers):
            p[f"dec_{i}"] = {"ln1": ln(),
                             "self_attn": dec_sa.init(generator),
                             "ln2": ln(),
                             "cross_attn": dec_ca.init(generator),
                             "ln3": ln(), "mlp": mlp()}
        return _tree_to(p, self.device, dtype)

    def _ln(self, x, lnp):
        return fused_layer_norm_affine(x, (self.embed_dim,), lnp["g"],
                                       lnp["b"], 1e-5)

    def _mlp(self, x, mp):
        h = _gelu(x @ mp["w1"] + mp["b1"])
        return h @ mp["w2"] + mp["b2"]

    def _embed(self, emb, tokens, params):
        t = tokens.shape[1]
        if t > self.max_seq_len:
            raise ValueError(
                f"sequence length {t} exceeds max_seq_len="
                f"{self.max_seq_len}; raise max_seq_len at construction")
        # F.embedding: its backward sums the rows in a fixed order
        return F.embedding(tokens.to(emb.device, torch.long), emb) \
            + params["pos_emb"][:t]

    @property
    def num_dropout_seeds(self) -> int:
        """Seeds a training call takes: one an encoder layer, then two a
        decoder layer (self- and cross-attention)."""
        return self.num_encoder_layers + 2 * self.num_decoder_layers

    def encode(self, params: dict, src_tokens: torch.Tensor, *,
               is_training: bool = False,
               dropout_seeds=None) -> torch.Tensor:
        """src_tokens int [B, Ts] -> encoder memory [B, Ts, E]. Positions
        equal to ``pad_id`` are masked out of every attention (theirs and
        the decoder's cross-attention reads). In training,
        ``dropout_seeds`` holds one int an encoder layer (JAX folds the
        layer index into its key, seq2seq.py:149-150)."""
        seeds = _layer_seeds(dropout_seeds, self.num_encoder_layers)
        src_tokens = src_tokens.to(params["src_emb"].device)
        pad = src_tokens == self.pad_id
        x = self._embed(params["src_emb"], src_tokens, params)
        sa = self._self_attn(causal=False)

        def body(x, lp, seed):
            h = self._ln(x, lp["ln1"]).transpose(0, 1)
            a, _ = sa.apply(lp["attn"], h, key_padding_mask=pad,
                            is_training=is_training, dropout_seed=seed)
            x = x + a.transpose(0, 1)
            return x + self._mlp(self._ln(x, lp["ln2"]), lp["mlp"])

        if self.remat:
            body = _remat.remat(body, self.remat_policy)
        for i in range(self.num_encoder_layers):
            x = body(x, params[f"enc_{i}"], seeds[i])
        return self._ln(x, params["ln_enc"])

    def decode(self, params: dict, tgt_tokens: torch.Tensor,
               memory: torch.Tensor, src_tokens: torch.Tensor, *,
               is_training: bool = False,
               dropout_seeds=None) -> torch.Tensor:
        """tgt_tokens int [B, Tt]; memory [B, Ts, E] from :meth:`encode`.
        Returns fp32 logits [B, Tt, tgt_vocab]. In training,
        ``dropout_seeds`` holds two ints a decoder layer, its self- and its
        cross-attention's (JAX folds 0 and 1 into the layer's key,
        seq2seq.py:166-185)."""
        seeds = _layer_seeds(dropout_seeds, 2 * self.num_decoder_layers)
        src_pad = src_tokens.to(memory.device) == self.pad_id
        x = self._embed(params["tgt_emb"], tgt_tokens, params)
        sa, ca = self._self_attn(causal=True), self._cross_attn()
        mem_tm = memory.transpose(0, 1)           # [Ts, B, E] time-major

        def body(x, lp, mem_tm, self_seed, cross_seed):
            a, _ = sa.apply(lp["self_attn"],
                            self._ln(x, lp["ln1"]).transpose(0, 1),
                            is_training=is_training, dropout_seed=self_seed)
            x = x + a.transpose(0, 1)
            a, _ = ca.apply(lp["cross_attn"],
                            self._ln(x, lp["ln2"]).transpose(0, 1), mem_tm,
                            key_padding_mask=src_pad,
                            is_training=is_training, dropout_seed=cross_seed)
            x = x + a.transpose(0, 1)
            return x + self._mlp(self._ln(x, lp["ln3"]), lp["mlp"])

        if self.remat:
            body = _remat.remat(body, self.remat_policy)
        for i in range(self.num_decoder_layers):
            x = body(x, params[f"dec_{i}"], mem_tm, seeds[2 * i],
                     seeds[2 * i + 1])
        x = self._ln(x, params["ln_dec"])
        return (x @ params["tgt_emb"].T).float()

    def apply(self, params: dict, src_tokens: torch.Tensor,
              tgt_tokens: torch.Tensor, *, is_training: bool = False,
              dropout_seeds=None) -> torch.Tensor:
        """fp32 logits [B, Tt, tgt_vocab]; differentiable in ``params``.
        ``dropout_seeds``: ``num_dropout_seeds`` ints, the encoder's, then
        the decoder's (JAX's fold order: encoder layer i folds i, decoder
        layer i folds ``num_encoder_layers + i``)."""
        seeds = _layer_seeds(dropout_seeds, self.num_dropout_seeds)
        n = self.num_encoder_layers
        enc = None if dropout_seeds is None else seeds[:n]
        dec = None if dropout_seeds is None else seeds[n:]
        mem = self.encode(params, src_tokens, is_training=is_training,
                          dropout_seeds=enc)
        return self.decode(params, tgt_tokens, mem, src_tokens,
                           is_training=is_training, dropout_seeds=dec)

    __call__ = apply

    def loss(self, params: dict, src_tokens: torch.Tensor,
             tgt_tokens: torch.Tensor, *, is_training: bool = True,
             dropout_seeds=None,
             label_smoothing: float = 0.0) -> torch.Tensor:
        """Teacher-forced next-token cross entropy over the non-pad target
        positions: the decoder reads ``tgt_tokens[:, :-1]`` and predicts
        ``tgt_tokens[:, 1:]``, with ``label_smoothing`` and the pad rows
        skipped (seq2seq.py:205-222); ``dropout_seeds`` as for
        :meth:`apply`."""
        logits = self.apply(params, src_tokens, tgt_tokens[:, :-1],
                            is_training=is_training,
                            dropout_seeds=dropout_seeds)
        targets = tgt_tokens[:, 1:].to(logits.device).reshape(-1)
        losses = SoftmaxCrossEntropyLoss.apply(
            logits.reshape(-1, self.tgt_vocab_size), targets,
            smoothing=label_smoothing, padding_idx=self.pad_id)
        n = torch.clamp((targets != self.pad_id).float().sum(), min=1.0)
        return torch.sum(losses) / n

    # -- incremental decoding (KV caches) --------------------------------

    def _cross_kv(self, params, memory):
        """Per-layer cross-attention K/V of the encoder memory, computed
        once a decode: ``dec_i -> (k, v)``, each [B, H, Ts, hd]."""
        h = self.num_heads
        hd = self.embed_dim // h
        out = {}
        for i in range(self.num_decoder_layers):
            cp = params[f"dec_{i}"]["cross_attn"]
            kv = memory @ cp["kv_proj"] + cp["kv_proj_bias"]
            k, v = torch.split(kv, self.embed_dim, dim=-1)    # [B, Ts, E]
            out[f"dec_{i}"] = tuple(
                t.reshape(*t.shape[:2], h, hd).transpose(1, 2)
                for t in (k, v))
        return out

    def _decode_one(self, params, tok, pos: int, self_caches, cross_kv,
                    src_bias):
        """One-token decoder step: tok int [B] at position ``pos``, cached
        causal self-attention (this step's K/V written in place at
        ``pos``; the JAX version returns updated copies) and
        cross-attention into the precomputed memory K/V, masked by
        ``src_bias`` [B, 1, Ts]. Returns (logits [B, V] fp32, caches)."""
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        x = params["tgt_emb"][tok.long()] + params["pos_emb"][pos]  # [B, E]
        for i in range(self.num_decoder_layers):
            lp = params[f"dec_{i}"]
            sp = lp["self_attn"]
            qkv = self._ln(x, lp["ln1"]) @ sp["in_proj"] + sp["in_proj_bias"]
            q, k, v = torch.split(qkv, e, dim=-1)
            ck, cv = self_caches[f"dec_{i}"]
            ck[:, :, pos] = k.reshape(-1, h, hd)
            cv[:, :, pos] = v.reshape(-1, h, hd)
            a = reference_attention(q.reshape(-1, h, 1, hd), ck, cv,
                                    causal=True, q_start=pos)
            x = x + (a[:, :, 0, :].reshape(-1, e) @ sp["out_proj"]
                     + sp["out_proj_bias"])
            cp = lp["cross_attn"]
            q = self._ln(x, lp["ln2"]) @ cp["q_proj"] + cp["q_proj_bias"]
            mk, mv = cross_kv[f"dec_{i}"]
            a = reference_attention(q.reshape(-1, h, 1, hd), mk, mv,
                                    kv_bias=src_bias)
            x = x + (a[:, :, 0, :].reshape(-1, e) @ cp["out_proj"]
                     + cp["out_proj_bias"])
            x = x + self._mlp(self._ln(x, lp["ln3"]), lp["mlp"])
        x = self._ln(x, params["ln_dec"])
        return (x @ params["tgt_emb"].T).float(), self_caches

    def _self_caches(self, b: int, max_len: int, dtype, device):
        h = self.num_heads
        hd = self.embed_dim // h
        return {f"dec_{i}": tuple(
                    torch.zeros((b, h, max_len, hd), dtype=dtype,
                                device=device) for _ in range(2))
                for i in range(self.num_decoder_layers)}

    def _src_bias(self, src_tokens):
        """[B, 1, Ts] fp32 additive bias masking the padded source keys
        (the key_padding_mask semantics of the module path)."""
        return torch.where(src_tokens == self.pad_id, NEG_INF,
                           0.0).float()[:, None, :]

    def _resolve_max_len(self, max_len: Optional[int]) -> int:
        if max_len is None:
            return self.max_seq_len
        if not 0 < max_len <= self.max_seq_len:
            raise ValueError(
                f"max_len ({max_len}) must be in [1, max_seq_len="
                f"{self.max_seq_len}]")
        return max_len

    @torch.no_grad()
    def greedy_decode(self, params: dict, src_tokens, *, bos_id: int,
                      eos_id: int,
                      max_len: Optional[int] = None) -> torch.Tensor:
        """Greedy decoding into a fixed [B, max_len] int32 buffer: BOS,
        then one ``_decode_one`` step a position against the self K/V
        caches and one precomputed cross K/V of the encoder memory; the
        positions after a row's EOS hold ``pad_id``."""
        max_len = self._resolve_max_len(max_len)
        dev = params["tgt_emb"].device
        src_tokens = torch.as_tensor(src_tokens).to(dev)
        b = src_tokens.shape[0]
        mem = self.encode(params, src_tokens)
        cross = self._cross_kv(params, mem)
        bias = self._src_bias(src_tokens)
        caches = self._self_caches(b, max_len, params["tgt_emb"].dtype, dev)
        out = torch.full((b, max_len), self.pad_id, dtype=torch.int32,
                         device=dev)
        out[:, 0] = bos_id
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        for i in range(1, max_len):
            logits, caches = self._decode_one(params, out[:, i - 1], i - 1,
                                              caches, cross, bias)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, self.pad_id), nxt)
            out[:, i] = nxt
            done = done | (nxt == eos_id)
        return out

    def beam_decode(self, params: dict, src_tokens, *, bos_id: int,
                    eos_id: int, beam_width: int = 4,
                    max_len: Optional[int] = None):
        raise NotImplementedError(
            "beam_decode is not ported yet (ROADMAP.md Queue 1, item 21)")
