"""Continuous-batching engine — counterpart of ``apex_tpu/serve/engine.py``,
fused and serialized, dense and paged, with speculative decoding and the
shared-prefix page cache.

The device work per scheduler poll and step is the JAX engine's programs,
each a :class:`~apex_tpu_torch.serve.programs.DeviceProgram`: on the card a
CUDA graph captured at its first call (or by :meth:`warmup`) and replayed
after, the counterpart of a jitted, donated XLA program; on the CPU the
body run eagerly. Each body reads its host inputs from a fixed input block
(ONE host->device copy a call) and updates the engine's state in place.

1. ``prefill`` — one ``TransformerLM._cached_blocks`` pass over one prompt
   chunk for all the requests admitted in this poll: their lanes are
   gathered out of the arena (by slot, or by page-table row), run as one
   batch at the chunk's start ``pos0`` (a device scalar, as JAX traces
   it), and every lane's window is stored back, the lanes without a chunk
   at this depth writing back what they gathered (paged: into the one
   page that holds the chunk, taken from ``pos0`` on the device). A
   speculative engine runs its draft model's chunk right behind
   (``draft_prefill``), into the draft's arena.
2. ``commit`` — every admitted lane's first token from its final chunk's
   hidden state, sampled, and the slots armed through a valid mask; ONE
   device->host fetch per admission batch, the TTFT point.
3. ``decode`` — ONE step for all slots through
   ``TransformerLM._decode_slots`` (the LayerNorm and decode attention
   kernels on the card), then sampling and EOS/budget retirement on the
   device; ONE fetch per step, the packed ``[3, S]`` array. With
   ``spec_k`` it is the speculative step instead (below), its fetch the
   packed ``[k + 4, S]`` array.

Where the JAX engine donates its state to each program and rebinds the
result, this engine allocates the pool once and updates it IN PLACE;
``run`` resets it in place at its start, so every run starts from a fresh
pool and the captured graphs keep their addresses. Prefill and commit run
at the full pool width, the admitted lanes first and the other slots as
masked padding lanes (the JAX engine's width-``slots`` program; JAX also
compiles a ladder of narrower widths, the port has the one width). A
lane's arithmetic then never depends on how many requests share its poll:
cuBLAS picks its kernel, and with it the summation order, by the
product's shape, so a variable width would make greedy streams depend on
arrival timing on the card.

``fused=False`` is the JAX engine's serialized r13 path, dense only: one
request admitted at a time (the same prefill and commit bodies at width
1, the slot a device scalar), and a decode step of every slot at its own
position through ``_cached_blocks`` (plain attention, the LayerNorm
kernel), one admission per decode step under the continuous policy. It
is the parity oracle of the fused engine.

The host scheduler is the JAX one: Poisson-arrived requests go queued ->
admitted -> retired, freed slots are reused at once (``continuous``) or
only after the pool drains (``static``), and TTFT and per-token times are
stamped at the host syncs. The paged arena keeps a host page table
(``np.int32 [slots, max_pages]``) mutated in place at admission and
retirement, copied to the device once per program call and never read
back; admission is gated on free pages. ``prefix_share=True`` maps the
content-hashed pages of a cached prompt prefix (``serve/prefix.py``) into
a new request's table and skips the prefill chunks they cover.

Speculative decoding (``spec_k=k``, ``draft=(model, params)``): k draft
steps (the first a 2-query catch-up row over ``[pos - 1, pos]``), then
ONE (k+1)-row target forward through the multi-row decode kernel, and
acceptance on the device: greedy takes the longest draft prefix matching
the target's argmax chain, so the emitted tokens ARE the greedy stream;
above temperature 0 standard rejection sampling (:func:`spec_accept`).
The draft's KV is a second dense arena, or a parallel page pool behind the
same page table.

Sampling at ``temperature > 0`` draws from a counter-based stream keyed by
``(seed, request id, token index)`` and computed on the device
(:func:`stream_uniforms`); the speculative draws fold a role and a draft
row into the request key (``_stream.fold_key``), where JAX folds them into
its threefry key. Tokens do not depend on the slot or on how admissions
were batched. JAX's threefry keys cannot be reproduced in torch: only
replay determinism is shared with the JAX engine, and equality across
packages holds for greedy decoding.

``run`` also takes a feed (``serve.router.RouterFeed``: externally fed
admission), an external epoch ``t0``, an ``on_retire`` callback, and the
``tracer``, ``slo`` and ``live`` observation hooks of ``prof/`` (the
router tier's seams). Not ported yet, each refused with
``NotImplementedError`` naming its ROADMAP row: ``run``'s ``telemetry``
and ``flightrec`` hooks, and ``lint_programs``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._stream import fold_key, gumbel_argmax, stream_uniforms
from apex_tpu_torch.contrib.multihead_attn.decode_attention import (
    gather_pages)
from apex_tpu_torch.ops.decode_attn import MAX_ROWS
from apex_tpu_torch.serve.prefix import PrefixCache, chain_hashes
from apex_tpu_torch.serve.programs import DeviceProgram, Inputs, new_pool
from apex_tpu_torch.serve.slots import (PagePool, SlotState, arena_bytes,
                                        init_cache_arena, init_paged_state,
                                        init_slot_state, kv_token_bytes)

__all__ = ["Request", "RequestResult", "ContinuousBatchingEngine",
           "draft_from_prefix", "spec_accept", "stream_uniforms"]

_POLICIES = ("continuous", "static")
_TRACE_ROW = "ROADMAP.md Queue 1, slice 8"
_LINT_ROW = "ROADMAP.md Queue 1, item 24"


def draft_from_prefix(model, params, num_layers: int):
    """A zero-training draft model for speculative decoding: the first
    ``num_layers`` blocks of ``model`` reused as they are (embeddings and
    final LN shared, layer params aliased: no copies). Returns
    ``(draft_model, draft_params)`` for ``ContinuousBatchingEngine(draft=
    ..., spec_k=...)``."""
    if not 1 <= num_layers <= model.num_layers:
        raise ValueError(
            f"draft num_layers must be in [1, {model.num_layers}], "
            f"got {num_layers}")
    dm = dataclasses.replace(model, num_layers=num_layers)
    dp = {"tok_emb": params["tok_emb"], "pos_emb": params["pos_emb"],
          "ln_f": params["ln_f"]}
    for i in range(num_layers):
        dp[f"layer_{i}"] = params[f"layer_{i}"]
    return dm, dp


def spec_accept(toks: torch.Tensor, logits: torch.Tensor,
                temperature: float, *, qsel=None, qdists=None, u=None,
                u_extra=None):
    """The speculative step's acceptance (engine.py:645-684). ``toks``
    int32 [S, k+1]: the pending token, then the k drafts; ``logits`` fp32
    [S, k+1, V]: the target's rows over them. Returns (``out`` int32 [S,
    k+1], the tokens to emit in order; ``n_acc`` int32 [S], the drafts
    accepted).

    Greedy: ``out`` is the target's argmax chain and ``n_acc`` the length
    of the draft prefix that matches it. At ``temperature > 0``: draft j
    is accepted while ``u_j q(d_j) < p(d_j)`` (``qsel`` [S, k] the drafts'
    own probabilities, ``u`` [S, k] uniforms); the first rejected row
    draws from the residual ``max(p - q, 0)`` (``qdists`` [S, k, V]), or
    all accepted, the target's last row (the bonus draw), with the
    uniforms ``u_extra`` [S, V]. The emitted tokens are then distributed
    as the target's samples."""
    k = toks.shape[1] - 1
    cols = torch.arange(k + 1, device=toks.device)
    if temperature > 0.0:
        pfull = torch.softmax(logits / temperature, dim=-1)
        pd = pfull[:, :-1].gather(2, toks[:, 1:, None].long())[:, :, 0]
        acc = (u * qsel) < pd
        n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
        v = logits.shape[-1]
        p_row = pfull.gather(
            1, n_acc.long()[:, None, None].expand(-1, 1, v))[:, 0]
        q_row = qdists.gather(1, torch.clamp(n_acc, max=k - 1).long()
                              [:, None, None].expand(-1, 1, v))[:, 0]
        resid = torch.clamp(p_row - q_row, min=0.0)
        rs = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(rs > 0.0, resid / rs, p_row)
        dist = torch.where((n_acc < k)[:, None], resid, p_row)
        extra = gumbel_argmax(torch.log(dist + 1e-30), u_extra)
        shifted = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])],
                            dim=1)
        out = torch.where(cols[None, :] < n_acc[:, None], shifted,
                          extra[:, None])
    else:
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        match = (toks[:, 1:] == out[:, :-1]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)
    return out.to(torch.int32), n_acc.to(torch.int32)


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_s`` is relative to run start;
    the scheduler will not admit a request before its arrival time.
    ``session``/``trace``/``hop`` are the router's affinity key and trace
    context: the router reads ``session``, the ``request`` span carries
    ``trace`` and ``hop``."""
    id: int
    prompt: np.ndarray            # int32 [P], 1 <= P
    max_new: int                  # generation budget (includes any EOS)
    arrival_s: float = 0.0
    session: Optional[int] = None
    trace: Optional[str] = None
    hop: int = 0


@dataclasses.dataclass
class RequestResult:
    """Per-request outcome + latency provenance (all times in seconds
    relative to run start, stamped at host sync points)."""
    id: int
    prompt_len: int
    arrival_s: float
    slot: Optional[int] = None
    generation: Optional[int] = None   # the slot lease this request held
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    tokens: list = dataclasses.field(default_factory=list)
    token_times: list = dataclasses.field(default_factory=list)
    prefix_tokens: int = 0             # prompt tokens from a prefix cache

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, queue wait included."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def token_lat_s(self) -> Optional[float]:
        """Normalized per-token latency, arrival-inclusive: (finish -
        arrival) / tokens_out."""
        if self.finish_s is None or not self.tokens:
            return None
        return (self.finish_s - self.arrival_s) / len(self.tokens)

    @property
    def itl_s(self) -> list:
        """Inter-token latencies (gaps between consecutive emissions,
        TTFT excluded)."""
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]


class ContinuousBatchingEngine:
    """Serving engine over a :class:`~apex_tpu_torch.serve.slots.SlotState`
    pool on ``device`` (the card unless ``device="cpu"``); ``params`` must
    live there. ``run`` is reusable: every call starts from a fresh pool
    (the engine's one pool, reset in place). Call :meth:`warmup` before a
    timed run: on the card it captures every program, which a run would
    otherwise do at first use, inside its TTFT.

    ``policy='continuous'`` admits into any freed slot between decode
    steps; ``policy='static'`` only admits when the pool has drained.
    ``paged=True`` swaps the dense ``[slots, H, max_len, hd]`` arena for a
    global page pool of ``kv_pages`` pages of ``page_size`` positions;
    a request reserves only the pages its prompt and budget need. Greedy
    paged streams equal the dense ones token for token.
    ``prefix_share=True`` (paged only) prefills a common prompt prefix
    once and maps its full pages into every matching request's table.
    ``spec_k`` with ``draft=(model, params)`` decodes speculatively;
    greedy speculative streams equal the plain ones token for token.
    ``fused=False`` serializes admission (dense only): its greedy streams
    equal the fused engine's."""

    def __init__(self, model, params, *, slots: int, max_len: int,
                 prefill_chunk: int = 16, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 policy: str = "continuous", fused: bool = True,
                 paged: bool = False,
                 page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 prefix_share: bool = False,
                 draft=None, spec_k: int = 0, device=None):
        self.device = resolve_device(device)
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, "
                             f"got {policy!r}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {temperature}")
        if eos_id is not None and not 0 <= eos_id < model.vocab_size:
            raise ValueError(f"eos_id must be in [0, vocab_size), "
                             f"got {eos_id}")
        if prefill_chunk < 1 or prefill_chunk > max_len:
            raise ValueError(f"prefill_chunk must be in [1, max_len], "
                             f"got {prefill_chunk}")
        if prefix_share and not paged:
            raise ValueError("prefix_share needs paged=True — sharing "
                             "is a page-table mapping, the dense arena "
                             "has nothing to map")
        self.model = model
        self.params = params
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.policy = policy
        self.paged = bool(paged)
        self.prefix_share = bool(prefix_share)
        if self.paged:
            if not fused:
                raise ValueError(
                    "paged=True requires the fused engine — the "
                    "serialized r13 path stays on the dense arena as "
                    "the parity oracle")
            ps = (int(page_size) if page_size is not None
                  else self.prefill_chunk)
            if ps % self.prefill_chunk != 0:
                raise ValueError(
                    f"page_size ({ps}) must be a multiple of "
                    f"prefill_chunk ({self.prefill_chunk}) — a prefill "
                    f"chunk must land inside ONE page so the chunked "
                    f"write-through stays a single-page scatter")
            if self.max_len % ps != 0:
                raise ValueError(
                    f"page_size ({ps}) must divide max_len "
                    f"({self.max_len})")
            self.page_size = ps
            self.max_pages = self.max_len // ps
            self.kv_pages = (int(kv_pages) if kv_pages is not None
                             else self.slots * self.max_pages)
            if self.kv_pages < self.max_pages:
                raise ValueError(
                    f"kv_pages ({self.kv_pages}) cannot hold one "
                    f"worst-case request ({self.max_pages} pages)")
        else:
            if page_size is not None or kv_pages is not None:
                raise ValueError("page_size/kv_pages need paged=True")
            self.page_size = self.max_pages = self.kv_pages = None
        # speculative decoding: spec_k drafts a step, scored by the target
        # in one (k+1)-row forward
        if spec_k:
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if draft is None:
                raise ValueError(
                    "spec_k needs draft=(draft_model, draft_params) — "
                    "speculation has nothing to propose without one")
            if not fused:
                raise ValueError(
                    "speculative decoding needs fused=True — the spec "
                    "step extends _decode_slots' query dim; the "
                    "serialized r13 path stays the parity oracle")
        elif draft is not None:
            raise ValueError("draft needs spec_k >= 1")
        self.fused = bool(fused)
        self.spec_k = int(spec_k)
        if spec_k + 1 > MAX_ROWS:
            raise ValueError(
                f"spec_k ({spec_k}) + 1 rows pass the decode kernel's "
                f"{MAX_ROWS} query rows a slot")
        self.draft_model = self.draft_params = None
        if draft is not None:
            dmodel, dparams = draft
            if dmodel.vocab_size != model.vocab_size:
                raise ValueError(
                    f"draft vocab_size ({dmodel.vocab_size}) must "
                    f"match the target ({model.vocab_size})")
            if dmodel.max_seq_len < max_len:
                raise ValueError(
                    f"draft max_seq_len ({dmodel.max_seq_len}) cannot "
                    f"cover the pool max_len ({max_len})")
            if dparams["tok_emb"].device != self.device:
                raise ValueError(
                    f"draft params live on {dparams['tok_emb'].device}, "
                    f"the engine on {self.device}")
            self.draft_model, self.draft_params = dmodel, dparams
        if params["tok_emb"].device != self.device:
            raise ValueError(
                f"params live on {params['tok_emb'].device}, the engine "
                f"on {self.device}")
        self.events: list = []
        self._hid_dtype = params["tok_emb"].dtype
        # the pool and every buffer a program reads live at fixed
        # addresses for the engine's life (validates slots/max_len)
        self._state = self._init_state()
        self._dcaches = self._init_draft_caches() if self.spec_k else None
        self._dprev = (torch.zeros((self.slots,), dtype=torch.int32,
                                   device=self.device)
                       if self.spec_k else None)
        self._build_programs()

    # -- the device programs -----------------------------------------------

    def _sample(self, logits: torch.Tensor, keys: torch.Tensor,
                tok_idx: torch.Tensor) -> torch.Tensor:
        """One token per row of fp32 logits [n, V]: argmax when greedy,
        else a temperature-scaled gumbel argmax over the rows' counter
        streams (the same categorical the JAX engine draws)."""
        if self.temperature > 0.0:
            u = stream_uniforms(self.seed, keys, tok_idx, logits.shape[-1])
            return gumbel_argmax(logits / self.temperature, u)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _lanes(self, caches: dict, index: torch.Tensor) -> dict:
        """The lanes of ``index`` gathered out of an arena: slot ids
        (dense) or page-table rows (paged, each lane's logical view)."""
        if self.paged:
            return {n: (gather_pages(k, index), gather_pages(v, index))
                    for n, (k, v) in caches.items()}
        return {n: (k[index], v[index]) for n, (k, v) in caches.items()}

    @torch.no_grad()
    def _prefill_write(self, model, params, caches, ins: dict):
        """Run one chunk of ``model`` over the gathered lanes ``ins["index"]``
        (slot ids [w], or page-table rows [w, max_pages]: the chunk lands
        in ONE page, page_size % prefill_chunk == 0) at ``ins["pos0"]``
        ([1] on the device) and store each lane's chunk window back: the
        valid lanes' new K/V, the others what they gathered. The pool is
        not written between the gather and the store, so lanes that map
        one page (the null page, a shared prefix page) all store the same
        bytes; a valid lane's page is private to it. Returns the hidden
        states [w, C, E]."""
        c = self.prefill_chunk
        tok, index, pos0 = ins["tok"], ins["index"], ins["pos0"]
        ar = torch.arange(c, device=tok.device)
        win = pos0 + ar                       # the chunk's positions [C]
        x = params["tok_emb"][tok] + params["pos_emb"][win]
        lanes = self._lanes(caches, index)
        hid, lanes = model._cached_blocks(params, x, pos0, lanes)
        if self.paged:
            pg = pos0 // self.page_size                            # [1]
            dst = index.long().gather(1, pg.expand(index.shape[0], 1))
            off = pos0 - pg * self.page_size + ar
        else:
            dst, off = index[:, None], win
        keep = ins["valid"][:, None, None, None]
        for name, (k, v) in caches.items():
            for pool, lane in zip((k, v), lanes[name]):
                new = lane[:, :, win].transpose(1, 2)       # [w, C, H, hd]
                pool[dst, :, off] = torch.where(keep, new, pool[dst, :, off])
        return hid

    @torch.no_grad()
    def _prefill(self) -> None:
        """The ``prefill`` program: one prompt chunk for the lanes of its
        inputs; each lane's final-chunk hidden states carried in ``_fh``
        [w, C, E] to the commit."""
        ins = self._pin.get()
        hid = self._prefill_write(self.model, self.params,
                                  self._state.caches, ins)
        fh = self._fh
        fh.copy_(torch.where(ins["is_final"][:, None, None], hid, fh))

    def _draft_prefill(self) -> None:
        """The ``draft_prefill`` program (spec only): the same chunk of the
        draft model into its own arena, on the prefill's inputs."""
        self._prefill_write(self.draft_model, self.draft_params,
                            self._dcaches, self._pin.get())

    @torch.no_grad()
    def _commit(self) -> torch.Tensor:
        """The ``commit`` program: first tokens of all w lanes; the valid
        (admitted) ones arm their slots ``sid`` in place (JAX's ``setm``;
        a speculative engine also arms the draft's catch-up token, the
        prompt's last). Returns the packed [2, w] array [first token,
        done]."""
        ins = self._cin.get()
        st, fh = self._state, self._fh
        sid, valid, rid, mnew = (ins["sid"], ins["valid"], ins["rid"],
                                 ins["max_new"])
        w = sid.shape[0]
        hsel = fh[torch.arange(w, device=sid.device), ins["last_idx"]]
        logits = (hsel @ self.params["tok_emb"].T).float()     # [w, V]
        toks = self._sample(logits, rid, torch.zeros_like(rid))
        done = mnew <= 1
        if self.eos_id is not None:
            done = done | (toks == self.eos_id)

        def setm(vec, new):
            vec[sid] = torch.where(valid, new.to(vec.dtype), vec[sid])

        setm(st.pos, ins["plen"])
        setm(st.active, ~done)
        setm(st.last_tok, toks)
        setm(st.remaining, mnew - 1)
        setm(st.tok_idx, torch.ones_like(sid))
        setm(st.key, rid)
        setm(st.generation, st.generation[sid] + 1)
        if self.spec_k:
            setm(self._dprev, ins["dlast"])
        return torch.stack([toks, done.to(torch.int32)])

    @torch.no_grad()
    def _finish(self, state, hid):
        """Sampling and EOS/budget retirement for every slot, in place.
        Returns the packed [3, S] array [token, still-active, emitted]."""
        logits = (hid @ self.params["tok_emb"].T).float()
        toks = self._sample(logits, state.key, state.tok_idx)
        emitted = state.active.clone()
        toks = torch.where(emitted, toks, state.last_tok)
        step = emitted.to(torch.int32)
        state.remaining -= step
        spent = state.remaining <= 0
        if self.eos_id is not None:
            spent = spent | (toks == self.eos_id)
        state.active.copy_(emitted & ~spent)
        state.pos += step
        state.last_tok.copy_(toks)
        state.tok_idx += step
        return torch.stack([toks, state.active.to(torch.int32), step])

    def _page_kw(self) -> dict:
        """The paged arguments of ``_decode_slots``: the host table, copied
        into the decode program's input once per step (a retired slot's
        all-zero row sinks its frozen writes into the null page)."""
        if not self.paged:
            return {}
        return dict(page_table=self._din.get()["page_table"],
                    page_size=self.page_size)

    @torch.no_grad()
    def _decode_fused(self):
        """The fused ``decode`` program: every slot decodes (inactive ones
        at their frozen position, their writes landing where a later
        occupant rewrites them before anything attends)."""
        state = self._state
        pos_in = torch.clamp(state.pos, max=self.max_len - 1)
        hid, _ = self.model._decode_slots(self.params, state.last_tok,
                                          pos_in, state.caches,
                                          **self._page_kw())
        return self._finish(state, hid)

    @torch.no_grad()
    def _decode_serial(self):
        """The serialized ``decode`` program (JAX's vmapped ``_decode_one``,
        engine.py:484-498): every slot at its own position through
        ``_cached_blocks`` over the dense arena, in one batched call."""
        state = self._state
        pos_in = torch.clamp(state.pos, max=self.max_len - 1).long()
        x = (self.params["tok_emb"][state.last_tok.long()]
             + self.params["pos_emb"][pos_in])[:, None]          # [S, 1, E]
        hid, _ = self.model._cached_blocks(self.params, x, pos_in,
                                           state.caches)
        return self._finish(state, hid[:, 0])

    @torch.no_grad()
    def _spec_step(self):
        """The speculative ``decode`` program (engine.py:573-727), in place,
        on the engine's pool, draft arena and ``dprev``. k draft
        steps: the first a 2-query catch-up row over ``[pos - 1, pos]``
        (``dprev`` int32 [S] the committed token at ``pos - 1``: on full
        acceptance the bonus token moved ``pos`` past a position the
        draft never took), the rest 1-query; then ONE target forward over
        the k+1 rows; acceptance by :func:`spec_accept`; the EOS and
        budget cuts. Rejected rows need no rollback: they lie past the
        new ``pos``, each row masks to its own length, and the next
        step's writes cover them. Draws at ``temperature > 0`` are keyed
        (request, token index, role, row). Returns the packed [k+4, S]
        array: the k+1 candidate tokens, then [emitted, still-active,
        accepted] (``dprev`` updated in place)."""
        state, dcaches, dprev = self._state, self._dcaches, self._dprev
        k, temp = self.spec_k, self.temperature
        max_pos = self.max_len - 1
        kw = self._page_kw()
        dm, dp = self.draft_model, self.draft_params
        v = self.model.vocab_size
        pos_in = torch.clamp(state.pos, max=max_pos)
        cur = state.last_tok
        drafts, qsel, qdists = [], [], []
        for j in range(k):
            pj = torch.clamp(pos_in + j, max=max_pos)
            if j == 0:
                t2 = torch.stack([dprev, cur], dim=1)
                p2 = torch.stack([torch.clamp(pj - 1, min=0), pj], dim=1)
                dh, _ = dm._decode_slots(dp, t2, p2, dcaches, **kw)
                dh = dh[:, 1]
            else:
                dh, _ = dm._decode_slots(dp, cur, pj, dcaches, **kw)
            dlogits = (dh @ dp["tok_emb"].T).float()
            if temp > 0.0:
                u = stream_uniforms(self.seed, fold_key(state.key, 1, j),
                                    state.tok_idx, v)
                d = gumbel_argmax(dlogits / temp, u)
                qj = torch.softmax(dlogits / temp, dim=-1)
                qsel.append(qj.gather(1, d[:, None].long())[:, 0])
                qdists.append(qj)
            else:
                d = torch.argmax(dlogits, dim=-1).to(torch.int32)
            drafts.append(d)
            cur = d
        toks = torch.stack([state.last_tok] + drafts, dim=1)   # [S, k+1]
        cols = torch.arange(k + 1, device=pos_in.device)
        posm = torch.clamp(pos_in[:, None] + cols, max=max_pos).to(
            torch.int32)
        hid, _ = self.model._decode_slots(self.params, toks, posm,
                                          state.caches, **kw)
        logits = (hid @ self.params["tok_emb"].T).float()   # [S, k+1, V]
        if temp > 0.0:
            out, n_acc = spec_accept(
                toks, logits, temp, qsel=torch.stack(qsel, dim=1),
                qdists=torch.stack(qdists, dim=1),
                u=stream_uniforms(self.seed, fold_key(state.key, 2),
                                  state.tok_idx, k),
                u_extra=stream_uniforms(self.seed, fold_key(state.key, 3),
                                        state.tok_idx, v))
        else:
            out, n_acc = spec_accept(toks, logits, 0.0)
        active = state.active.clone()
        n_emit = torch.minimum(n_acc + 1, state.remaining)
        if self.eos_id is not None:
            eos_first = torch.where(out == self.eos_id, cols[None, :],
                                    k + 1).amin(dim=1)
            n_emit = torch.minimum(n_emit, (eos_first + 1).to(torch.int32))
        n_emit = torch.where(active, n_emit, 0).to(torch.int32)
        last_idx = torch.clamp(n_emit - 1, min=0).long()
        last_tok = out.gather(1, last_idx[:, None])[:, 0]
        last_tok = torch.where(n_emit > 0, last_tok, state.last_tok)
        # the next step's catch-up token, the committed token at the new
        # pos - 1: out[n_emit - 2] once two are emitted, else the token
        # pending this step
        prev2 = out.gather(1, torch.clamp(n_emit - 2, min=0).long()[:, None])
        dprev.copy_(torch.where(n_emit >= 2, prev2[:, 0],
                                torch.where(n_emit == 1, state.last_tok,
                                            dprev)))
        state.remaining -= n_emit
        spent = state.remaining <= 0
        if self.eos_id is not None:
            spent = spent | (last_tok == self.eos_id)
        state.active.copy_(active & (n_emit > 0) & ~spent)
        state.pos += n_emit
        state.last_tok.copy_(last_tok)
        state.tok_idx += n_emit
        return torch.cat([out.T, n_emit[None], state.active[None].to(
            torch.int32), torch.where(active, n_acc, 0)[None]], dim=0)

    def _build_programs(self) -> None:
        """The engine's programs (``self.programs``, keyed as
        :meth:`program_lineages`), their input blocks and the buffers they
        carry between them. The fused engine runs prefill and commit at
        width ``slots``, the serialized one at width 1."""
        s, c, dev = self.slots, self.prefill_chunk, self.device
        w = s if self.fused else 1
        i64, i32, b8 = torch.int64, torch.int32, torch.bool
        pool = new_pool(dev)
        index = (((w, self.max_pages), i32) if self.paged
                 else ((w,), i64))
        self._pin = Inputs(dict(tok=((w, c), i64), index=index,
                                pos0=((1,), i64), valid=((w,), b8),
                                is_final=((w,), b8)), dev)
        commit = dict(sid=((w,), i64), last_idx=((w,), i64),
                      plen=((w,), i64), max_new=((w,), i64),
                      rid=((w,), i64), valid=((w,), b8))
        if self.spec_k:
            commit["dlast"] = ((w,), i32)
        self._cin = Inputs(commit, dev)
        self._din = (Inputs(dict(page_table=((s, self.max_pages), i32)), dev)
                     if self.paged else None)
        # each lane's final-chunk hidden states, prefill -> commit
        self._fh = torch.zeros((w, c, self.model.embed_dim),
                               dtype=self._hid_dtype, device=dev)

        def prog(name, body, inputs=None):
            return DeviceProgram(name, body, device=dev, inputs=inputs,
                                 pool=pool)

        if not self.fused:
            decode = self._decode_serial
        elif self.spec_k:
            decode = self._spec_step
        else:
            decode = self._decode_fused
        self.programs = {"prefill": prog("prefill", self._prefill, self._pin),
                         "commit": prog("commit", self._commit, self._cin),
                         "decode": prog("decode", decode, self._din)}
        if self.spec_k:
            self.programs["draft_prefill"] = prog(
                "draft_prefill", self._draft_prefill, self._pin)

    # -- pool construction -------------------------------------------------

    def _init_state(self) -> SlotState:
        """Fresh all-inactive pool, dense or paged."""
        if self.paged:
            return init_paged_state(self.model, self.params, self.slots,
                                    self.max_len, self.page_size,
                                    self.kv_pages, device=self.device)
        return init_slot_state(self.model, self.params, self.slots,
                               self.max_len, device=self.device)

    def _init_draft_caches(self) -> dict:
        """Fresh draft-model KV (spec only): a second dense arena beside
        the target's, or a parallel page pool behind the SAME host page
        table and allocator (draft pages are ordinary pages)."""
        if self.paged:
            return init_cache_arena(self.draft_model, self.draft_params,
                                    self.kv_pages + 1, self.page_size,
                                    device=self.device)
        return init_cache_arena(self.draft_model, self.draft_params,
                                self.slots, self.max_len, device=self.device)

    @torch.no_grad()
    def _reset(self) -> None:
        """The pool, the draft arena and the carried buffers back to their
        fresh all-zero state, in place (their addresses are the captured
        graphs')."""
        st = self._state
        arenas = [st.caches] + ([self._dcaches] if self._dcaches else [])
        for caches in arenas:
            for k, v in caches.values():
                k.zero_()
                v.zero_()
        for t in (st.pos, st.active, st.last_tok, st.remaining, st.tok_idx,
                  st.key, st.generation, self._fh):
            t.zero_()
        if self._dprev is not None:
            self._dprev.zero_()

    def _pages_for(self, plen: int, max_new: int) -> int:
        """Worst-case pages one request reserves at admission: the padded
        prompt (chunked prefill writes pad positions) and the full
        generation budget, rounded up to pages."""
        c = self.prefill_chunk
        padded = -(-plen // c) * c
        span = max(padded, plen + max_new)
        return -(-span // self.page_size)

    def _sharable_pages(self, plen: int) -> int:
        """Pages of a prompt eligible for prefix sharing: full pages
        strictly before the LAST prefill chunk — the commit needs that
        chunk's hidden state, so it always re-prefills privately (and
        page_size % prefill_chunk == 0 keeps the boundary aligned)."""
        last_chunk_start = ((plen - 1) // self.prefill_chunk) \
            * self.prefill_chunk
        return last_chunk_start // self.page_size

    # -- scheduler dataflow and warmup (engine.py:867-1075) ----------------

    def program_lineages(self) -> dict:
        """Which programs' output state can feed each program's input
        state in a real run (``"fresh"`` = the pool as ``run`` resets it):
        the scheduler dataflow ``run`` implements, declared once so that
        :meth:`warmup`'s coverage is checked against it. ``prefill <-
        prefill`` exists only when multi-chunk prompts are admissible
        (``max_len >= 2 * prefill_chunk``). Spec engines add
        ``draft_prefill`` (its draft arena from fresh state, its own
        previous chunk, or a spec step) and widen ``decode``'s set with
        ``draft_prefill`` (the spec step reads both the slot state, from
        commit or decode, and the draft arena, from draft_prefill or
        decode). The serialized engine has the same lineages."""
        two = self.max_len >= 2 * self.prefill_chunk
        pre = {"fresh", "commit", "decode"}
        if two:
            pre.add("prefill")
        lin = {"prefill": frozenset(pre),
               "commit": frozenset({"prefill"}),
               "decode": frozenset({"commit", "decode"})}
        if self.spec_k:
            dpre = {"fresh", "decode"}
            if two:
                dpre.add("draft_prefill")
            lin["draft_prefill"] = frozenset(dpre)
            lin["decode"] = frozenset({"commit", "decode",
                                       "draft_prefill"})
        return lin

    def warmup_coverage(self) -> dict:
        """The (program <- predecessor) transitions :meth:`warmup` drives
        (engine.py:942-962): same shape as :meth:`program_lineages`, and
        required EQUAL to it (tests/test_torch_serve_programs.py pins the
        equality, and that a run after warmup calls no program with a new
        signature)."""
        two = 2 * self.prefill_chunk <= self.max_len
        pre = {"fresh", "commit", "decode"}
        if two:
            pre.add("prefill")
        cov = {"prefill": frozenset(pre),
               "commit": frozenset({"prefill"}),
               "decode": frozenset({"commit", "decode"})}
        if self.spec_k:
            dpre = {"fresh", "decode"}
            if two:
                dpre.add("draft_prefill")
            cov["draft_prefill"] = frozenset(dpre)
            cov["decode"] = frozenset({"commit", "decode",
                                       "draft_prefill"})
        return cov

    def warmup(self) -> None:
        """Capture every device program before a timed run, as the JAX
        engine's ``warmup`` compiles every program and layout (engine.py:
        897-1075): it drives exactly the transitions of
        :meth:`warmup_coverage` on fresh state. On the card each program's
        first call here captures its CUDA graph, so a run after it
        captures none; a run without it captures at first use, inside its
        TTFT. The JAX engine warms a ladder of lane widths; the port runs
        prefill and commit at the pool's one width (the serialized engine
        at width 1), so one graph a program covers every admission. Paged
        warmup maps every slot's row round-robin over the real pool (JAX's
        warmup table: collisions are fine, the warmup's math is
        discarded). The warmup's state is discarded: the pool is reset in
        place after it."""
        c, w = self.prefill_chunk, self._fh.shape[0]
        p = self.programs
        # two chunks whenever real prompts can span two (max_len >= 2C),
        # so prefill <- prefill is driven; warmup state never goes
        # through validate()
        n = 2 if 2 * c <= self.max_len else 1
        self._reset()
        wt = None
        if self.paged:
            wt = np.zeros((self.slots, self.max_pages), np.int32)
            for s in range(self.slots):
                for j in range(self.max_pages):
                    wt[s, j] = 1 + (s * self.max_pages + j) % self.kv_pages
        ones = np.ones((w,), bool)

        def prefill():          # prefill <- *, draft_prefill <- *
            for ci in range(n):
                p["prefill"](tok=np.zeros((w, c), np.int64),
                             index=wt if self.paged else np.arange(w),
                             pos0=[ci * c], valid=ones,
                             is_final=ones if ci == n - 1 else ~ones)
                if self.spec_k:
                    p["draft_prefill"]()

        def commit():           # commit <- prefill
            kw = dict(sid=np.arange(w), last_idx=np.zeros((w,)),
                      plen=np.full((w,), n * c), max_new=np.full((w,), 2),
                      rid=np.arange(w), valid=ones)
            if self.spec_k:
                kw["dlast"] = np.zeros((w,))
            p["commit"](**kw)
            p["commit"].fetch()

        def decode():           # decode <- commit, decode (, draft)
            p["decode"](**({"page_table": wt} if self.paged else {}))
            p["decode"].fetch()

        prefill()
        commit()
        prefill()
        commit()
        decode()
        decode()
        prefill()
        commit()
        decode()
        self._reset()

    def lint_programs(self) -> list:
        raise NotImplementedError(
            f"lint_programs describes the programs for apex_lint's program "
            f"rules, which are not ported yet ({_LINT_ROW}, analysis/)")

    # -- admission-time validation ----------------------------------------

    def validate(self, req: Request) -> None:
        plen = len(req.prompt)
        c = self.prefill_chunk
        if plen < 1:
            raise ValueError(f"request {req.id}: empty prompt")
        if req.max_new < 1:
            raise ValueError(f"request {req.id}: max_new must be >= 1")
        padded = -(-plen // c) * c
        if padded > self.max_len:
            raise ValueError(
                f"request {req.id}: prompt ({plen}) padded to the "
                f"prefill chunk ({padded}) exceeds the pool max_len "
                f"({self.max_len})")
        if plen + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.id}: prompt ({plen}) + max_new "
                f"({req.max_new}) exceeds the pool max_len "
                f"({self.max_len})")

    # -- the serving loop --------------------------------------------------

    def run(self, requests, *, telemetry=None, tracer=None, slo=None,
            live=None, t0=None, on_retire=None, flightrec=None):
        """Serve ``requests`` to completion. Returns ``(results, stats)``:
        one :class:`RequestResult` per request (input order) and the
        run-level counters ``summarize_serving`` aggregates. The engine
        never drops a request; invalid ones raise up front.

        ``requests`` may instead be a feed: any object with ``poll() ->
        list[Request]`` and a ``closed`` property (``serve.router.
        RouterFeed``). The loop drains it at every poll, validating each
        request as it arrives and refusing a duplicate id, and runs until
        the feed is closed and drained and the pool has drained. Results
        come back in admission order.

        ``t0``: a ``time.perf_counter()`` epoch to use as time zero, so a
        router and its replicas stamp latencies on one clock (a routed
        request's ``arrival_s`` is router-relative). ``on_retire(res)`` is
        called with each finished :class:`RequestResult` at its
        retirement (the router's completion accounting).

        ``tracer`` (``prof.spans.SpanTracer``): per-request ``request``
        spans parenting ``queue`` -> ``commit`` -> ``decode`` ->
        ``retire``, ``prefill_chunk`` spans on the serialized path and
        ``prefill_batch`` spans on the fused one, and a ``decode_step``
        span a step, on the host timestamps of the results, so
        percentiles from spans equal ``summarize_serving``'s. ``slo``
        (``prof.slo.SLOMonitor``) is fed ``ttft_ms`` at each first token,
        ``token_lat_ms`` at each retirement and ``step_ms`` each decode
        step; ``live`` (``prof.live.LiveEmitter``, or the router's
        ``ReplicaProbe``) the same, plus ``occupancy`` and
        ``queue_depth`` each step and an ``occupancy`` of 0 every 32 idle
        polls. ``telemetry`` and ``flightrec`` need ``MetricsLogger`` and
        the flight recorder, not ported yet."""
        hooks = {"telemetry": telemetry, "flightrec": flightrec}
        armed = [k for k, v in hooks.items() if v is not None]
        if armed:
            raise NotImplementedError(
                f"run({', '.join(armed)}=...): MetricsLogger and the "
                f"flight recorder are not ported yet ({_TRACE_ROW})")
        feed = (requests if hasattr(requests, "poll")
                and hasattr(requests, "closed") else None)
        if feed is None:
            for r in requests:
                self.validate(r)
            order = list(requests)
        else:
            order = []
        self._reset()
        state = self._state
        progs = self.programs
        spec = self.spec_k > 0
        # spec accounting: per-(slot, step) accepted-draft samples
        spec_draft_tokens = spec_accepted = spec_samples = 0
        spec_hist = [0] * (self.spec_k + 1)
        pool_bytes = arena_bytes(state)
        tok_bytes = kv_token_bytes(state)
        results = {r.id: RequestResult(id=r.id, prompt_len=len(r.prompt),
                                       arrival_s=r.arrival_s)
                   for r in order}
        if len(results) != len(order):
            raise ValueError("duplicate request ids")
        pending = deque(sorted(order, key=lambda r: (r.arrival_s, r.id)))
        ready: deque = deque()
        free = list(range(self.slots))
        busy: dict = {}                       # slot -> Request
        host_gen = [0] * self.slots
        self.events = []
        decode_steps = prefill_chunks = occupancy_sum = 0
        prefill_batches = idle_polls = 0
        batch_sizes: list = []
        queue_depth: list = []
        step_ms: list = []
        # host-side KV accounting (no device syncs)
        host_len = [0] * self.slots
        resident = {"now": 0, "peak": 0}
        pt = None
        page_pool: Optional[PagePool] = None
        prefix: Optional[PrefixCache] = None
        kv_free_min = None
        if self.paged:
            pt = np.zeros((self.slots, self.max_pages), np.int32)
            page_pool = PagePool(self.kv_pages)
            kv_free_min = page_pool.free_count
            if self.prefix_share:
                prefix = PrefixCache(self.page_size)
        self._page_table = pt                 # test/debug visibility
        self._page_pool = page_pool
        self._prefix_cache = prefix
        tr = tracer
        req_span: dict = {}                   # request id -> span id
        dec_span: dict = {}                   # request id -> decode span
        if t0 is None:
            t0 = time.perf_counter()
        # engine-relative times on the tracer's clock (with an external
        # t0 the run started in the past: shift by what has elapsed)
        base = (tr.now() - (time.perf_counter() - t0)) \
            if tr is not None else 0.0

        def now() -> float:
            return time.perf_counter() - t0

        def poll() -> None:
            t = now()
            if feed is not None:
                for r in feed.poll():
                    self.validate(r)
                    if r.id in results:
                        raise ValueError(
                            f"duplicate request id {r.id} from feed")
                    results[r.id] = RequestResult(
                        id=r.id, prompt_len=len(r.prompt),
                        arrival_s=r.arrival_s)
                    order.append(r)
                    pending.append(r)
            while pending and pending[0].arrival_s <= t:
                ready.append(pending.popleft())

        def retire_kv(slot: int) -> None:
            """Resident bytes drop and (paged) every page reference the
            slot held is released; cached prefix pages survive on the
            cache's own hold. The table row returns to the null page."""
            resident["now"] -= host_len[slot]
            host_len[slot] = 0
            if pt is None:
                return
            for phys in pt[slot]:
                if phys:
                    page_pool.release(int(phys))
            pt[slot, :] = 0

        def retire_spans(rid: int, t: float, slot: int, step: int) -> None:
            """Close a request's decode and request spans at its finish
            time and mark the retirement."""
            ds = dec_span.pop(rid, None)
            if ds is not None:
                tr.end(ds, t1=base + t,
                       tokens=len(results[rid].tokens) - 1)
            rs = req_span.pop(rid, None)
            if rs is not None:
                tr.instant("retire", parent=rs, slot=slot, step=step)
                tr.end(rs, tokens=len(results[rid].tokens))

        def release_slot(slot: int, rid: int, t: float, step: int) -> None:
            res = results[rid]
            res.finish_s = t
            self.events.append(("retire", rid, slot, step))
            retire_kv(slot)
            free.append(slot)
            free.sort()
            if tr is not None:
                retire_spans(rid, t, slot, step)
            if slo is not None:
                slo.observe("token_lat_ms", res.token_lat_s * 1e3,
                            context={"request": rid})
            if live is not None:
                live.observe("token_lat_ms", res.token_lat_s * 1e3)
            if on_retire is not None:
                on_retire(res)

        def admit_spans(req: Request, slot: int, t_admit: float):
            """The request and queue spans at admission; returns the open
            commit span (it ends at the first-token fetch)."""
            if tr is None:
                return None
            ctx = ({"trace": req.trace,
                    "hop": int(getattr(req, "hop", 0) or 0)}
                   if getattr(req, "trace", None) is not None else {})
            rs = tr.begin("request", t0=base + req.arrival_s,
                          request=req.id, prompt_len=len(req.prompt),
                          max_new=req.max_new, **ctx)
            req_span[req.id] = rs
            qs = tr.begin("queue", parent=rs, t0=base + req.arrival_s,
                          request=req.id)
            tr.end(qs, t1=base + t_admit, slot=slot)
            return tr.begin("commit", parent=rs, t0=base + t_admit,
                            request=req.id)

        def first_token(req: Request, slot: int, first: int, done: bool,
                        t: float, cs) -> None:
            res = results[req.id]
            res.tokens.append(first)
            res.token_times.append(t)
            res.first_token_s = t
            host_len[slot] = res.prompt_len   # prompt KV is resident
            resident["now"] += res.prompt_len
            resident["peak"] = max(resident["peak"], resident["now"])
            if cs is not None:
                tr.end(cs, t1=base + t, slot=slot)
            if slo is not None:
                slo.observe("ttft_ms", (t - req.arrival_s) * 1e3,
                            context={"request": req.id})
            if live is not None:
                live.observe("ttft_ms", (t - req.arrival_s) * 1e3)
            if done:                          # one-token request
                release_slot(slot, req.id, t, 0)
            else:
                busy[slot] = req
                if tr is not None:
                    dec_span[req.id] = tr.begin(
                        "decode", parent=req_span[req.id], t0=base + t,
                        request=req.id)
        def seat() -> tuple:
            """Pop the requests this poll admits, their slots and the
            prefill chunks a prefix hit covers (paged: while the head
            request's worst-case pages, less its cached prefix, fit;
            strict FIFO, evicting cache-only pages on need)."""
            nonlocal kv_free_min
            if pt is None:
                k = min(len(ready), len(free))
                return ([ready.popleft() for _ in range(k)],
                        [free.pop(0) for _ in range(k)], [0] * k)
            batch, taken, shared = [], [], []
            while ready and free:
                req = ready[0]
                plen = len(req.prompt)
                total = self._pages_for(plen, req.max_new)
                hits = (prefix.match(req.prompt,
                                     min(self._sharable_pages(plen), total))
                        if prefix is not None else [])
                need = total - len(hits)
                if not page_pool.can_alloc(need) and prefix is not None:
                    prefix.evict(page_pool, need)
                if not page_pool.can_alloc(need):
                    break            # head-of-line waits for pages
                ready.popleft()
                slot = free.pop(0)
                priv = iter(page_pool.alloc(need))
                row = pt[slot]
                row[:] = 0
                for pg, phys, _chain in hits:
                    row[pg] = phys
                    page_pool.retain(phys)
                for pg in range(total):
                    if row[pg] == 0:
                        row[pg] = next(priv)
                results[req.id].prefix_tokens = len(hits) * self.page_size
                batch.append(req)
                taken.append(slot)
                shared.append(len(hits) * self.page_size
                              // self.prefill_chunk)
            kv_free_min = min(kv_free_min, page_pool.free_count)
            return batch, taken, shared

        def admit_one() -> None:
            """Serialized single-request admission (fused=False): the r13
            baseline, ceil(P/C) prefill calls + 1 commit at width 1 (an
            admission 'batch' of 1)."""
            nonlocal prefill_chunks, prefill_batches
            req = ready.popleft()
            slot = free.pop(0)
            res = results[req.id]
            res.slot, res.admit_s = slot, now()
            host_gen[slot] += 1
            res.generation = host_gen[slot]
            self.events.append(("admit", req.id, slot, host_gen[slot]))
            cs = admit_spans(req, slot, res.admit_s)
            c = self.prefill_chunk
            plen = len(req.prompt)
            n = -(-plen // c)
            toks = np.zeros((1, n * c), np.int64)
            toks[0, :plen] = req.prompt
            for ci in range(n):
                ps = (tr.begin("prefill_chunk", parent=req_span[req.id],
                               request=req.id, chunk=ci)
                      if tr is not None else None)
                progs["prefill"](tok=toks[:, ci * c:(ci + 1) * c],
                                 index=[slot], pos0=[ci * c], valid=[True],
                                 is_final=[ci == n - 1])
                if ps is not None:
                    tr.end(ps)        # dispatch time: the sync is ahead
                prefill_chunks += 1
            progs["commit"](sid=[slot], last_idx=[(plen - 1) % c],
                            plen=[plen], max_new=[req.max_new],
                            rid=[req.id], valid=[True])
            first, done = progs["commit"].fetch()[:, 0]   # the TTFT sync
            t = now()
            prefill_batches += 1
            batch_sizes.append(1)
            first_token(req, slot, int(first), bool(done), t, cs)

        def admit_batch() -> None:
            """All requests ready at this poll seat in one chain:
            ceil(max P/C) prefill calls (less the chunks every lane's
            prefix hit covers) + one commit + ONE fetch."""
            nonlocal prefill_chunks, prefill_batches
            batch, taken, shared = seat()
            if not batch:
                return
            c = self.prefill_chunk
            t_admit = now()
            # scheduler scope: one batched prefill serves k requests
            pb = (tr.begin("prefill_batch", batch=len(batch))
                  if tr is not None else None)
            commit_spans = []
            for req, slot in zip(batch, taken):
                res = results[req.id]
                res.slot, res.admit_s = slot, t_admit
                host_gen[slot] += 1
                res.generation = host_gen[slot]
                self.events.append(("admit", req.id, slot, host_gen[slot]))
                commit_spans.append(admit_spans(req, slot, t_admit))
            k, w = len(batch), self.slots
            pad = [0] * (w - k)
            plens = [len(r.prompt) for r in batch]
            n_chunks = [-(-p // c) for p in plens]
            # distinct lane -> slot map: the admitted slots, then every
            # other slot as a masked padding lane
            slot_ids = np.asarray(
                taken + [s for s in range(w) if s not in taken], np.int64)
            ids = pt[slot_ids] if pt is not None else slot_ids
            tok_mat = np.zeros((w, max(n_chunks) * c), np.int64)
            for lane, req in enumerate(batch):
                tok_mat[lane, :plens[lane]] = req.prompt
            for ci in range(max(n_chunks)):
                # a prefix-hit lane's leading chunks are already in the
                # pool as shared pages: its valid window starts past them
                valid = np.asarray([shared[i] <= ci < n_chunks[i]
                                    for i in range(k)] + [False] * (w - k))
                if not valid.any():
                    continue       # every lane's chunk here is cached
                is_final = np.asarray([ci == n - 1 for n in n_chunks]
                                      + [False] * (w - k))
                progs["prefill"](tok=tok_mat[:, ci * c:(ci + 1) * c],
                                 index=ids, pos0=[ci * c], valid=valid,
                                 is_final=is_final)
                if spec:
                    progs["draft_prefill"]()      # the same inputs
                prefill_chunks += 1
            kw = dict(sid=slot_ids, last_idx=[(p - 1) % c for p in plens]
                      + pad, plen=plens + pad,
                      max_new=[r.max_new for r in batch] + [1] * (w - k),
                      rid=[r.id for r in batch] + pad,
                      valid=[True] * k + [False] * (w - k))
            if spec:
                # arm the draft's catch-up lane: right after the commit
                # the token at pos - 1 is the prompt's last
                kw["dlast"] = [int(r.prompt[-1]) for r in batch] + pad
            progs["commit"](**kw)
            packed = progs["commit"].fetch()  # ONE sync: every lane's TTFT
            t = now()
            prefill_batches += 1
            batch_sizes.append(k)
            if pb is not None:
                tr.end(pb, t1=base + t, batch=k, chunks=max(n_chunks))
            if prefix is not None:
                # the prompts just prefilled are cacheable: insert their
                # full pages (the cache takes its own reference) before
                # any retirement below can free them
                for req, slot in zip(batch, taken):
                    n_ins = min(self._sharable_pages(len(req.prompt)),
                                self.max_pages)
                    for pg, chain in enumerate(chain_hashes(
                            req.prompt, self.page_size, n_ins)):
                        phys = int(pt[slot, pg])
                        if prefix.insert(chain, phys, pg):
                            page_pool.retain(phys)
            firsts, dones = packed
            for lane, (req, slot) in enumerate(zip(batch, taken)):
                first_token(req, slot, int(firsts[lane]),
                            bool(dones[lane]), t, commit_spans[lane])

        while pending or ready or busy or \
                (feed is not None and not feed.closed):
            poll()
            admitted = False
            may_admit = (not busy) if self.policy == "static" else True
            if not self.fused:
                while ready and free and may_admit:
                    admit_one()
                    admitted = True
                    poll()            # prefill took wall time
                    if self.policy == "continuous":
                        break         # one admission per decode step
            elif ready and free and may_admit:
                n_before = prefill_batches
                admit_batch()
                # the paged gate may admit nothing (head-of-line waiting
                # for pages): only count a real admission
                admitted = prefill_batches > n_before
                poll()                # prefill took wall time
            if busy:
                # scheduler scope: one step advances every busy slot
                ss = (tr.begin("decode_step", step=decode_steps + 1)
                      if tr is not None else None)
                t_dispatch = time.perf_counter()
                progs["decode"](**({"page_table": pt} if pt is not None
                                   else {}))
                packed = progs["decode"].fetch()  # the ONE sync per step
                t_now = now()
                dt_ms = (time.perf_counter() - t_dispatch) * 1e3
                step_ms.append(dt_ms)
                decode_steps += 1
                if spec:
                    tok_rows = packed[:self.spec_k + 1]   # [k+1, S]
                    n_emit, active, n_acc = packed[self.spec_k + 1:]
                else:
                    toks, active, n_emit = packed
                emitted = int((n_emit > 0).sum())
                occupancy_sum += emitted
                queue_depth.append(len(ready))
                if ss is not None:
                    tr.end(ss, t1=base + t_now, active=emitted,
                           queue_depth=len(ready))
                if slo is not None:
                    slo.observe("step_ms", dt_ms,
                                context={"step": decode_steps})
                if live is not None:
                    # one enqueue a step: the tap must not tax the cadence
                    live.observe_many(step_ms=dt_ms,
                                      occupancy=emitted / self.slots,
                                      queue_depth=len(ready))
                for slot in list(busy):
                    ne = int(n_emit[slot])
                    if not ne:
                        continue
                    rid = busy[slot].id
                    res = results[rid]
                    if spec:
                        res.tokens.extend(tok_rows[:ne, slot].tolist())
                        na = int(n_acc[slot])
                        spec_hist[na] += 1
                        spec_draft_tokens += self.spec_k
                        spec_accepted += na
                        spec_samples += 1
                    else:
                        res.tokens.append(int(toks[slot]))
                    res.token_times.extend([t_now] * ne)
                    host_len[slot] += ne      # this step's KV writes
                    resident["now"] += ne
                    if not active[slot]:
                        del busy[slot]
                        release_slot(slot, rid, t_now, decode_steps)
                resident["peak"] = max(resident["peak"], resident["now"])
            elif not admitted and (pending or ready or feed is not None):
                # idle: the next arrival is in the future, the paged gate
                # is waiting on pages, or the feed has nothing yet
                if pending:
                    dt = pending[0].arrival_s - now()
                    if dt > 0:
                        time.sleep(min(dt, 0.001))
                else:
                    time.sleep(0.0005)
                idle_polls += 1
                if live is not None and idle_polls % 32 == 0:
                    # a starved replica shows a collapsed occupancy
                    # window, not an absent one
                    live.observe_many(occupancy=0.0,
                                      queue_depth=len(ready))

        stats = {
            "duration_s": now(),
            "decode_steps": decode_steps,
            "prefill_chunks": prefill_chunks,
            "prefill_batches": prefill_batches,
            "prefill_batch_sizes": batch_sizes,
            "occupancy_sum": occupancy_sum,
            "queue_depth": queue_depth,
            "step_ms": step_ms,
            "slots": self.slots,
            "arena_bytes": pool_bytes,
            "mode": self.policy,
            "fused": self.fused,
            "paged": self.paged,
            "kv_reserved_bytes": pool_bytes,
            "kv_resident_peak_bytes": resident["peak"] * tok_bytes,
        }
        if spec:
            stats.update(
                spec_k=self.spec_k,
                spec_steps=decode_steps,
                spec_draft_tokens=spec_draft_tokens,
                spec_accepted_tokens=spec_accepted,
                spec_accept_mean=(spec_accepted / spec_samples
                                  if spec_samples else 0.0),
                spec_accept_hist=spec_hist,
            )
        if self.paged:
            stats.update(
                page_size=self.page_size,
                kv_pages=self.kv_pages,
                kv_pages_free=page_pool.free_count,
                kv_pages_free_min=kv_free_min,
            )
            if prefix is not None:
                ps = prefix.stats()
                stats.update(
                    prefix_hits=ps["hits"],
                    prefix_lookups=ps["lookups"],
                    prefix_entries=ps["entries"],
                    prefix_evictions=ps["evictions"],
                )
        return [results[r.id] for r in order], stats
