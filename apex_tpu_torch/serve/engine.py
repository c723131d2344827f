"""Continuous-batching engine — counterpart of ``apex_tpu/serve/engine.py``
on its fused path, dense and paged.

The device work per scheduler poll and step is the JAX engine's three
programs, run eagerly:

1. ``_prefill_batch`` / ``_prefill_batch_paged`` — one
   ``TransformerLM._cached_blocks`` pass over one prompt chunk for all the
   requests admitted in this poll: their lanes are gathered out of the
   arena (by slot, or by page-table row), run as one batch, and the chunk
   just written is stored back for the lanes that had a chunk at this
   depth (paged: into the one page that holds the chunk).
2. ``_commit_batch`` — every admitted lane's first token from its final
   chunk's hidden state, sampled, and the slots armed; ONE device->host
   fetch per admission batch, the TTFT point.
3. ``_decode_fused`` / ``_decode_fused_paged`` — ONE step for all slots
   through ``TransformerLM._decode_slots`` (the LayerNorm and decode
   attention kernels on the card), then sampling and EOS/budget retirement
   on the device; ONE fetch per step, the packed ``[3, S]`` array.

Where the JAX engine donates its state to each program and rebinds the
result, this engine updates the KV arena and the slot scalars IN PLACE.
Where a JAX program scatters every lane back and the invalid lanes write
their own gathered values, this one writes only the valid lanes: the
result is the same. Prefill and commit always run at the full pool width,
the admitted lanes first and the other slots as masked padding lanes (the
JAX engine's width-``slots`` program). A lane's arithmetic then never
depends on how many requests share its poll: cuBLAS picks its kernel, and
with it the summation order, by the product's shape, so a variable width
would make greedy streams depend on arrival timing on the card.

The host scheduler is the JAX one: Poisson-arrived requests go queued ->
admitted -> retired, freed slots are reused at once (``continuous``) or
only after the pool drains (``static``), and TTFT and per-token times are
stamped at the host syncs. The paged arena keeps a host page table
(``np.int32 [slots, max_pages]``) mutated in place at admission and
retirement, copied to the device once per program call and never read
back; admission is gated on free pages.

Sampling at ``temperature > 0`` draws from a counter-based stream keyed by
``(seed, request id, token index)`` and computed on the device
(:func:`stream_uniforms`), so tokens do not depend on the slot or on how
admissions were batched. JAX's threefry keys cannot be reproduced in
torch: only replay determinism is shared with the JAX engine, and equality
across packages holds for greedy decoding.

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP row: ``fused=False``, speculative decoding (``spec_k``/``draft``),
``prefix_share``, the router feed, ``run``'s telemetry/tracer/slo/live/
flightrec hooks, and ``warmup``/``program_lineages``/``lint_programs``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib.multihead_attn.decode_attention import (
    gather_pages)
from apex_tpu_torch.serve.slots import (PagePool, SlotState, arena_bytes,
                                        init_paged_state, init_slot_state,
                                        kv_token_bytes)

__all__ = ["Request", "RequestResult", "ContinuousBatchingEngine",
           "stream_uniforms"]

_POLICIES = ("continuous", "static")
_SERVE_ROW = "ROADMAP.md Queue 1, slice 5"
_TRACE_ROW = "ROADMAP.md Queue 1, slice 8"


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_s`` is relative to run start;
    the scheduler will not admit a request before its arrival time.
    ``session``/``trace``/``hop`` are the router's affinity key and trace
    context, carried for the later router port; the engine never reads
    them."""
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


# -- the counter-based sampling stream -------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant
    c, in two 16-bit halves so no product leaves the int64 range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (lowbias32): each output bit depends on
    every input bit. Inputs stay in [0, 2**32), so shifts are logical."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stream_uniforms(seed: int, key: torch.Tensor, tok_idx: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Uniforms in (0, 1), float32 [rows, n]. Row r is draw ``tok_idx[r]``
    of the stream ``(seed, key[r])``, column j its j-th value: a pure
    function of those integers, computed where ``key`` lives."""
    s = _mix32(torch.full_like(key, seed & _M32))
    h = _mix32((key & _M32) ^ s)
    h = _mix32(h ^ (tok_idx.to(torch.int64) & _M32))
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    bits = _mix32(_mix32((h[:, None] + _mul32(j, 0x9E3779B9)[None, :])
                         & _M32))
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


class ContinuousBatchingEngine:
    """Serving engine over a :class:`~apex_tpu_torch.serve.slots.SlotState`
    pool on ``device`` (the card unless ``device="cpu"``); ``params`` must
    live there. ``run`` is reusable: every call starts from a fresh pool.

    ``policy='continuous'`` admits into any freed slot between decode
    steps; ``policy='static'`` only admits when the pool has drained.
    ``paged=True`` swaps the dense ``[slots, H, max_len, hd]`` arena for a
    global page pool of ``kv_pages`` pages of ``page_size`` positions;
    a request reserves only the pages its prompt and budget need. Greedy
    paged streams equal the dense ones token for token."""

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
        if not fused:
            raise NotImplementedError(
                f"fused=False (the serialized r13 baseline) is not ported "
                f"yet ({_SERVE_ROW})")
        self.fused = True
        if prefix_share:
            raise NotImplementedError(
                f"prefix_share is not ported yet ({_SERVE_ROW})")
        if spec_k or draft is not None:
            raise NotImplementedError(
                f"speculative decoding (spec_k/draft) is not ported yet "
                f"({_SERVE_ROW})")
        if params["tok_emb"].device != self.device:
            raise ValueError(
                f"params live on {params['tok_emb'].device}, the engine "
                f"on {self.device}")
        self.events: list = []
        self._hid_dtype = params["tok_emb"].dtype
        self._init_state()        # validates slots/max_len eagerly

    # -- device helpers ----------------------------------------------------

    def _dev(self, a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """One host->device copy of a host array. On the card it goes
        through pinned memory without blocking: a copy from pageable
        memory would make the host wait for the device to drain. The
        pinned buffer is a snapshot, so the caller may mutate ``a``
        (the page table) right after."""
        t = torch.as_tensor(np.asarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, dtype, non_blocking=True)
        return t.to(dtype=dtype)

    def _sample(self, logits: torch.Tensor, keys: torch.Tensor,
                tok_idx: torch.Tensor) -> torch.Tensor:
        """One token per row of fp32 logits [n, V]: argmax when greedy,
        else a temperature-scaled gumbel argmax over the rows' counter
        streams (the same categorical the JAX engine draws)."""
        if self.temperature > 0.0:
            u = stream_uniforms(self.seed, keys, tok_idx, logits.shape[-1])
            logits = logits / self.temperature - torch.log(-torch.log(u))
        return torch.argmax(logits, dim=-1).to(torch.int32)

    # -- the device programs -----------------------------------------------

    @torch.no_grad()
    def _prefill_write(self, state, fh, lanes, chunks, pos0: int,
                       is_final, valid, dst, off: int):
        """Run one chunk through the block stack over gathered ``lanes``
        and store the chunk's K/V back into the arena rows ``dst`` at
        ``off`` for the ``valid`` lanes. Returns the final-chunk hidden
        states [w, C, E], carried per lane into the commit."""
        params, c = self.params, self.prefill_chunk
        tok = self._dev(chunks, torch.long)
        x = params["tok_emb"][tok] + params["pos_emb"][pos0:pos0 + c]
        hid, lanes = self.model._cached_blocks(params, x, pos0, lanes)
        src = self._dev(np.flatnonzero(valid), torch.long)
        dst = self._dev(dst, torch.long)
        for name, (k, v) in state.caches.items():
            lk, lv = lanes[name]
            # in place: only this chunk's window of the valid lanes
            k[dst, :, off:off + c] = lk[src, :, pos0:pos0 + c]
            v[dst, :, off:off + c] = lv[src, :, pos0:pos0 + c]
        fin = self._dev(is_final)
        return torch.where(fin[:, None, None], hid, fh)

    def _prefill_batch(self, state, fh, slot_ids, chunks, pos0, valid,
                       is_final):
        """Dense arena: gather the lanes of ``slot_ids`` (distinct)."""
        sid = self._dev(slot_ids, torch.long)
        lanes = {n: (k[sid], v[sid]) for n, (k, v) in state.caches.items()}
        return self._prefill_write(state, fh, lanes, chunks, pos0,
                                   is_final, valid,
                                   np.asarray(slot_ids)[valid], pos0)

    def _prefill_batch_paged(self, state, fh, rows, chunks, pos0, valid,
                             is_final):
        """Paged arena: ``rows`` is the admitted lanes' page-table rows
        (host int32 [w, max_pages]), copied to the device once. The chunk
        lands in ONE page (page_size % prefill_chunk == 0)."""
        pages = self._dev(rows)
        lanes = {n: (gather_pages(k, pages), gather_pages(v, pages))
                 for n, (k, v) in state.caches.items()}
        pg = pos0 // self.page_size
        return self._prefill_write(state, fh, lanes, chunks, pos0,
                                   is_final, valid,
                                   np.asarray(rows)[valid, pg],
                                   pos0 - pg * self.page_size)

    @torch.no_grad()
    def _commit_batch(self, state, k: int, slot_ids, fh, last_idx, plens,
                      max_news, rids):
        """First tokens of all w lanes; the first ``k`` (the admitted
        ones) arm their slots in place. Returns the packed [2, w] array
        [first token, done]."""
        w = len(slot_ids)
        sid, li, plen, mnew, rid = self._dev(
            np.stack([slot_ids, last_idx, plens, max_news, rids]),
            torch.int64)
        hsel = fh[torch.arange(w, device=self.device), li]      # [w, E]
        logits = (hsel @ self.params["tok_emb"].T).float()
        toks = self._sample(logits, rid, torch.zeros_like(rid))
        done = mnew <= 1
        if self.eos_id is not None:
            done = done | (toks == self.eos_id)
        sid = sid[:k]
        state.pos[sid] = plen[:k].to(torch.int32)
        state.active[sid] = ~done[:k]
        state.last_tok[sid] = toks[:k]
        state.remaining[sid] = (mnew[:k] - 1).to(torch.int32)
        state.tok_idx[sid] = 1
        state.key[sid] = rid[:k]
        state.generation[sid] += 1
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

    @torch.no_grad()
    def _decode_fused(self, state):
        """Every slot decodes (inactive ones at their frozen position,
        their writes landing where a later occupant rewrites them before
        anything attends)."""
        pos_in = torch.clamp(state.pos, max=self.max_len - 1)
        hid, _ = self.model._decode_slots(self.params, state.last_tok,
                                          pos_in, state.caches)
        return self._finish(state, hid)

    @torch.no_grad()
    def _decode_fused_paged(self, state, page_table):
        """Paged: ``page_table`` is the full host table, copied to the
        device once per step (a retired slot's all-zero row sinks its
        frozen writes into the null page)."""
        pos_in = torch.clamp(state.pos, max=self.max_len - 1)
        hid, _ = self.model._decode_slots(
            self.params, state.last_tok, pos_in, state.caches,
            page_table=self._dev(page_table), page_size=self.page_size)
        return self._finish(state, hid)

    # -- pool construction -------------------------------------------------

    def _init_state(self) -> SlotState:
        """Fresh all-inactive pool, dense or paged."""
        if self.paged:
            return init_paged_state(self.model, self.params, self.slots,
                                    self.max_len, self.page_size,
                                    self.kv_pages, device=self.device)
        return init_slot_state(self.model, self.params, self.slots,
                               self.max_len, device=self.device)

    def _pages_for(self, plen: int, max_new: int) -> int:
        """Worst-case pages one request reserves at admission: the padded
        prompt (chunked prefill writes pad positions) and the full
        generation budget, rounded up to pages."""
        c = self.prefill_chunk
        padded = -(-plen // c) * c
        span = max(padded, plen + max_new)
        return -(-span // self.page_size)

    def warmup(self) -> None:
        raise NotImplementedError(
            f"warmup() covers compiled-program lineages; the port has "
            f"none yet (CUDA-graph capture, {_SERVE_ROW})")

    def program_lineages(self) -> dict:
        raise NotImplementedError(
            f"program lineages and their lint are not ported yet "
            f"({_TRACE_ROW})")

    lint_programs = program_lineages

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
            live=None, flightrec=None):
        """Serve ``requests`` to completion. Returns ``(results, stats)``:
        one :class:`RequestResult` per request (input order) and the
        run-level counters ``summarize_serving`` aggregates. The engine
        never drops a request; invalid ones raise up front."""
        hooks = {"telemetry": telemetry, "tracer": tracer, "slo": slo,
                 "live": live, "flightrec": flightrec}
        armed = [k for k, v in hooks.items() if v is not None]
        if armed:
            raise NotImplementedError(
                f"run({', '.join(armed)}=...): the telemetry hooks are "
                f"not ported yet ({_TRACE_ROW})")
        if hasattr(requests, "poll"):
            raise NotImplementedError(
                f"a router feed needs the router, not ported yet "
                f"({_SERVE_ROW})")
        for r in requests:
            self.validate(r)
        order = list(requests)
        state = self._init_state()
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
        prefill_batches = 0
        batch_sizes: list = []
        queue_depth: list = []
        step_ms: list = []
        # host-side KV accounting (no device syncs)
        host_len = [0] * self.slots
        resident = {"now": 0, "peak": 0}
        pt = None
        page_pool: Optional[PagePool] = None
        kv_free_min = None
        if self.paged:
            pt = np.zeros((self.slots, self.max_pages), np.int32)
            page_pool = PagePool(self.kv_pages)
            kv_free_min = page_pool.free_count
        self._page_table = pt                 # test/debug visibility
        self._page_pool = page_pool
        t0 = time.perf_counter()

        def now() -> float:
            return time.perf_counter() - t0

        def poll() -> None:
            t = now()
            while pending and pending[0].arrival_s <= t:
                ready.append(pending.popleft())

        def retire_kv(slot: int) -> None:
            """Resident bytes drop and (paged) every page the slot held
            goes back to the pool; the table row returns to the null
            page."""
            resident["now"] -= host_len[slot]
            host_len[slot] = 0
            if pt is None:
                return
            for phys in pt[slot]:
                if phys:
                    page_pool.release(int(phys))
            pt[slot, :] = 0

        def release_slot(slot: int, rid: int, t: float, step: int) -> None:
            results[rid].finish_s = t
            self.events.append(("retire", rid, slot, step))
            retire_kv(slot)
            free.append(slot)
            free.sort()

        def first_token(req: Request, slot: int, first: int, done: bool,
                        t: float) -> None:
            res = results[req.id]
            res.tokens.append(first)
            res.token_times.append(t)
            res.first_token_s = t
            host_len[slot] = res.prompt_len   # prompt KV is resident
            resident["now"] += res.prompt_len
            resident["peak"] = max(resident["peak"], resident["now"])
            if done:                          # one-token request
                release_slot(slot, req.id, t, 0)
            else:
                busy[slot] = req

        def seat() -> tuple:
            """Pop the requests this poll admits and their slots (paged:
            while the head request's worst-case pages fit, strict FIFO)."""
            nonlocal kv_free_min
            if pt is None:
                k = min(len(ready), len(free))
                return ([ready.popleft() for _ in range(k)],
                        [free.pop(0) for _ in range(k)])
            batch, taken = [], []
            while ready and free:
                req = ready[0]
                need = self._pages_for(len(req.prompt), req.max_new)
                if not page_pool.can_alloc(need):
                    break            # head-of-line waits for pages
                ready.popleft()
                slot = free.pop(0)
                pt[slot, :] = 0
                pt[slot, :need] = page_pool.alloc(need)
                batch.append(req)
                taken.append(slot)
            kv_free_min = min(kv_free_min, page_pool.free_count)
            return batch, taken

        def admit_batch() -> None:
            """All requests ready at this poll seat in one chain:
            ceil(max P/C) prefill calls + one commit + ONE fetch."""
            nonlocal prefill_chunks, prefill_batches
            batch, taken = seat()
            if not batch:
                return
            c = self.prefill_chunk
            t_admit = now()
            for req, slot in zip(batch, taken):
                res = results[req.id]
                res.slot, res.admit_s = slot, t_admit
                host_gen[slot] += 1
                res.generation = host_gen[slot]
                self.events.append(("admit", req.id, slot, host_gen[slot]))
            k, w = len(batch), self.slots
            pad = [0] * (w - k)
            plens = [len(r.prompt) for r in batch]
            n_chunks = [-(-p // c) for p in plens]
            # distinct lane -> slot map: the admitted slots, then every
            # other slot as a masked padding lane
            slot_ids = np.asarray(
                taken + [s for s in range(w) if s not in taken], np.int64)
            rows = pt[slot_ids] if pt is not None else None
            tok_mat = np.zeros((w, max(n_chunks) * c), np.int64)
            for lane, req in enumerate(batch):
                tok_mat[lane, :plens[lane]] = req.prompt
            fh = torch.zeros((w, c, self.model.embed_dim),
                             dtype=self._hid_dtype, device=self.device)
            for ci in range(max(n_chunks)):
                valid = np.asarray([ci < n for n in n_chunks]
                                   + [False] * (w - k))
                is_final = np.asarray([ci == n - 1 for n in n_chunks]
                                      + [False] * (w - k))
                chunk = tok_mat[:, ci * c:(ci + 1) * c]
                if pt is None:
                    fh = self._prefill_batch(state, fh, slot_ids, chunk,
                                             ci * c, valid, is_final)
                else:
                    fh = self._prefill_batch_paged(state, fh, rows, chunk,
                                                   ci * c, valid, is_final)
                prefill_chunks += 1
            packed = self._commit_batch(
                state, k, slot_ids, fh, [(p - 1) % c for p in plens] + pad,
                plens + pad, [r.max_new for r in batch] + [1] * (w - k),
                [r.id for r in batch] + pad)
            packed = packed.cpu().numpy()     # ONE sync: every lane's TTFT
            t = now()
            prefill_batches += 1
            batch_sizes.append(k)
            firsts, dones = packed
            for lane, (req, slot) in enumerate(zip(batch, taken)):
                first_token(req, slot, int(firsts[lane]),
                            bool(dones[lane]), t)

        while pending or ready or busy:
            poll()
            admitted = False
            may_admit = (not busy) if self.policy == "static" else True
            if ready and free and may_admit:
                n_before = prefill_batches
                admit_batch()
                # the paged gate may admit nothing (head-of-line waiting
                # for pages): only count a real admission
                admitted = prefill_batches > n_before
                poll()                # prefill took wall time
            if busy:
                t_dispatch = time.perf_counter()
                if pt is not None:
                    packed = self._decode_fused_paged(state, pt)
                else:
                    packed = self._decode_fused(state)
                packed = packed.cpu().numpy()   # the ONE sync per step
                t_now = now()
                step_ms.append((time.perf_counter() - t_dispatch) * 1e3)
                decode_steps += 1
                toks, active, emitted = packed
                occupancy_sum += int(emitted.sum())
                queue_depth.append(len(ready))
                for slot in list(busy):
                    if not emitted[slot]:
                        continue
                    rid = busy[slot].id
                    res = results[rid]
                    res.tokens.append(int(toks[slot]))
                    res.token_times.append(t_now)
                    host_len[slot] += 1       # this step's KV write
                    resident["now"] += 1
                    if not active[slot]:
                        del busy[slot]
                        release_slot(slot, rid, t_now, decode_steps)
                resident["peak"] = max(resident["peak"], resident["now"])
            elif not admitted and (pending or ready):
                # idle: the next arrival is in the future (or the paged
                # gate is waiting on pages)
                if pending:
                    dt = pending[0].arrival_s - now()
                    if dt > 0:
                        time.sleep(min(dt, 0.001))
                else:
                    time.sleep(0.0005)

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
        if self.paged:
            stats.update(
                page_size=self.page_size,
                kv_pages=self.kv_pages,
                kv_pages_free=page_pool.free_count,
                kv_pages_free_min=kv_free_min,
            )
        return [results[r.id] for r in order], stats
