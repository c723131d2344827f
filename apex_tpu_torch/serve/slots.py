"""Slot-based KV-cache pool — counterpart of ``apex_tpu/serve/slots.py``.

One preallocated arena per layer, ``[slots, heads, max_len, head_dim]``
(the dense arena), or a global page pool ``[kv_pages + 1, heads,
page_size, head_dim]`` behind a host page table (the paged arena; page 0
is the null sink that unmapped table entries point at), plus per-slot
scalars:

- ``pos`` — the absolute position the next decode step writes at;
- ``active`` — the slot mask. Inactive slots still flow through the
  batched decode step; their writes land at their frozen ``pos`` (dense)
  or in the null page (paged), where nothing reads them unmasked;
- ``last_tok`` — the token the next decode step consumes;
- ``remaining`` — the generation budget left;
- ``tok_idx`` / ``key`` — the per-request sampling stream: token ``i`` of
  request ``r`` draws from the counter stream keyed ``(seed, r, i)``
  (``key`` holds ``r``), so sampled tokens do not depend on the slot or
  on how admissions were batched;
- ``generation`` — bumped on every admission into the slot.

Where the JAX package donates and rebinds this state, the port's engine
updates the tensors in place. :class:`PagePool` is host code, copied.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import torch

from apex_tpu_torch._device import resolve_device

__all__ = ["SlotState", "PagedSlotState", "PagePool", "init_slot_state",
           "init_paged_state", "init_cache_arena", "arena_bytes",
           "arena_byte_report", "kv_token_bytes"]


@dataclasses.dataclass
class SlotState:
    """Device-resident pool state, mutated in place by the engine."""
    caches: dict              # layer_i -> (k, v), each [S, H, max_len, hd]
    pos: torch.Tensor         # i32 [S] next write position / current length
    active: torch.Tensor      # bool [S] slot serves a live request
    last_tok: torch.Tensor    # i32 [S] token the next decode step consumes
    remaining: torch.Tensor   # i32 [S] generation budget left
    tok_idx: torch.Tensor     # i32 [S] per-request sample index
    key: torch.Tensor         # i64 [S] per-request stream key (request id)
    generation: torch.Tensor  # i32 [S] admissions into this slot so far


@dataclasses.dataclass
class PagedSlotState(SlotState):
    """Paged pool state: the same per-slot scalars as :class:`SlotState`,
    K/V as a global page pool ``layer_i -> (k, v)`` each
    ``[kv_pages + 1, H, page_size, hd]`` (page 0 = null sink). The page
    table is HOST state (``np.int32 [slots, max_pages]``) owned by the
    engine and copied to the device once per program call."""


def _check_pool(model, slots: int, max_len: int) -> None:
    if max_len > model.max_seq_len:
        raise ValueError(
            f"pool max_len ({max_len}) exceeds the model's max_seq_len "
            f"({model.max_seq_len}) — the pos_emb table has no rows for "
            f"the tail")
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")


def _scalars(slots: int, dev: torch.device) -> dict:
    def z(dt):
        return torch.zeros((slots,), dtype=dt, device=dev)
    return dict(pos=z(torch.int32), active=z(torch.bool),
                last_tok=z(torch.int32), remaining=z(torch.int32),
                tok_idx=z(torch.int32), key=z(torch.int64),
                generation=z(torch.int32))


def _arena(model, params, lanes: int, length: int, dev) -> dict:
    h = model.num_heads
    hd = model.embed_dim // h
    dt = params["tok_emb"].dtype
    return {f"layer_{i}": tuple(
                torch.zeros((lanes, h, length, hd), dtype=dt, device=dev)
                for _ in range(2))
            for i in range(model.num_layers)}


def init_slot_state(model, params, slots: int, max_len: int, *,
                    device=None) -> SlotState:
    """Fresh all-inactive dense pool on ``device`` (the card unless
    ``device="cpu"``). The arena follows the parameter dtype; ``max_len``
    bounds prompt + generated length per slot and must fit the model's
    ``pos_emb``."""
    _check_pool(model, slots, max_len)
    dev = resolve_device(device)
    return SlotState(caches=_arena(model, params, slots, max_len, dev),
                     **_scalars(slots, dev))


def init_paged_state(model, params, slots: int, max_len: int,
                     page_size: int, kv_pages: int, *,
                     device=None) -> PagedSlotState:
    """Fresh all-inactive paged pool. ``kv_pages`` is the number of
    allocatable pages (the device pool holds ``kv_pages + 1``; page 0 is
    the null sink). ``max_len`` still bounds prompt + generated length per
    slot (``max_pages * page_size == max_len``)."""
    _check_pool(model, slots, max_len)
    if page_size < 1 or max_len % page_size != 0:
        raise ValueError(
            f"page_size ({page_size}) must divide max_len ({max_len}) "
            f"— the logical per-slot view must tile exactly")
    if kv_pages < max_len // page_size:
        raise ValueError(
            f"kv_pages ({kv_pages}) cannot hold even one worst-case "
            f"request ({max_len // page_size} pages of {page_size})")
    dev = resolve_device(device)
    return PagedSlotState(
        caches=_arena(model, params, kv_pages + 1, page_size, dev),
        **_scalars(slots, dev))


def init_cache_arena(model, params, lanes: int, length: int, *,
                     device=None) -> dict:
    """A bare ``layer_i -> (k, v)`` cache dict, each ``[lanes, H, length,
    hd]`` in the param dtype: the speculative draft model's KV. Dense
    engines call it as ``(slots, max_len)`` (a second arena beside the
    target's); paged engines as ``(kv_pages + 1, page_size)``, a parallel
    page pool indexed by the SAME host page table and :class:`PagePool`,
    so draft pages share reservation, eviction, refcounts and prefix
    sharing (page 0 the null sink of both pools). The target's
    :class:`SlotState` scalars govern both models."""
    if lanes < 1 or length < 1:
        raise ValueError(f"cache arena needs lanes/length >= 1, got "
                         f"({lanes}, {length})")
    return _arena(model, params, lanes, length, resolve_device(device))


# -- host page allocator: copied from apex_tpu/serve/slots.py --------------

class PagePool:
    """Host-side page allocator: free list + per-page refcounts.

    Pages are physical ids in ``[1, kv_pages]`` (0 is the null sink and
    never allocated). ``alloc`` hands out refcount-1 private pages;
    ``retain`` adds a reference; ``release`` drops one and returns the
    page to the free list when the count hits zero. A page is on the free
    list iff its refcount is 0."""

    def __init__(self, kv_pages: int):
        if kv_pages < 1:
            raise ValueError(f"kv_pages must be >= 1, got {kv_pages}")
        self.kv_pages = int(kv_pages)
        self._free = deque(range(1, self.kv_pages + 1))
        self._ref = [0] * (self.kv_pages + 1)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def ref(self, page: int) -> int:
        return self._ref[page]

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list:
        """n fresh private pages (refcount 1), lowest ids first so
        allocation order is deterministic across replays."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self._free)} "
                f"free of {self.kv_pages} — the admission gate must "
                f"check can_alloc first")
        out = [self._free.popleft() for _ in range(n)]
        for p in out:
            assert self._ref[p] == 0, f"page {p} on free list with refs"
            self._ref[p] = 1
        return out

    def retain(self, page: int) -> None:
        if not 1 <= page <= self.kv_pages or self._ref[page] < 1:
            raise ValueError(f"retain of unallocated page {page}")
        self._ref[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; True when the page went back to the free
        list."""
        if not 1 <= page <= self.kv_pages or self._ref[page] < 1:
            raise ValueError(f"release of unallocated page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            return True
        return False


def arena_bytes(state) -> int:
    """Total bytes of the preallocated K/V arena, dense or paged (shapes
    only, no device sync)."""
    return sum(a.numel() * a.element_size()
               for kv in state.caches.values() for a in kv)


def kv_token_bytes(state) -> int:
    """K+V bytes one token position costs across all layers."""
    # [*, H, L_or_page, hd]: one position = H * hd elements
    return sum(a.shape[1] * a.shape[3] * a.element_size()
               for kv in state.caches.values() for a in kv)


def arena_byte_report(state, *, resident_tokens: int = 0) -> dict:
    """RESERVED bytes (what the arena preallocates) vs RESIDENT bytes (K/V
    actually holding live tokens)."""
    return {
        "reserved": arena_bytes(state),
        "resident": int(resident_tokens) * kv_token_bytes(state),
    }
