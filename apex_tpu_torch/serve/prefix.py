# Copied verbatim from apex_tpu/serve/prefix.py (stdlib only), so the port
# imports nothing of the JAX package; the engine's prefix_share=True runs
# on it.
"""Content-hashed shared-prefix page cache (r20) — prefill once, map
everywhere.

A million-user deployment serves one system prompt to almost every
request; the dense engine re-prefills it per admission. With the paged
arena the common prefix becomes SHAREABLE state: pages are keyed by a
**chain hash** of their token content (``h_0 = H(tokens[0:page])``,
``h_i = H(h_{i-1} || tokens[i*page:(i+1)*page])`` — the vLLM prefix-
caching construction), so two prompts share page ``i`` iff they agree
on ALL tokens up to ``(i+1)*page``. Causal attention makes the share
sound: K/V at position p depends only on tokens ``<= p``, so a cached
page's bytes are bit-identical to what the hitting request's own
prefill would have written.

Sharing is **page-granular copy-on-write**: a hit maps the cached
physical pages into the requester's page table read-only (refcount +1
per mapping) and the COPY that COW would require never happens,
because writes cannot reach a shared page by construction — prefill
resumes at the first non-shared chunk and decode writes at positions
``>= prompt_len``, both past the shared span. The unaligned tail of a
common prefix (and always at least the final prompt chunk, whose
hidden state the commit needs) is re-prefilled privately.

Eviction: entries are LRU by last hit, deepest chain links first, and
only pages whose refcount is down to the cache's own hold are
reclaimable — eviction never invalidates a live mapping. A missing
chain link simply shortens future matches (orphaned deeper links age
out; they are waste, never corruption).

Stdlib-only on purpose: ``serve.router`` imports
:func:`prefix_route_key` for the ``prefix-affinity`` policy, and the
router must stay importable without jax/numpy (the fleet_smoke parent
contract).
"""

from __future__ import annotations

import hashlib
from typing import Optional

__all__ = ["PrefixCache", "chain_hashes", "prefix_route_key"]


def _page_digest(prev: Optional[str], tokens) -> str:
    """One chain link: sha1 over the previous link + this page's
    tokens. Token rendering is type-agnostic (list, tuple, np array)
    and process-independent, so router-side keys and engine-side cache
    keys agree."""
    h = hashlib.sha1()
    if prev is not None:
        h.update(prev.encode())
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()


def chain_hashes(prompt, page_size: int, n_pages: int) -> list:
    """Chain hashes of the first ``n_pages`` full pages of ``prompt``
    (caller guarantees ``n_pages * page_size <= len(prompt)``)."""
    out = []
    prev = None
    for i in range(n_pages):
        prev = _page_digest(prev, prompt[i * page_size:(i + 1)
                                         * page_size])
        out.append(prev)
    return out


def prefix_route_key(prompt, page_size: int) -> Optional[str]:
    """The router-side affinity key: the FIRST page's chain hash (the
    coarsest shareable unit — every deeper share implies this one), or
    None for prompts shorter than one page (fall back to load-based
    routing). Routing by this key keeps a hot prefix's cached pages
    replica-local, which is what makes the prefix cache pay at fleet
    scale."""
    if len(prompt) < page_size:
        return None
    return _page_digest(None, prompt[:page_size])


class PrefixCache:
    """chain-hash -> physical-page map with LRU eviction.

    The cache holds its OWN reference on every inserted page (the
    engine's :class:`~apex_tpu.serve.slots.PagePool` refcounts), so a
    cached page survives its inserting request's retirement; a mapped
    page's extra refs are live requests, which is why eviction skips
    any entry whose refcount exceeds the cache's hold."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        # chain -> {"page": phys, "depth": i, "used": tick}
        self._entries: dict = {}
        self._tick = 0
        self.hits = 0            # pages served from cache
        self.lookups = 0         # match() calls
        self.inserts = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pages(self) -> list:
        return [e["page"] for e in self._entries.values()]

    def match(self, prompt, n_max: int) -> list:
        """Longest cached prefix of ``prompt``, capped at ``n_max``
        pages: ``[(page_index, physical_page, chain_hash), ...]`` for
        the consecutive leading hits (possibly empty). Caller retains
        each returned page before mapping it."""
        self.lookups += 1
        self._tick += 1
        out = []
        prev = None
        for i in range(n_max):
            prev = _page_digest(
                prev, prompt[i * self.page_size:(i + 1)
                             * self.page_size])
            e = self._entries.get(prev)
            if e is None:
                break
            e["used"] = self._tick
            out.append((i, e["page"], prev))
        self.hits += len(out)
        return out

    def insert(self, chain: str, page: int, depth: int) -> bool:
        """Register an already-written page under its chain hash; the
        caller must hold (and transfer) one reference for the cache.
        False (no ref transfer) when the chain is already cached."""
        if chain in self._entries:
            return False
        self._tick += 1
        self._entries[chain] = {"page": int(page), "depth": int(depth),
                                "used": self._tick}
        self.inserts += 1
        return True

    def evict(self, pool, need: int) -> int:
        """Free cache-only pages until ``pool.can_alloc(need)`` or
        nothing evictable remains. LRU first, deepest links first
        within a tick (so a chain sheds its tail before its head and
        shallow entries keep matching). Returns pages freed."""
        freed = 0
        if pool.can_alloc(need):
            return freed
        order = sorted(self._entries.items(),
                       key=lambda kv: (kv[1]["used"], -kv[1]["depth"]))
        for chain, e in order:
            if pool.ref(e["page"]) != 1:
                continue             # live mappings pin the page
            del self._entries[chain]
            pool.release(e["page"])
            self.evictions += 1
            freed += 1
            if pool.can_alloc(need):
                break
        return freed

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "lookups": self.lookups, "inserts": self.inserts,
                "evictions": self.evictions}
