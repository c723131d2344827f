"""Serving tier of the port (counterpart of ``apex_tpu/serve``): the slot
KV pool (dense and paged), the continuous-batching engine, fused and
serialized, with speculative decoding and the shared-prefix page cache,
its device programs as CUDA graphs (``serve.programs``), and synthetic
traffic with the ``serving`` summary."""

from apex_tpu_torch.serve.engine import (ContinuousBatchingEngine, Request,
                                         RequestResult, draft_from_prefix)
from apex_tpu_torch.serve.prefix import (PrefixCache, chain_hashes,
                                         prefix_route_key)
from apex_tpu_torch.serve.slots import (PagedSlotState, PagePool, SlotState,
                                        arena_byte_report, init_cache_arena,
                                        init_paged_state, init_slot_state)
from apex_tpu_torch.serve.traffic import (parse_dist, poisson_requests,
                                          summarize_serving)

__all__ = ["ContinuousBatchingEngine", "Request", "RequestResult",
           "draft_from_prefix", "SlotState", "PagedSlotState", "PagePool",
           "PrefixCache", "init_slot_state", "init_paged_state",
           "init_cache_arena", "arena_byte_report",
           "chain_hashes", "prefix_route_key", "parse_dist",
           "poisson_requests", "summarize_serving"]
