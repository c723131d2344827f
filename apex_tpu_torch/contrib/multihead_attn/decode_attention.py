"""Slot attention: the serve decode step's attention core.

Counterpart of ``apex_tpu/contrib/multihead_attn/decode_attention.py``
(``gather_pages`` :72-85, ``reference_slot_decode_attention`` :88-136,
``slot_decode_attention`` :144-230), dense and paged, for the 1-query
``[S, H, hd]`` form and the multi-row ``[S, Q, H, hd]`` form of
speculative scoring (lengths ``[S, Q]``, each row masked to its own
length).

``slot_decode_attention`` has no crossover: the kernel wrappers of
``ops.decode_attn`` launch the hand kernel for a tensor on the card and
run the plain version for a tensor on the CPU (``dispatch.backend(
"reference")`` forces the plain version on the card). The TPU's measured
crossover (``_decode_crossover.json``, ``decode_min_l``) is not read. It
keeps the JAX module's routing rule (``supported``, ``paged_supported``,
decode_attn.py:39-50; decode_attention.py:191, :214): a shape no kernel
form takes goes to the plain version, on the card too. The kernel takes
head dims 64 and 128 (:data:`~apex_tpu_torch.ops.decode_attn.HEAD_DIMS`;
the JAX kernel takes multiples of 128, so its rule sends 64 to the
reference) and any arena length and page size, so only another head dim
is routed. Where the JAX package flattens a multi-row call into the slot
axis (K/V broadcast per row, the page table repeated), the kernel takes
the Q rows of a slot natively and reads each K/V chunk once for them.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.decode_attn import (HEAD_DIMS, decode_attention,
                                            decode_attention_plain,
                                            gather_pages,
                                            paged_decode_attention,
                                            paged_decode_attention_plain)

__all__ = ["slot_decode_attention", "reference_slot_decode_attention",
           "gather_pages"]


def reference_slot_decode_attention(q, k, v, lengths, *,
                                    scale: Optional[float] = None,
                                    page_table=None):
    """The plain version on any device: q [S, H, hd] (or [S, Q, H, hd]
    with lengths [S, Q]), k/v [S, H, L, hd] (or page pools [P_phys, H,
    page, hd] with ``page_table`` i32 [S, P]), lengths i32 [S]. The paged
    form gathers first and then runs the same ops, so it is bitwise equal
    to the dense form over the same bytes."""
    if page_table is not None:
        return paged_decode_attention_plain(q, k, v, lengths, scale=scale,
                                            page_table=page_table)
    return decode_attention_plain(q, k, v, lengths, scale=scale)


def slot_decode_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lengths: torch.Tensor, *,
                          scale: Optional[float] = None,
                          page_table=None) -> torch.Tensor:
    """Slot attention over the arena. q: [S, H, hd]; k/v: [S, H, L, hd]
    (positions past each slot's length may hold garbage); lengths: i32
    [S]. With ``page_table`` (i32 [S, P]) k/v are page pools ``[P_phys,
    H, page, hd]``. q may be ``[S, Q, H, hd]`` with lengths ``[S, Q]``
    (Q query rows a slot, row j masked to its own length; returns ``[S,
    Q, H, hd]``). Returns q's shape in q's dtype. A head dim the kernel
    does not take runs the plain version."""
    if q.shape[-1] not in HEAD_DIMS:
        return reference_slot_decode_attention(q, k, v, lengths, scale=scale,
                                               page_table=page_table)
    if page_table is not None:
        return paged_decode_attention(q, k, v, lengths, scale=scale,
                                      page_table=page_table)
    return decode_attention(q, k, v, lengths, scale=scale)
