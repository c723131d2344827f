"""Mixture-of-Experts with expert parallelism — counterpart of
``apex_tpu/contrib/moe``.

Switch-Transformer top-1 routing (GShard top-2 with ``top_k=2``) with
capacity: router logits, softmax, the top-k experts and their gates;
per-expert queues of ``ceil(tokens · k / experts · cf)`` seats claimed in
choice-priority order, overflow dropped; dispatch and combine a scatter
and a gather over an [experts · capacity + 1] buffer — static shapes, no
host sync.

Expert parallelism (``expert_axis``): every rank routes the same
(replicated) tokens, runs only its own experts' FFNs on the expert-sharded
weights, and one ``psum`` over the axis combines the outputs (each
assignment is produced by exactly one rank).
"""

from apex_tpu_torch.contrib.moe.moe import MoEMLP  # noqa: F401

__all__ = ["MoEMLP"]
