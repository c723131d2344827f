"""Softmax cross-entropy (counterpart of ``apex_tpu/contrib/xentropy``)."""

from apex_tpu_torch.contrib.xentropy.softmax_xentropy import (  # noqa: F401
    select_label_logits,
)
