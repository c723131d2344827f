"""Softmax cross-entropy (counterpart of ``apex_tpu/contrib/xentropy``)."""

from apex_tpu_torch.contrib.xentropy.linear_xentropy import (  # noqa: F401
    linear_cross_entropy,
)
from apex_tpu_torch.contrib.xentropy.softmax_xentropy import (  # noqa: F401
    select_label_logits,
)
