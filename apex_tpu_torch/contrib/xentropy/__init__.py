"""Softmax cross-entropy (counterpart of ``apex_tpu/contrib/xentropy``)."""

from apex_tpu_torch.contrib.xentropy.linear_xentropy import (  # noqa: F401
    linear_cross_entropy,
)
from apex_tpu_torch.contrib.xentropy.softmax_xentropy import (  # noqa: F401
    SoftmaxCrossEntropyLoss, select_label_logits,
    softmax_cross_entropy_loss,
)
