"""Multihead attention (counterpart of
``apex_tpu/contrib/multihead_attn``): flash attention and the unfused
reference attention, the single-query slot decode attention, and the
self and encoder-decoder attention modules."""

from apex_tpu_torch.contrib.multihead_attn.decode_attention import (  # noqa: F401
    reference_slot_decode_attention, slot_decode_attention,
)
from apex_tpu_torch.contrib.multihead_attn.flash_attention import (  # noqa: F401
    DEFAULT_FLASH_MIN_S, flash_attention, reference_attention,
)
from apex_tpu_torch.contrib.multihead_attn.modules import (  # noqa: F401
    EncdecMultiheadAttn, SelfMultiheadAttn,
)
