"""Models of the port (counterpart of ``apex_tpu/models``)."""

from apex_tpu_torch.models.transformer import TransformerLM  # noqa: F401
