"""Contributed layers (counterpart of ``apex_tpu/contrib``); import
``apex_tpu_torch.contrib.<pkg>`` directly."""
