"""Contrib optimizers — counterpart of ``apex_tpu/contrib/optimizers``:
the ZeRO optimizers ``DistributedFusedAdam`` / ``DistributedFusedLAMB``
(``ShardedState``), and the fused optimizers under their contrib names."""

from apex_tpu_torch.contrib.optimizers.distributed import (  # noqa: F401
    DistributedFusedAdam, DistributedFusedLAMB, ShardedState,
)
from apex_tpu_torch.optimizers import (  # noqa: F401
    FusedAdagrad, FusedAdam, FusedLAMB, FusedNovoGrad, FusedSGD,
)
from apex_tpu_torch.fp16_utils import FP16_Optimizer  # noqa: F401
