"""Legacy manual mixed-precision API — counterpart of
``apex_tpu/fp16_utils`` (the apex.fp16_utils surface); new code should
prefer :mod:`apex_tpu_torch.amp`."""

from apex_tpu_torch.fp16_utils.fp16util import (  # noqa: F401
    tofp16, network_to_half, convert_network, bn_convert_float,
    BN_convert_float, convert_module,
    prep_param_lists, model_grads_to_master_grads,
    master_params_to_model_params, to_python_float,
)
from apex_tpu_torch.fp16_utils.loss_scaler import (  # noqa: F401
    LossScaler, DynamicLossScaler,
)
from apex_tpu_torch.fp16_utils.fp16_optimizer import (  # noqa: F401
    FP16_Optimizer,
)
