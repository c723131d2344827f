"""O1's per-op precision policy as data — counterpart of
``apex_tpu/amp/lists.py``.

The JAX package classifies jaxpr primitives; here the same policy names
the torch callables that stand for them, as ``amp.autocast``'s
``TorchFunctionMode`` sees them (``torch.matmul``, the ``Tensor`` method,
the ``torch.nn.functional`` entry):

- ``HALF``: the products, ``dot_general`` and ``conv_general_dilated``,
  run in the compute dtype. Where a torch op adds a bias or an input to
  the product (``F.linear``, the convolutions, ``addmm``), only the
  product is; the add promotes as any other op, as the JAX package's
  separate ``add`` after the dot does.
- ``FP32``: the numerically fragile primitives run in fp32; beside them
  the torch composites whose JAX counterpart reduces through one of them
  (``mean`` through ``reduce_sum``, the norms through ``reduce_sum`` and
  ``rsqrt``, the losses through ``log`` and ``reduce_sum``) and those
  that are a ``custom_jvp`` in JAX (``jax.nn.relu``, ``relu6``,
  ``softmax``, ``log_softmax``, ``logaddexp``), which run at the dtype
  they were traced at: fp32, under O1's fp32 masters.
- Everything else is in neither table: it runs in the dtype that reaches
  it, mixed float operands promoted to the widest (``autocast``). A
  Python number counts as an fp32 operand where it is one
  (``SCALAR_OPERAND``), and the activations whose JAX form holds such a
  number (``CONSTANT``) promote as if it were there: JAX traces a number
  of an fp32 program as an fp32 literal (``jnp`` promotes it against the
  fp32 operand while tracing), so under the policy ``h * 0.2``,
  ``jnp.clip(h, -1, 1)`` and ``jax.nn.gelu(h)`` of a bf16 ``h`` are fp32,
  while ``jnp.tanh(h)``, ``h * h`` and ``h ** 2`` (``integer_pow``) stay
  bf16.

Each name carries the primitive it stands for.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["HALF", "FP32", "POW", "SCALAR_OPERAND", "CONSTANT",
           "HALF_NAMES", "FP32_NAMES", "BIAS_ARG"]

# the places torch exposes an op under the same name
_SPACES = (torch, torch.Tensor, F, torch.special, torch.linalg)

# dot_general_p and conv_general_dilated_p
HALF_NAMES = (
    "matmul", "__matmul__", "__rmatmul__",   # dot_general
    "mm", "bmm", "mv", "dot", "inner",       # dot_general
    "tensordot", "einsum",                   # dot_general
    "addmm", "addmv", "baddbmm",             # dot_general, then add
    "linear",                                # dot_general, then add
    "conv1d", "conv2d", "conv3d",            # conv_general_dilated
    "conv_transpose1d", "conv_transpose2d",  # conv_general_dilated
    "conv_transpose3d",                      # conv_general_dilated
)

FP32_NAMES = (
    # the primitives of FP32_PRIMS
    "exp", "exp2", "log", "log1p", "expm1",  # exp_p, exp2_p, log_p, ...
    "log2", "log10",                         # log_p, then a scale
    "pow", "float_power",                    # pow_p
    "__pow__", "__rpow__",                   # pow_p
    "erf", "erfc", "erfinv",                 # erf_p, erfc_p, erf_inv_p
    "lgamma", "gammaln", "digamma", "psi",   # lgamma_p, digamma_p
    "sum", "nansum", "prod",                 # reduce_sum_p, reduce_prod_p
    "cumsum", "cumprod", "logcumsumexp",     # cumsum_p, cumprod_p, ...
    "rsqrt",                                 # rsqrt_p
    # composites that reduce through reduce_sum_p (and rsqrt_p, log_p)
    "mean", "nanmean",                       # reduce_sum_p
    "var", "std", "var_mean", "std_mean",    # reduce_sum_p
    "norm", "vector_norm", "matrix_norm",    # reduce_sum_p, sqrt
    "normalize", "cosine_similarity",        # reduce_sum_p
    "logsumexp",                             # exp_p, reduce_sum_p, log_p
    "softmin",                               # exp_p, reduce_sum_p
    "layer_norm", "group_norm",              # reduce_sum_p, rsqrt_p
    "batch_norm", "instance_norm",           # reduce_sum_p, rsqrt_p
    "local_response_norm",                   # reduce_sum_p, pow_p
    "xlogy", "entr",                         # log_p
    # the losses: log_p and reduce_sum_p
    "cross_entropy", "nll_loss", "kl_div",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "mse_loss", "l1_loss", "smooth_l1_loss", "huber_loss",
    "soft_margin_loss", "multilabel_soft_margin_loss",
    "poisson_nll_loss", "gaussian_nll_loss", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss",
    "triplet_margin_loss",
    # custom_jvp in JAX, run at their traced dtype (fp32 under O1)
    "softmax", "log_softmax",                # jax.nn.softmax, log_softmax
    "relu", "relu6",                         # jax.nn.relu, relu6
    "softplus", "logsigmoid",                # jnp.logaddexp
    "logaddexp", "logaddexp2",               # jnp.logaddexp
)


def _callables(names) -> frozenset:
    out = set()
    for name in names:
        for space in _SPACES:
            fn = getattr(space, name, None)
            if callable(fn):
                out.add(fn)
    return frozenset(out)


HALF = _callables(HALF_NAMES)
FP32 = _callables(FP32_NAMES)

# the half ops that add a bias or an input to their product: the argument
# (position, keyword) that holds it
BIAS_ARG = {name: pos for names, pos in (
    (("linear", "conv1d", "conv2d", "conv3d", "conv_transpose1d",
      "conv_transpose2d", "conv_transpose3d"), (2, "bias")),
    (("addmm", "addmv", "baddbmm"), (0, "input")))
    for name in names}

# ``x ** n`` with a Python int ``n`` is integer_pow_p in JAX, which is in
# neither table: these take that exponent at argument 1 (or "exponent")
POW = _callables(("pow", "__pow__"))

# the ops whose Python-number arguments are operands: add_p, sub_p, mul_p,
# div_p, max_p / min_p (clamp), select_n (where), rem_p
SCALAR_OPERAND = frozenset((
    "add", "sub", "subtract", "rsub", "mul", "multiply", "div", "divide",
    "true_divide", "__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
    "__rmul__", "__truediv__", "__rtruediv__", "__div__", "__rdiv__",
    "clamp", "clip", "clamp_min", "clamp_max", "where", "masked_fill",
    "fmod", "remainder", "__mod__", "__rmod__", "lerp"))

# the activations whose JAX form multiplies, adds or compares with a number
# (jax.nn.gelu, leaky_relu, elu, selu, celu, hard_tanh, hard_sigmoid,
# hard_swish, soft_sign; dropout's 1 / (1 - rate))
CONSTANT = frozenset((
    "gelu", "leaky_relu", "elu", "selu", "celu", "hardtanh", "hardsigmoid",
    "hardswish", "softsign", "dropout"))
