"""Op facade — counterpart of ``apex_tpu/ops/kernels.py``: the call surface
the optimizers and the AMP scaler use.

The rule is the wrappers' (``ops/multi_tensor.py``): a tensor on the CPU
runs the plain version, a tensor on the card launches the kernel. The one
guard kept from the JAX facade is ``aligned_segments``: the LAMB and
NovoGrad kernels and the per-tensor norms work over rows, which is right
only when every segment boundary is row-aligned. The caller asserts that
by passing ``aligned_segments=True``; a buffer not so asserted raises, on
the CPU and on the card alike.
"""

from __future__ import annotations

from apex_tpu_torch.ops import multi_tensor as MT

__all__ = ["MODE_L2", "MODE_DECOUPLED", "NORM_LINF", "NORM_L2",
           "all_finite", "norm_out_blend", "adam_step", "sgd_step",
           "lamb_step", "novograd_step", "l2norm_per_segment",
           "maxnorm_per_segment"]

MODE_L2 = MT.MODE_L2
MODE_DECOUPLED = MT.MODE_DECOUPLED
NORM_LINF = MT.NORM_LINF
NORM_L2 = MT.NORM_L2

all_finite = MT.all_finite
norm_out_blend = MT.norm_out_blend
adam_step = MT.adam_step
sgd_step = MT.sgd_step


def _require_aligned(what: str, table, aligned_segments: bool) -> None:
    if not (aligned_segments and table.row_aligned):
        raise ValueError(
            f"{what}: the kernels need row-aligned segments; pass "
            f"aligned_segments=True for a buffer built by ops.flat with an "
            f"align that is a multiple of 128")


def lamb_step(g, p, m, v, table, *, aligned_segments: bool = False, **kw):
    _require_aligned("lamb_step", table, aligned_segments)
    return MT.lamb_step(g, p, m, v, table, **kw)


def novograd_step(g, p, m, v_norms, table, *,
                  aligned_segments: bool = False, **kw):
    _require_aligned("novograd_step", table, aligned_segments)
    return MT.novograd_step(g, p, m, v_norms, table, **kw)


def l2norm_per_segment(x, table, *, aligned_segments: bool = False):
    _require_aligned("l2norm_per_segment", table, aligned_segments)
    return MT.l2norm_per_segment(x, table)


def maxnorm_per_segment(x, table, *, aligned_segments: bool = False):
    _require_aligned("maxnorm_per_segment", table, aligned_segments)
    return MT.maxnorm_per_segment(x, table)
