"""Op facade — counterpart of ``apex_tpu/ops/kernels.py``: the call surface
the optimizers and the AMP scaler use.

The rule is the wrappers' (``ops/multi_tensor.py``): a tensor on the CPU
runs the plain version, a tensor on the card launches the kernel. The one
guard kept from the JAX facade is ``aligned_segments``: the LAMB kernels
take per-tensor norms over rows, which is right only when every segment
boundary is row-aligned. The caller asserts that by passing
``aligned_segments=True``; a buffer not so asserted raises, on the CPU
and on the card alike.
"""

from __future__ import annotations

from apex_tpu_torch.ops import multi_tensor as MT

__all__ = ["MODE_L2", "MODE_DECOUPLED", "all_finite", "adam_step",
           "lamb_step"]

MODE_L2 = MT.MODE_L2
MODE_DECOUPLED = MT.MODE_DECOUPLED

all_finite = MT.all_finite
adam_step = MT.adam_step


def lamb_step(g, p, m, v, table, *, aligned_segments: bool = False, **kw):
    if not (aligned_segments and table.row_aligned):
        raise ValueError(
            "lamb_step: the LAMB kernels need row-aligned segments; pass "
            "aligned_segments=True for a buffer built by ops.flat with an "
            "align that is a multiple of 128")
    return MT.lamb_step(g, p, m, v, table, **kw)
