"""Port parity: the axpby, global L2-norm and Adagrad ops
(``apex_tpu_torch.ops.multi_tensor`` and the ``ops.kernels`` facade) under
gradient accumulation, ``FP16_Optimizer.clip_master_grads`` and
``FusedAdagrad``.

The plain versions — what a CPU tensor runs, and what the CUDA kernels are
held against on the card — against the JAX package's Pallas kernels in
interpret mode (``P.axpby``, ``P.l2norm``, ``P.adagrad_step``, as
tests/test_pallas_kernels.py runs them) and its jnp reference (``R``), on
the same numpy inputs. Tolerances are test_pallas_kernels.py:57-124's:
rtol 1e-6 for axpby, 1e-5 for the norm, 1e-5 with atol 1e-7 for Adagrad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import reference as R
from apex_tpu.ops.pallas import multi_tensor as P
from apex_tpu_torch.ops import kernels as K
from apex_tpu_torch.ops import multi_tensor as MT

SIZES = [128, 128 * 8, 128 * 1037]   # one row, one block row, ragged grid


def _pair(a):
    return jnp.asarray(a, jnp.float32), torch.from_numpy(
        np.asarray(a, np.float32))


@pytest.mark.parametrize("arg_to_check", [-1, 0, 1])
@pytest.mark.parametrize("n", SIZES)
def test_axpby_matches_jax_and_flags_the_checked_input(n, arg_to_check):
    rs = np.random.RandomState(n + arg_to_check)
    (jx, tx), (jy, ty) = _pair(rs.randn(n)), _pair(rs.randn(n))
    got, fi = K.axpby(0.5, tx, 2.0, ty, arg_to_check)
    assert got.dtype == torch.float32 and not bool(fi)
    for want, wfi in (P.axpby(0.5, jx, 2.0, jy, arg_to_check),
                      R.axpby(0.5, jx, 2.0, jy, arg_to_check)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert not bool(wfi)
    for arg, pos, bad in (("x", 0, np.inf), ("x", n // 2, np.nan),
                          ("y", n - 1, -np.inf), ("y", 0, np.nan)):
        x, y = tx.clone(), ty.clone()
        (x if arg == "x" else y)[pos] = float(bad)
        want = arg_to_check == -1 or arg_to_check == (0 if arg == "x" else 1)
        assert bool(MT.axpby_plain(0.5, x, 2.0, y, arg_to_check)[1]) == want
        jfi = P.axpby(0.5, jnp.asarray(x.numpy()), 2.0,
                      jnp.asarray(y.numpy()), arg_to_check)[1]
        assert bool(jfi) == want


def test_axpby_keeps_x_dtype_and_takes_device_scalars():
    """unscale_with_stashed's form: a = 1/scale a 0-d fp32 tensor, b = 1;
    the output in x's dtype, the math in fp32."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(256).astype(np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rs.randn(256).astype(np.float32))
    a = torch.tensor(0.25)
    got, fi = MT.axpby(a, x, 1.0, y, 0)
    want = (0.25 * x.float() + y).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and not bool(fi)
    assert torch.equal(got, want)
    jwant, _ = R.axpby(jnp.float32(0.25), jnp.asarray(x.float().numpy(),
                                                      jnp.bfloat16),
                       1.0, jnp.asarray(y.numpy()), 0)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jwant, np.float32))


@pytest.mark.parametrize("n", SIZES + [1001])
def test_l2norm_matches_jax(n):
    rs = np.random.RandomState(n)
    j, t = _pair(rs.randn(n) * 3)
    got = K.l2norm(t)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(R.l2norm(j)), rtol=1e-5)
    if n % 128 == 0:
        np.testing.assert_allclose(float(got), float(P.l2norm(j)),
                                   rtol=1e-5)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("mode", [R.MODE_L2, R.MODE_DECOUPLED])
@pytest.mark.parametrize("n", SIZES)
def test_adagrad_step_matches_jax(n, mode, weight_decay):
    rs = np.random.RandomState(6)
    (jg, tg), (jp, tp) = _pair(rs.randn(n)), _pair(rs.randn(n))
    jh, th = _pair(np.abs(rs.randn(n)))
    kw = dict(lr=1e-2, eps=1e-10, mode=mode, weight_decay=weight_decay)
    got = K.adagrad_step(tg, tp, th, **kw)
    for want in (P.adagrad_step(jg, jp, jh, **kw),
                 R.adagrad_step(jg, jp, jh, **kw)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


def test_adagrad_keeps_storage_dtypes_and_zero_decay_term():
    """bf16 storage: p and h written back in bf16 from fp32 math; at wd 0
    the plain version still adds wd·p (JAX's formula), so an inf master
    turns NaN in both packages."""
    rs = np.random.RandomState(8)
    g = torch.from_numpy(rs.randn(512).astype(np.float32))
    p = torch.from_numpy(rs.randn(512).astype(np.float32))
    h = torch.from_numpy(np.abs(rs.randn(512)).astype(np.float32))
    pb, hb = p.to(torch.bfloat16), h.to(torch.bfloat16)
    sc = MT.adagrad_scalars(lr=1e-2, eps=1e-10, weight_decay=0.0,
                            device="cpu")
    po, ho = MT.adagrad(g, pb, hb, sc, MT.MODE_L2)
    assert po.dtype == ho.dtype == torch.bfloat16
    p32, h32 = MT.adagrad_plain(g, pb.float(), hb.float(), sc, MT.MODE_L2)
    assert torch.equal(po, p32.to(torch.bfloat16))
    assert torch.equal(ho, h32.to(torch.bfloat16))
    p[3] = float("inf")
    got, _ = MT.adagrad(g, p, h, sc, MT.MODE_L2)
    want, _ = R.adagrad_step(jnp.asarray(g.numpy()), jnp.asarray(p.numpy()),
                             jnp.asarray(h.numpy()), lr=1e-2, eps=1e-10)
    assert np.isnan(got[3].item()) and np.isnan(np.asarray(want)[3])
