"""Port parity: the fused-MLP API (``apex_tpu/mlp``).

The JAX package's ``MLP.init`` weights, converted with
``params_from_jax``, through both packages' ``apply`` on the same numpy
batch: outputs, and the gradients of a weighted sum of them with respect
to every weight, bias and the input, in fp32 at 1e-5 (relative and
absolute: the frameworks' matmuls sum in another order). Every activation,
with and without bias. The port's own ``init`` draws the reference's
shapes and scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.mlp import MLP as JMLP
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.mlp import MLP, mlp

SIZES = [48, 64, 32, 16, 1]
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("bias", [True, False])
def test_outputs_and_grads_match_jax(activation, bias):
    jm = JMLP(SIZES, bias=bias, activation=activation)
    jp = jm.init(jax.random.key(1))
    tm = MLP(SIZES, bias=bias, activation=activation, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(2)
    x = rng.randn(33, SIZES[0]).astype(np.float32)
    w = rng.randn(33, SIZES[-1]).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jm.apply(p, xx) * w)

    want_y = np.asarray(jm.apply(jp, jnp.asarray(x)))
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: t.clone().requires_grad_(True) for k, t in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm.apply(leaves, xt)
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), **TOL)
    assert set(leaves) == set(want_gp)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_gp[k]),
                                   **TOL)


def test_init_shapes_scales_and_surface():
    m = MLP([480, 1024, 1024, 512, 256, 1], device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    assert m.num_layers == 5 and len(p) == 10
    assert tuple(p["weight_0"].shape) == (1024, 480)
    assert tuple(p["bias_4"].shape) == (1,)
    std = float(p["weight_1"].std())
    assert abs(std - (2.0 / 2048) ** 0.5) < 0.002
    torch.testing.assert_close(p["weight_2"], m.init(0)["weight_2"],
                               rtol=0, atol=0)
    assert "bias_0" not in MLP([4, 2], bias=False, device="cpu").init(0)
    x = torch.randn(3, 480)
    torch.testing.assert_close(m(p, x), mlp(p, x, num_layers=5), rtol=0,
                               atol=0)
    assert (m(p, x) >= 0).all()               # relu after the last layer
    assert "MLP sizes" in m.extra_repr()
    with pytest.raises(ValueError, match="mlp_sizes"):
        m.apply(p, torch.zeros(3, 8))
    with pytest.raises(TypeError, match="activation"):
        MLP([4, 2], activation="tanh", device="cpu")
    with pytest.raises(TypeError, match="activation"):
        mlp(p, x, num_layers=5, activation="gelu")
