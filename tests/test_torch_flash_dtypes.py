"""Port parity: flash attention at the head dims and dtypes the port's
kernels now take.

On the card bf16 and fp16 at a head dim up to 128 go to the tensor-core
kernels with q, k, v (and dO) zero-padded to 64 or 128 and the outputs
sliced back (``padded_head_dim``, ``_pad_d``, ``_unpad``; the JAX package
pads D to 128 lanes), the real D's scale passed; past 128 their forward,
dq and dk/dv go, padded to 256, to the D-256 kernels
(tests/test_torch_flash_d256.py), and past 256 their forward and dq to
the D-384/512 kernels (tests/test_torch_flash_d512.py) and dk/dv to the
simple form, as fp32 past 256 does. Here, on the CPU: the padding itself (pad, the plain
versions at the padded width with the real scale, slice) against the JAX
package's ``flash_attention`` (its Pallas kernels in interpret mode) at D
96 and 32, forward, lse and the gradients; and the port's
``flash_attention`` in fp16 and fp32 through its plain versions against
JAX's in the same dtype, forward and backward. Tolerances: fp32 1e-5
(the packages sum the keys in other orders); fp16 2e-3 relative and
absolute (one fp16 rounding, 2^-11, of outputs of order one, and the
JAX kernel's fp16 products).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.contrib.multihead_attn import flash_attention
from apex_tpu_torch.ops import flash_attn as FA

JFA = importlib.import_module(
    "apex_tpu.contrib.multihead_attn.flash_attention")


def _case(bh, s, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(bh, s, d).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, do, causal, dtype=jnp.float32):
    scale = 1.0 / np.sqrt(q.shape[-1])

    def fn(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, causal=causal, scale=scale,
                                   return_lse=True)

    (o, lse), vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    grads = vjp((jnp.asarray(do, dtype), jnp.zeros(lse.shape, lse.dtype)))
    return [np.asarray(t, np.float32) for t in (o, lse, *grads)]


@pytest.mark.parametrize("d,dp", [(1, 64), (32, 64), (64, 64), (65, 128),
                                  (96, 128), (128, 128), (129, 256),
                                  (200, 256), (256, 256)])
def test_padded_head_dim(d, dp):
    assert FA.padded_head_dim(d) == dp


@pytest.mark.parametrize("dtype,d,tc,forms", [
    (torch.bfloat16, 32, True, ("tc", "tc", "tc")),
    (torch.float16, 128, True, ("tc", "tc", "tc")),
    (torch.float16, 129, False, ("tc256", "tc256", "tc256")),
    (torch.bfloat16, 256, False, ("tc256", "tc256", "tc256")),
    (torch.float32, 64, False, ("f32", "f32", "f32")),
    (torch.float32, 256, False, ("f32", "f32", "f32")),
    (torch.bfloat16, 512, False, ("tc512",) * 3),
    (torch.float16, 257, False, ("tc512",) * 3),
    (torch.float32, 257, False, ("f32_512",) * 3)])
def test_the_form_follows_dtype_and_head_dim(dtype, d, tc, forms):
    """``tensor_cores``: every 16-bit kernel on the tensor cores (D <= 128);
    past 128 the forward, dq and dk/dv take their D-256 form up to 256
    and their D-384/512 form up to 512; fp32 to 256 its 3xTF32 forward, dq
    and dk/dv, past it all three in 3xTF32 at D 384 or 512."""
    q = torch.zeros(2, 3, d, dtype=dtype)
    assert FA.tensor_cores(q) == tc
    assert tuple(FA.kernel_form(q, k) for k in ("fwd", "dq", "dkv")) == forms


@pytest.mark.parametrize("d", [96, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_padding_matches_jax(d, causal):
    """Pad to the kernels' width, run the plain versions there with the
    real D's scale, slice: JAX's o, lse, dq, dk and dv."""
    q, k, v, do = _case(2, 75, d, seed=d)
    want = _jax(q, k, v, do, causal)
    dp = FA.padded_head_dim(d)
    scale = 1.0 / np.sqrt(d)
    qp, kp, vp, dop = (FA._pad_d(torch.from_numpy(a), dp)
                       for a in (q, k, v, do))
    assert qp.shape[-1] == dp and bool((qp[..., d:] == 0).all())
    o, lse = FA._fwd_plain(qp, kp, vp, causal=causal, scale=scale,
                           q_start=0, k_start=0, kv_bias=None, bias=None,
                           dropout_rate=0.0, dropout_seed=0)
    # the padded columns of o are exactly zero: zero columns of v
    assert bool((o[..., d:] == 0).all())
    delta = FA.flash_delta(o, dop)
    dq, dk, dv = FA.flash_bwd_plain(qp, kp, vp, dop, lse, delta,
                                    causal=causal, scale=scale)
    got = [FA._unpad(t, d) for t in (o, dq, dk, dv)]
    for g, w in zip([got[0], lse, *got[1:]], want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["float16", "float32"])
@pytest.mark.parametrize("d", [64, 96])
def test_fp16_and_fp32_plain_match_jax(name, d):
    """The port's flash_attention on CPU tensors of the dtype against
    JAX's in the same dtype: the output in the input dtype, fp32 lse."""
    q, k, v, do = _case(2, 70, d, seed=3 + d)
    jdt = getattr(jnp, name)
    want = _jax(q, k, v, do, True, jdt)
    dt = getattr(torch, name)
    ts = [torch.from_numpy(np.array(jnp.asarray(a, jdt), np.float32))
          .to(dt) for a in (q, k, v)]
    for t in ts:
        t.requires_grad_(True)
    o, lse = flash_attention(*ts, causal=True, return_lse=True)
    assert o.dtype == dt and lse.dtype == torch.float32
    grads = torch.autograd.grad(o, ts, torch.from_numpy(
        np.array(jnp.asarray(do, jdt), np.float32)).to(dt))
    tol = 1e-5 if name == "float32" else 2e-3
    for g, w in zip([o, lse, *grads], want):
        assert g.dtype in (dt, torch.float32)
        np.testing.assert_allclose(g.detach().float().numpy(), w, atol=tol,
                                   rtol=tol)


def test_simple_form_wrappers_run_the_plain_versions_on_the_cpu():
    q, k, v, do = (torch.from_numpy(a) for a in _case(2, 33, 200, seed=9))
    kw = dict(causal=True, scale=200 ** -0.5)
    before = (FA.flash_simt_fwd.launches, FA.flash_simt_dq.launches,
              FA.flash_simt_dkv.launches)
    o, lse = FA.flash_simt_fwd(q, k, v, **kw)
    o0, lse0 = FA.reference_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_simt_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_simt_dkv(q, k, v, do, lse, delta, **kw)
    for a, b0 in zip((dq, dk, dv), FA.flash_bwd_plain(q, k, v, do, lse,
                                                      delta, **kw)):
        assert torch.equal(a, b0)
    assert (FA.flash_simt_fwd.launches, FA.flash_simt_dq.launches,
            FA.flash_simt_dkv.launches) == before
