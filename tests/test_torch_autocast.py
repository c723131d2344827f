"""Port parity: O1 — ``amp.autocast``, its op ``lists``, the precision
decorators of ``amp.functions``, ``initialize(fn, opt_level="O1")`` and
``amp.master_params`` — against the JAX package's.

The op table: for each class of ``lists`` (and promotion of a 0-d tensor
and of a Python number) a tiny function of fp32 inputs; the dtype its
last op gives under the port's policy must equal the one it gives under
``apex_tpu.amp.autocast`` (read from the rewritten jaxpr, before the
output's cast back). The products return fp32 there (their traced
``preferred_element_type``) and the convolutions bf16, so the classes
after them are held on a convolution's output. Then the port of
tests/test_amp.py's ``TestAutocast``: the MLP within that file's atol 0.05
of fp32 with fp32 grads, a custom ``autograd.Function`` behind the
``custom_grad`` boundary keeping its own backward, the tiny TransformerLM
under O1 with grads (the JAX side's flash kernel in interpret mode, as
tests/test_amp.py:193-210 runs it), and a checkpointed block surviving
O1 (:212-229).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu import amp as jamp
from apex_tpu.models import TransformerLM as JLM
from apex_tpu.ops import dispatch as jdispatch
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu_torch import amp
from apex_tpu_torch.amp.autocast import AutocastMode, custom_grad
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM
from apex_tpu_torch.ops import flat as TF
from apex_tpu_torch.optimizers import FusedAdam


def _inputs():
    rs = np.random.RandomState(0)
    return {"x": rs.randn(4, 8).astype(np.float32),
            "w": (rs.randn(8, 8) * 0.3).astype(np.float32),
            "b": rs.randn(8).astype(np.float32),
            "s": np.float32(1.5)}


def _tc(x, w):
    return F.conv2d(x[None, None], w[None, None, :3, :3])


def _jc(x, w):
    return jax.lax.conv_general_dilated(x[None, None], w[None, None, :3, :3],
                                        (1, 1), "VALID")


def _both(tfn, jfn=None):
    """A case on the bf16 convolution output h of both packages: ``tfn``
    of the port's h, ``jfn`` (``tfn`` where the same code serves both) of
    JAX's; s is the fp32 0-d input."""
    jfn = jfn or tfn
    return (lambda x, w, b, s: tfn(_tc(x, w), s),
            lambda x, w, b, s: jfn(_jc(x, w), s))


# name -> (port fn, JAX fn) of fp32 (x, w, b, s). Under JAX's policy a jnp
# product (x @ w) takes bf16 operands and returns fp32, the
# preferred_element_type it was traced with; a convolution returns bf16,
# so the other classes are held on a convolution's output h
OPS = {
    # HALF: the products, and the bias added after them under promotion
    "matmul": (lambda x, w, b, s: x @ w, lambda x, w, b, s: x @ w),
    "mm": (lambda x, w, b, s: torch.mm(x, w),
           lambda x, w, b, s: jnp.dot(x, w)),
    "bmm": (lambda x, w, b, s: torch.bmm(x[None], w[None]),
            lambda x, w, b, s: jnp.matmul(x[None], w[None])),
    "einsum": (lambda x, w, b, s: torch.einsum("ij,jk->ik", x, w),
               lambda x, w, b, s: jnp.einsum("ij,jk->ik", x, w)),
    "linear": (lambda x, w, b, s: F.linear(x, w.T),
               lambda x, w, b, s: x @ w),
    "linear_bias": (lambda x, w, b, s: F.linear(x, w.T, b),
                    lambda x, w, b, s: x @ w + b),
    "addmm": (lambda x, w, b, s: torch.addmm(b, x, w),
              lambda x, w, b, s: b + x @ w),
    "conv2d": _both(lambda h, s: h),
    "conv2d_bias": (lambda x, w, b, s: F.conv2d(
                        x[None, None], w[None, None, :3, :3], b[:1]),
                    lambda x, w, b, s: _jc(x, w) + b[:1, None, None]),
    # FP32: the fragile primitives and the composites through them
    "exp": _both(lambda h, s: torch.exp(h), lambda h, s: jnp.exp(h)),
    "log1p": _both(lambda h, s: torch.log1p(h.abs()),
                   lambda h, s: jnp.log1p(jnp.abs(h))),
    "pow": _both(lambda h, s: h.abs() ** 1.5,
                 lambda h, s: jnp.abs(h) ** 1.5),
    "rsqrt": _both(lambda h, s: torch.rsqrt(h.abs() + h.abs()),
                   lambda h, s: jax.lax.rsqrt(jnp.abs(h) + jnp.abs(h))),
    "erf": _both(lambda h, s: torch.erf(h),
                 lambda h, s: jax.scipy.special.erf(h)),
    "sum": _both(lambda h, s: h.sum(), lambda h, s: jnp.sum(h)),
    "cumsum": _both(lambda h, s: torch.cumsum(h, 3),
                    lambda h, s: jnp.cumsum(h, 3)),
    "mean": _both(lambda h, s: h.mean(), lambda h, s: jnp.mean(h)),
    "var": _both(lambda h, s: torch.var(h, unbiased=False),
                 lambda h, s: jnp.var(h)),
    "logsumexp": _both(lambda h, s: torch.logsumexp(h, -1),
                       lambda h, s: jax.nn.logsumexp(h, -1)),
    "softmax": _both(lambda h, s: F.softmax(h, -1),
                     lambda h, s: jax.nn.softmax(h, -1)),
    "log_softmax": _both(lambda h, s: F.log_softmax(h, -1),
                         lambda h, s: jax.nn.log_softmax(h, -1)),
    "relu": _both(lambda h, s: F.relu(h), lambda h, s: jax.nn.relu(h)),
    "mse_loss": _both(lambda h, s: F.mse_loss(h, h.flip(-1)),
                      lambda h, s: jnp.mean(jnp.square(h - h[..., ::-1]))),
    # neither table: the dtype that reaches the op
    "tanh": _both(lambda h, s: torch.tanh(h), lambda h, s: jnp.tanh(h)),
    "sigmoid": _both(lambda h, s: torch.sigmoid(h),
                     lambda h, s: jax.nn.sigmoid(h)),
    "silu": _both(lambda h, s: F.silu(h), lambda h, s: jax.nn.silu(h)),
    "abs": _both(lambda h, s: h.abs(), lambda h, s: jnp.abs(h)),
    "sqrt": _both(lambda h, s: h.abs().sqrt(),
                  lambda h, s: jnp.sqrt(jnp.abs(h))),
    "square": _both(lambda h, s: h ** 2),
    "amax": _both(lambda h, s: h.amax(-1), lambda h, s: jnp.max(h, -1)),
    "reshape": _both(lambda h, s: h.reshape(-1)),
    "cat": _both(lambda h, s: torch.cat([h, h]),
                 lambda h, s: jnp.concatenate([h, h])),
    "resize": _both(lambda h, s: F.interpolate(h, scale_factor=2,
                                               mode="nearest"),
                    lambda h, s: jax.image.resize(h, (1, 1, 4, 12),
                                                  "nearest")),
    # promotion: every tensor is strong, a 0-d one too, and a Python
    # number in an op is an fp32 literal of JAX's trace
    "half_half": _both(lambda h, s: h * h),
    "half_div": _both(lambda h, s: h / (h + h)),
    "strong_0d": _both(lambda h, s: h + s),
    "strong_0d_left": _both(lambda h, s: s * h),
    "strong_dims": (lambda x, w, b, s: _tc(x, w) - x[:2, :6],
                    lambda x, w, b, s: _jc(x, w) - x[:2, :6]),
    "number": _both(lambda h, s: h * 0.2),
    "int_number": _both(lambda h, s: h - 1),
    "clamp": _both(lambda h, s: h.clamp(-1.0, 1.0),
                   lambda h, s: jnp.clip(h, -1.0, 1.0)),
    "where_number": _both(lambda h, s: torch.where(h > 0, h, 0.0),
                          lambda h, s: jnp.where(h > 0, h, 0.0)),
    "where_0d": _both(lambda h, s: torch.where(h > 0, h, s),
                      lambda h, s: jnp.where(h > 0, h, s)),
    "gelu": _both(lambda h, s: F.gelu(h, approximate="tanh"),
                  lambda h, s: jax.nn.gelu(h)),
    "leaky_relu": _both(lambda h, s: F.leaky_relu(h, 0.2),
                        lambda h, s: jax.nn.leaky_relu(h, 0.2)),
    "elu": _both(lambda h, s: F.elu(h), lambda h, s: jax.nn.elu(h)),
    "maximum_0d": _both(lambda h, s: torch.maximum(h, s),
                        lambda h, s: jnp.maximum(h, s)),
}


def _jax_dtype(fn, args):
    """The dtype of ``fn``'s result under the JAX policy: the rewritten
    jaxpr's output before its cast back to the traced dtype."""
    jx = jax.make_jaxpr(jamp.autocast(fn))(*args).jaxpr
    out = jx.outvars[0]
    for eqn in jx.eqns:
        if out in eqn.outvars and \
                eqn.primitive.name == "convert_element_type":
            return jnp.dtype(eqn.invars[0].aval.dtype).name
    return jnp.dtype(out.aval.dtype).name


@pytest.mark.parametrize("name", list(OPS))
def test_op_table_gives_jax_dtypes(name):
    port_fn, jax_fn = OPS[name]
    a = _inputs()
    targs = [torch.tensor(a[k]) for k in "xwbs"]
    with AutocastMode(torch.bfloat16):
        got = port_fn(*targs)
    want = _jax_dtype(jax_fn, [jnp.asarray(a[k]) for k in "xwbs"])
    assert str(got.dtype).rsplit(".", 1)[-1] == want, (got.dtype, want)
    # the wrapper casts back to fp32, the inputs' dtype
    assert amp.autocast(port_fn)(*targs).dtype == torch.float32


def test_lists_name_the_torch_forms_of_each_op():
    L = amp.lists
    for fn in (torch.matmul, torch.Tensor.matmul, torch.mm, F.linear,
               F.conv2d, torch.einsum, torch.baddbmm):
        assert fn in L.HALF
    for fn in (torch.exp, torch.Tensor.exp, torch.sum, torch.Tensor.sum,
               torch.log1p, F.softmax, torch.Tensor.softmax, F.relu,
               torch.special.erf, torch.linalg.vector_norm, F.cross_entropy,
               torch.rsqrt, torch.cumsum):
        assert fn in L.FP32
    assert not L.HALF & L.FP32
    assert torch.tanh not in L.HALF | L.FP32


# -- tests/test_amp.py's TestAutocast, ported ---------------------------------

def _mlp_params():
    rng = np.random.default_rng(0)
    return {"w1": (rng.normal(size=(16, 32)) * 0.1).astype(np.float32),
            "b1": np.zeros((32,), np.float32),
            "w2": (rng.normal(size=(32, 10)) * 0.1).astype(np.float32)}


def _mlp(p, x):
    h = F.relu(x @ p["w1"] + p["b1"])
    return F.log_softmax(h @ p["w2"], dim=-1)


def _j_mlp(p, x):
    h = jax.nn.relu(x @ p["w1"] + p["b1"])
    return jax.nn.log_softmax(h @ p["w2"])


def test_mlp_values_dtypes_and_fp32_grads():
    p = _mlp_params()
    x = np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    wrapped = amp.autocast(_mlp)
    seen = []

    def spy(p, x):
        seen.append(x @ p["w1"])
        return _mlp(p, x)

    amp.autocast(spy)(tp, torch.tensor(x))
    # bf16 operands, an fp32 product: JAX's dot_general with
    # preferred_element_type float32
    with torch.no_grad():
        assert torch.equal(seen[0], torch.tensor(x).bfloat16().float()
                           @ tp["w1"].bfloat16().float())
        assert not torch.equal(seen[0], torch.tensor(x) @ tp["w1"])
    out = wrapped(tp, torch.tensor(x))
    assert out.dtype == torch.float32
    want = _mlp(tp, torch.tensor(x))
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=0.05)
    jout = jamp.autocast(_j_mlp)({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=0.05)
    grads = torch.autograd.grad(out.sum(), list(tp.values()))
    assert all(g.dtype == torch.float32 for g in grads)


class _Sin(torch.autograd.Function):
    calls = []

    @staticmethod
    def forward(ctx, x):
        _Sin.calls.append(("fwd", x.dtype))
        ctx.save_for_backward(x)
        return torch.sin(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        _Sin.calls.append(("bwd", g.dtype))
        return g * torch.cos(x) * 3.0        # deliberately non-standard


@custom_grad
def _sin(x):
    return _Sin.apply(x)


def test_custom_grad_boundary_keeps_its_backward_at_fp32():
    p = {k: torch.tensor(v, requires_grad=True)
         for k, v in _mlp_params().items()}
    x = torch.ones(4, 16)

    def model(p, x):
        return _sin(x @ p["w1"]).sum()       # the product in bf16

    _Sin.calls.clear()
    (g,) = torch.autograd.grad(amp.autocast(model)(p, x), [p["w1"]])
    assert ("fwd", torch.float32) in _Sin.calls
    assert ("bwd", torch.float32) in _Sin.calls
    (ref,) = torch.autograd.grad(model(p, x), [p["w1"]])
    np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=0.1)
    assert g.dtype == torch.float32


def test_boundary_is_the_function_itself_without_a_policy():
    x = torch.ones(3, dtype=torch.bfloat16)
    _Sin.calls.clear()
    _sin(x)
    assert _Sin.calls == [("fwd", torch.bfloat16)]


LM = dict(vocab_size=64, max_seq_len=32, embed_dim=32, num_heads=2,
          num_layers=1, attn_impl="fast")


def test_o1_transformer_grads_match_jax():
    jm = JLM(**LM)
    jp = jm.init(jax.random.key(0))
    toks = np.asarray(jax.random.randint(jax.random.key(1), (2, 17), 0, 64))
    with jdispatch.backend("pallas"):       # interpret-mode Pallas on CPU
        jg = jax.grad(lambda p: jamp.autocast(jm.loss)(p, jnp.asarray(
            toks)))(jp)
    tm = TransformerLM(**LM, device="cpu")
    tp = TF.tree_map(lambda t: t.requires_grad_(True),
                     params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu"))
    wrapped, handle = amp.initialize(tm.loss, opt_level="O1", verbosity=0)
    assert handle.policy.autocast
    loss = wrapped(tp, torch.from_numpy(toks))
    assert loss.dtype == torch.float32
    leaves = TF.tree_leaves(tp)
    g = torch.autograd.grad(loss, leaves)
    ref = torch.autograd.grad(tm.loss(tp, torch.from_numpy(toks)), leaves)
    for a, r, j in zip(g, ref, jax.tree.leaves(jg)):
        assert a.dtype == r.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=0.05)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=0.05)


def test_o1_takes_the_fp32_forms_of_flash_and_layer_norm(monkeypatch):
    """Under O1 the LM's LayerNorms and attention get fp32 inputs at their
    custom_grad boundaries (the kernels' fp32 forms on the card)."""
    import sys

    from apex_tpu_torch.ops import flash_attn as FA
    LN = sys.modules["apex_tpu_torch.normalization.fused_layer_norm"]
    seen = []
    for mod, name in ((FA, "flash_fwd"), (LN, "ln_fwd")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen.append((_name, a[0].dtype))
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    tm = TransformerLM(**LM, device="cpu")
    tp = tm.init(0)
    toks = torch.randint(0, 64, (2, 17), generator=torch.Generator()
                         .manual_seed(1))
    amp.autocast(tm.loss)(tp, toks)
    assert {n for n, _ in seen} == {"flash_fwd", "ln_fwd"}
    assert all(dt == torch.float32 for _, dt in seen)


def test_remat_survives_o1():
    """A rematerialized block keeps the policy in its recompute (its
    product on bf16 operands both times, its convolution in bf16) and its
    gradient matches the fp32 one; a plain checkpoint recomputes without
    the policy."""
    from torch.utils.checkpoint import checkpoint

    from apex_tpu_torch.models._remat import remat
    p = {k: torch.tensor(v, requires_grad=True)
         for k, v in _mlp_params().items()}
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(2))
    rounded = x.bfloat16().float() @ p["w1"].detach().bfloat16().float()
    seen = []

    def blk(h):
        y = h @ p["w1"]
        seen.append(torch.equal(y.detach(), rounded))
        return torch.tanh(y)

    def model(p, x):
        return remat(blk)(x).sum()

    (g,) = torch.autograd.grad(amp.autocast(model)(p, x), [p["w1"]])
    assert seen == [True, True]                      # forward, recompute
    (ref,) = torch.autograd.grad(model(p, x), [p["w1"]])
    np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=0.05)
    seen.clear()
    torch.autograd.grad(amp.autocast(lambda p, x: checkpoint(
        blk, x, use_reentrant=False).sum())(p, x), [p["w1"]])
    assert seen == [True, False]

    def conv_blk(h):
        return torch.tanh(F.conv1d(h[None], p["w1"][:2, :3, None]))

    # a bf16 convolution without the policy in the recompute is fp32 there:
    # the checkpoint refuses the recomputed metadata
    with pytest.raises(Exception, match="[Rr]ecomputed"):
        torch.autograd.grad(amp.autocast(lambda p, x: checkpoint(
            conv_blk, x.T[:3], use_reentrant=False).sum())(p, x),
            [p["w1"]])
    (g,) = torch.autograd.grad(amp.autocast(
        lambda p, x: remat(conv_blk)(x.T[:3]).sum())(p, x), [p["w1"]])
    assert g.dtype == torch.float32


# -- the decorators, initialize and master_params -----------------------------

DECOS = {"half": (amp.half_function, jamp.half_function),
         "float": (amp.float_function, jamp.float_function),
         "promote": (amp.promote_function, jamp.promote_function)}


@pytest.mark.parametrize("name", list(DECOS))
def test_decorators_cast_as_jax_does(name):
    tdeco, jdeco = DECOS[name]
    rs = np.random.RandomState(3)
    a, b = rs.randn(3).astype(np.float32), rs.randn(3)
    idx = np.arange(3, dtype=np.int32)

    def dtypes(x, tree, i):
        return [str(t.dtype).rsplit(".", 1)[-1] for t in
                (x, tree["b"][0], i)]

    def jdtypes(x, tree, i):
        return [jnp.dtype(t.dtype).name for t in (x, tree["b"][0], i)]

    got = tdeco(dtypes)(torch.tensor(a, dtype=torch.bfloat16),
                        {"b": [torch.tensor(b, dtype=torch.float32)]},
                        torch.tensor(idx))
    want = jdeco(jdtypes)(jnp.asarray(a, jnp.bfloat16),
                          {"b": [jnp.asarray(b, jnp.float32)]},
                          jnp.asarray(idx))
    assert got == want


@pytest.mark.parametrize("name", list(DECOS))
def test_register_rebinds_a_module_attribute(name):
    register = getattr(amp, f"register_{name}_function")
    jregister = getattr(jamp, f"register_{name}_function")
    mod = types.SimpleNamespace(f=lambda x, y: (x.dtype, y.dtype))
    jmod = types.SimpleNamespace(f=lambda x, y: (jnp.dtype(x.dtype).name,
                                                 jnp.dtype(y.dtype).name))
    register(mod, "f")
    jregister(jmod, "f")
    got = mod.f(torch.ones(2, dtype=torch.bfloat16), torch.ones(2))
    want = jmod.f(jnp.ones(2, jnp.bfloat16), jnp.ones(2))
    assert [str(d).rsplit(".", 1)[-1] for d in got] == list(want)


def test_initialize_o1_and_master_params_match_jax():
    p = _mlp_params()
    tp = {k: torch.tensor(v) for k, v in p.items()}
    wrapped, handle = amp.initialize(_mlp, opt_level="O1", verbosity=0)
    _, jhandle = jamp.initialize(opt_level="O1", verbosity=0)
    assert handle.policy.compute_dtype == torch.bfloat16
    assert handle.policy.cast_model_dtype is None
    assert handle.policy.loss_scale == jhandle.policy.loss_scale
    x = torch.ones(4, 16)
    assert wrapped(tp, x).dtype == torch.float32
    torch.testing.assert_close(wrapped(tp, x), amp.autocast(_mlp)(tp, x),
                               rtol=0, atol=0)
    opt = FusedAdam(tp, device="cpu")
    jopt = JAdam({k: jnp.asarray(v) for k, v in p.items()})
    got = list(amp.master_params(opt))
    want = list(jamp.master_params(jopt))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
