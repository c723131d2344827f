"""Port parity: the fp32 flash forward and backward on the tensor cores in
3xTF32 (``ops/cuda/csrc/flash_f32.cu``: ``flash_f32_fwd``,
``flash_f32_dq``, ``flash_f32_dkv``).

What the kernels do is testable here without them:

- the route: ``kernel_form`` sends fp32 at a head dim up to 256 to these
  kernels, the forward and the backward alike (``flash_fwd``,
  ``flash_bwd_dq`` and ``flash_bwd_dkv`` reach them, the wrappers stubbed
  and the card pretended); bf16/fp16 to the 16-bit tensor-core ones (to
  256 by their D-256 kernels) and any dtype past 256 to the simple form;
  ``tensor_cores`` names the 16-bit kernels alone (fp32's forward and
  dq past 256: tests/test_torch_flash_f32_d512.py);
- the arithmetic: a plain model of the 3xTF32 products (each fp32 operand
  split into big = tf32(x) and small = tf32(x - big), rounded as
  ``cvt.rna`` does, to nearest with ties away; each product small·big +
  big·small + big·big) run through the plain backward at [2, 256, 64]
  causal with a ``kv_bias`` and dropout 0.1 holds against the JAX package's
  ``flash_attention`` gradients (its Pallas kernels in interpret mode)
  within the fp32 flash rule, 2 ulps + 2^-14 of the larger of the row's
  and the tensor's RMS, unchanged from the card's; one TF32 pass fails
  it, so the rule tells the two apart and the split is needed; a model
  of the forward kernel's arithmetic (keys in tiles of 64, the online
  softmax in log2 units, O rescaled in fp32 and each tile's P·V added from
  a fresh accumulator, every product in 3xTF32) holds against the JAX
  package's ``flash_attention`` forward, o under the same rule and lse
  within 1e-4, where one TF32 pass fails the rule; so does the model at
  head dim 200, padded to 256, in the D-256 kernel's tiles of 8 keys; and
  a model of dq's and dk/dv's arithmetic at D 256 (keys, and queries, in
  the pair kernels' tiles; the staged rows split as the warps read them,
  big rounded and small truncated, P and dS rounded) at head dim 200
  holds the JAX package's gradients under the rule, where one TF32 pass
  fails it;
- the fragment maps: a numpy model of ``mma.sync.m16n8k8`` with TF32
  operands (PTX's register layouts of A, B and the accumulator) gives QKᵀ
  from the K-major loads, and P·K from P's accumulator registers taken as
  the A operand with the kernels' k-permutation (A's k = t from column
  2t, k = t + 4 from column 2t + 1; B's rows 2t and 2t + 1), exactly; the
  unpermuted registers do not. The padded row stride D + 4 puts every
  fragment load of a warp on 32 distinct banks.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import flash_attn as FA

JFA = importlib.import_module(
    "apex_tpu.contrib.multihead_attn.flash_attention")


# -- the route ---------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,form", [
    (torch.float32, 1, "f32"), (torch.float32, 64, "f32"),
    (torch.float32, 128, "f32"), (torch.float32, 129, "f32"),
    (torch.float32, 256, "f32"), (torch.float32, 257, "f32_512"),
    (torch.float32, 512, "f32_512"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 129, "tc256")])
def test_backward_form_follows_dtype_and_head_dim(dtype, d, form):
    """``form`` is dk/dv's, dq's and the forward's alike (bf16/fp16 at D
    129-256 on the tensor cores at D 256, fp32 in 3xTF32 at D 256, fp32
    past 256 in 3xTF32 at D 384 or 512, "f32_512")."""
    q = torch.zeros(2, 3, d, dtype=dtype)
    assert FA.kernel_form(q, "dkv") == form
    assert FA.kernel_form(q, "dq") == form
    assert FA.kernel_form(q, "fwd") == form
    # tensor_cores names the 16-bit kernels alone
    assert FA.tensor_cores(q) == (form == "tc")


@pytest.mark.parametrize("d,wrapper", [(1, "flash_f32_fwd"),
                                       (64, "flash_f32_fwd"),
                                       (128, "flash_f32_fwd"),
                                       (129, "flash_f32_fwd"),
                                       (256, "flash_f32_fwd"),
                                       (257, "flash_f32_d512_fwd"),
                                       (512, "flash_f32_d512_fwd")])
def test_forward_sends_fp32_to_the_form_kernel_form_names(d, wrapper,
                                                          monkeypatch):
    """``flash_fwd`` on the card: fp32 at D <= 256 to ``flash_f32_fwd``,
    past 256 to ``flash_f32_d512_fwd`` (the wrappers stubbed, the card
    pretended), never the simple form."""
    calls = []
    for name in ("flash_f32_fwd", "flash_f32_d512_fwd", "flash_simt_fwd"):
        monkeypatch.setattr(FA, name, lambda *a, _n=name, **kw: calls.append(
            (_n, kw["scale"])))
    monkeypatch.setattr(FA.dispatch, "use_kernel", lambda t: True)
    q = torch.zeros(2, 3, d)
    FA.flash_fwd(q, q, q, causal=True)
    assert calls == [(wrapper, 1.0 / float(d) ** 0.5)]


@pytest.mark.parametrize("d,form", [(1, "f32"), (64, "f32"), (128, "f32"),
                                    (129, "f32"), (200, "f32"),
                                    (256, "f32"), (257, "f32_d512"),
                                    (512, "f32_d512")])
def test_backward_sends_fp32_to_the_form_kernel_form_names(d, form,
                                                           monkeypatch):
    """``flash_bwd_dq`` and ``flash_bwd_dkv`` on the card: fp32 at D <= 256
    to ``flash_f32_dq`` and ``flash_f32_dkv`` (at D 129-256 the pair
    kernels), past 256 to ``flash_f32_d512_dq`` and ``flash_f32_d512_dkv``
    (the wrappers stubbed, the card pretended), never the simple form,
    every argument passed on."""
    calls = []
    for name in ("flash_f32_dq", "flash_f32_dkv", "flash_simt_dq",
                 "flash_simt_dkv", "flash_f32_d512_dq",
                 "flash_f32_d512_dkv"):
        monkeypatch.setattr(FA, name, lambda *a, _n=name, **kw: calls.append(
            (_n, len(a), kw["scale"], kw["dropout_rate"])))
    monkeypatch.setattr(FA.dispatch, "use_kernel", lambda t: True)
    q = torch.zeros(2, 3, d)
    lse = torch.zeros(2, 3)
    kw = dict(causal=True, scale=0.25, dropout_rate=0.1, dropout_seed=5)
    FA.flash_bwd_dq(q, q, q, q, lse, lse, **kw)
    FA.flash_bwd_dkv(q, q, q, q, lse, lse, **kw)
    assert calls == [(f"flash_{form}_dq", 6, 0.25, 0.1),
                     (f"flash_{form}_dkv", 6, 0.25, 0.1)]


def test_f32_fwd_runs_the_plain_version_on_the_cpu_and_refuses():
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(2, 33, 48).astype(np.float32))
               for _ in range(3))
    kvb = torch.from_numpy(np.where(rs.rand(2, 33) < 0.3, -1e30, 0.0)
                           .astype(np.float32))
    kw = dict(causal=True, kv_bias=kvb, dropout_rate=0.1, dropout_seed=3)
    before = (FA.flash_f32_fwd.launches, FA.flash_simt_fwd.launches)
    o, lse = FA.flash_f32_fwd(q, k, v, **kw)
    o0, lse0 = FA.reference_attention(q, k, v, return_lse=True,
                                      scale=48 ** -0.5, **kw)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    assert all(torch.equal(a, b) for a, b in
               zip(FA.flash_fwd(q, k, v, **kw), (o0, lse0)))
    assert (FA.flash_f32_fwd.launches, FA.flash_simt_fwd.launches) == before
    # what the fp32 kernels do not take, refused before any launch (the
    # forward takes D 129-256, padded to 256)
    for t in (q.bfloat16(), torch.zeros(2, 33, 257)):
        with pytest.raises(ValueError, match="takes fp32 at a head dim"):
            FA._f32_ready("flash_f32_fwd", t, t, t)
    wide = FA._f32_ready("flash_f32_fwd", *(torch.zeros(2, 33, 129),) * 3)
    assert all(t.shape == (2, 33, 256) for t in wide)
    with pytest.raises(ValueError, match="one BH and D"):
        FA._f32_ready("flash_f32_fwd", q, k, torch.zeros(2, 33, 64))
    # padded to 64, readable in place: the 16-byte copies' contract
    qp, kp, _ = FA._f32_ready("flash_f32_fwd", q, k, v)
    assert qp.shape == kp.shape == (2, 33, 64)
    assert bool((qp[..., 48:] == 0).all()) and torch.equal(qp[..., :48], q)


def test_f32_wrappers_run_the_plain_versions_on_the_cpu_and_refuse():
    rs = np.random.RandomState(4)
    q, k, v, do = (torch.from_numpy(rs.randn(2, 33, 48).astype(np.float32))
                   for _ in range(4))
    kw = dict(causal=True, scale=48 ** -0.5)
    o, lse = FA.reference_attention(q, k, v, return_lse=True, **kw)
    delta = FA.flash_delta(o, do)
    fns = (FA.flash_f32_dq, FA.flash_f32_dkv, FA.flash_simt_dq,
           FA.flash_simt_dkv)
    before = [f.launches for f in fns]
    want = FA.flash_bwd_plain(q, k, v, do, lse, delta, **kw)
    got = (FA.flash_f32_dq(q, k, v, do, lse, delta, **kw),
           *FA.flash_f32_dkv(q, k, v, do, lse, delta, **kw))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                       want[0])
    assert [f.launches for f in fns] == before
    with pytest.raises(ValueError, match="return_ds needs the bias"):
        FA.flash_f32_dq(q, k, v, do, lse, delta, return_ds=True, **kw)
    # what the fp32 kernels do not take, refused before any launch; D
    # 129-256 padded to 256
    for t in (q.bfloat16(), torch.zeros(2, 33, 257)):
        with pytest.raises(ValueError, match="takes fp32 at a head dim"):
            FA._bwd_args("flash_f32_dq", t, t, t, t, lse, delta, "f32")
    wide = torch.zeros(2, 33, 129)
    got = FA._bwd_args("flash_f32_dq", wide, wide, wide, wide, lse, delta,
                       "f32")
    assert all(t.shape == (2, 33, 256) for t in got[:4])


# -- the arithmetic: 3xTF32 against one TF32 pass ---------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 stored mantissa bits) as ``cvt.rna.tf32.f32``
    does: to nearest, ties away from zero, on the bit pattern (adding half
    of the dropped 13 bits' unit to the magnitude, then clearing them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _products(passes: int):
    """A matmul whose operands go through the tensor cores' TF32: three
    passes (small·big + big·small + big·big, the kernels') or one."""
    mm = torch.matmul

    def matmul(a, b):
        ab, bb = tf32(a), tf32(b)
        if passes == 1:
            return mm(ab, bb)
        return mm(tf32(a - ab), bb) + mm(ab, tf32(b - bb)) + mm(ab, bb)
    return matmul


def _rule_used(got, want):
    """The largest |got - want| over the fp32 flash rule's limit, 2 ulps +
    2^-14 of the larger of the row's RMS and the tensor's (chip_smoke.py's
    ``flash_err``): the rule holds at <= 1."""
    a, b = got.float(), want.float()

    def ulp(t):
        return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - 24)
    rms = torch.clamp(b.pow(2).mean(-1, keepdim=True).sqrt(),
                      min=float(b.pow(2).mean().sqrt()))
    lim = 2 * torch.maximum(ulp(a), ulp(b)) + 2.0 ** -14 * rms
    return float(((a - b).abs() / lim).max())


def test_tf32_rounds_to_nearest_with_ties_away():
    one = 1.0 + 2.0 ** -10                 # a TF32 value: kept
    tie = 1.0 + 2.0 ** -11                 # halfway: away from zero
    below = 1.0 + 2.0 ** -11 - 2.0 ** -23  # under half: down
    x = torch.tensor([one, tie, below, -tie, 3.0e-39, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one, one, 1.0, -one, 3.0e-39, -0.0])
    got = tf32(x)
    assert torch.equal(got[:4], want[:4])
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    big = tf32(x[:4])
    # the split is exact to ~2^-22: x - big - tf32(x - big) is tiny
    rest = (x[:4] - big) - tf32(x[:4] - big)
    assert bool((rest.abs() <= 2.0 ** -22 * x[:4].abs()).all())


@pytest.fixture(scope="module")
def jax_case():
    """[2, 256, 64] causal with a kv_bias (a quarter of the keys masked)
    and dropout 0.1: the inputs, the JAX package's o, lse, dq, dk, dv."""
    rs = np.random.RandomState(12)
    bh, s, d = 2, 256, 64
    q, k, v, do = (rs.randn(bh, s, d).astype(np.float32) for _ in range(4))
    kvb = np.where(rs.rand(bh, s) < 0.25, -1.0e30, 0.0).astype(np.float32)
    kw = dict(causal=True, scale=d ** -0.5, dropout_rate=0.1,
              dropout_seed=77)

    def fn(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, kv_bias=jnp.asarray(kvb),
                                   return_lse=True, **kw)

    (o, lse), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.zeros(lse.shape, lse.dtype)))
    return (q, k, v, do, kvb, kw,
            [np.array(t, np.float32) for t in (o, lse, *grads)])


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "tf32"])
def test_tf32_products_against_jax_under_the_fp32_rule(jax_case, passes,
                                                       monkeypatch):
    q, k, v, do, kvb, kw, want = jax_case
    q, k, v, do, kvb = (torch.from_numpy(a) for a in (q, k, v, do, kvb))
    o, lse = FA.reference_attention(q, k, v, kv_bias=kvb, return_lse=True,
                                    **kw)
    np.testing.assert_allclose(o.numpy(), want[0], atol=1e-5, rtol=1e-5)
    delta = FA.flash_delta(o, do)
    # every product of the backward (QKᵀ, dO·Vᵀ, dS·K, Pᵀ·dO, dSᵀ·Q)
    # through the tensor cores' TF32
    monkeypatch.setattr(torch, "matmul", _products(passes))
    got = FA.flash_bwd_plain(q, k, v, do, lse, delta, kv_bias=kvb, **kw)
    monkeypatch.undo()
    used = [_rule_used(g, torch.from_numpy(w))
            for g, w in zip(got, want[2:])]
    if passes == 3:
        assert max(used) <= 1.0, used
    else:
        # one pass rounds each operand to 2^-11: far past the rule
        assert min(used) > 4.0, used


def _fwd_model(q, k, v, kv_bias, *, causal, scale, dropout_rate,
               dropout_seed, passes, bk=64):
    """``f32_fwd_kernel``'s arithmetic in plain PyTorch: keys in tiles of
    ``bk``; S = Q Kᵀ through ``_products(passes)`` over pairs of k-steps
    (16 columns of D each), added in fp32; scores in log2 units with the
    kv_bias, kNegInf where masked; the running max m and sum l of the
    online softmax, p summed undropped into l and then dropped; O scaled
    by alpha in fp32 and each tile's P·V (through the same products) added
    from a fresh accumulator; o = O / l, lse = m·ln 2 + log l."""
    mm = _products(passes)
    bh, sq, d = q.shape
    sk = k.shape[1]
    log2e = 1.0 / math.log(2.0)
    neg = torch.tensor(FA.NEG_INF)
    m = torch.full((bh, sq), FA.NEG_INF)
    l_sum = torch.zeros(bh, sq)
    acc = torch.zeros(bh, sq, d)
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, bk):
        k1 = min(k0 + bk, sk)
        kt, vt = k[:, k0:k1], v[:, k0:k1]
        s = sum(mm(q[..., c:c + 16], kt[..., c:c + 16].transpose(1, 2))
                for c in range(0, d, 16))
        s = s * (scale * log2e) + kv_bias[:, None, k0:k1] * log2e
        if causal:
            s = torch.where(qpos >= torch.arange(k0, k1)[None, :], s, neg)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.where(s > FA.NEG_INF * 0.5, torch.exp2(s - mx[..., None]),
                        torch.zeros(()))
        l_sum = l_sum * alpha + p.sum(-1)
        m = mx
        if dropout_rate > 0.0:
            keep = FA._keep(torch.arange(bh)[:, None, None], qpos[None],
                            torch.arange(k0, k1)[None, None, :],
                            dropout_rate, dropout_seed)
            p = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros(()))
        acc = acc * alpha[..., None] + mm(p, vt)
    o = acc / torch.where(l_sum > 0, l_sum, torch.ones(()))[..., None]
    lse = torch.where(l_sum > 0, m * math.log(2.0) + torch.log(l_sum), neg)
    return o, lse


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "tf32"])
def test_forward_model_against_jax_under_the_fp32_rule(jax_case, passes):
    q, k, v, _, kvb, kw, want = jax_case
    q, k, v, kvb = (torch.from_numpy(a) for a in (q, k, v, kvb))
    o, lse = _fwd_model(q, k, v, kvb, passes=passes, **kw)
    used = _rule_used(o, torch.from_numpy(want[0]))
    lse_err = float((lse - torch.from_numpy(want[1])).abs().max())
    if passes == 3:
        assert used <= 1.0 and lse_err <= 1e-4, (used, lse_err)
    else:
        # one pass rounds each operand to 2^-11: far past the rule
        assert used > 4.0, used


# the D-256 forward's staged keys a tile (flash_f32.cu's f_fwd_tile<256>)
D256_KEYS = 8


@pytest.fixture(scope="module")
def jax_case_d256():
    """[2, 112, 200] causal with a kv_bias (a quarter of the keys masked)
    and dropout 0.1, at a head dim the fp32 forward pads to 256: the
    inputs, the JAX package's o and lse."""
    rs = np.random.RandomState(13)
    bh, s, d = 2, 112, 200
    q, k, v = (rs.randn(bh, s, d).astype(np.float32) for _ in range(3))
    kvb = np.where(rs.rand(bh, s) < 0.25, -1.0e30, 0.0).astype(np.float32)
    kw = dict(causal=True, scale=d ** -0.5, dropout_rate=0.1,
              dropout_seed=78)
    o, lse = JFA.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 kv_bias=jnp.asarray(kvb), return_lse=True,
                                 **kw)
    return q, k, v, kvb, kw, [np.array(t, np.float32) for t in (o, lse)]


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "tf32"])
def test_forward_model_at_d256_against_jax_under_the_fp32_rule(
        jax_case_d256, passes):
    """The forward kernel's arithmetic at head dim 200 as the kernel runs
    it: padded to 256, the real D's scale, keys in tiles of
    ``D256_KEYS``, sliced back: 3xTF32 holds JAX's o under the fp32 rule
    and lse within 1e-4; one TF32 pass fails the rule."""
    q, k, v, kvb, kw, want = jax_case_d256
    d = q.shape[-1]
    q, k, v = (FA._pad_d(torch.from_numpy(a), FA.padded_head_dim(d))
               for a in (q, k, v))
    assert q.shape[-1] == 256
    o, lse = _fwd_model(q, k, v, torch.from_numpy(kvb), passes=passes,
                        bk=D256_KEYS, **kw)
    assert not o[..., d:].any()
    used = _rule_used(FA._unpad(o, d), torch.from_numpy(want[0]))
    lse_err = float((lse - torch.from_numpy(want[1])).abs().max())
    if passes == 3:
        assert used <= 1.0 and lse_err <= 1e-4, (used, lse_err)
    else:
        assert used > 4.0, used


# the D-256 dq's and dk/dv's staged rows a tile (flash_f32.cu's
# p_tile<false>, p_tile<true>), and whether the block's own rows and the
# staged tiles are split as the warps read them (p_own_raw, p_tile_raw)
D256_BWD_KEYS, D256_BWD_QUERIES = 16, 16
D256_BWD_OWN_RAW, D256_BWD_TILE_RAW = True, True


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 as the tensor cores read a TF32 operand whose low 13 bits were
    left in place: those bits cleared (toward zero)."""
    bits = x.contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _split(x: torch.Tensor, raw: bool):
    """(big, small) of the 3xTF32 products: big = tf32(x) either way (the
    integer rounding of ``split_raw`` is ``cvt.rna``'s); small rounded by
    ``cvt.rna`` where a value is split once, truncated where it is split
    as read (``split_raw`` leaves its low bits to the tensor cores)."""
    big = tf32(x)
    return big, (tf32_trunc if raw else tf32)(x - big)


def _mm3(a, b, a_raw: bool, b_raw: bool, passes: int):
    """a @ b through the tensor cores' TF32: small·big + big·small +
    big·big (each operand split as ``_split``), or one pass."""
    if passes == 1:
        return torch.matmul(tf32(a), tf32(b))
    ab, as_ = _split(a, a_raw)
    bb, bs = _split(b.contiguous(), b_raw)
    return (torch.matmul(as_, bb) + torch.matmul(ab, bs)
            + torch.matmul(ab, bb))


def _chunked(a, b, a_raw, b_raw, passes):
    """a @ bᵀ over D in pairs of k-steps (16 columns), each from a fresh
    accumulator, added in fp32 (``product_t``)."""
    return sum(_mm3(a[..., c:c + 16], b[..., c:c + 16].transpose(-1, -2),
                    a_raw, b_raw, passes)
               for c in range(0, a.shape[-1], 16))


def _bwd_model_d256(q, k, v, do, lse, delta, kv_bias, *, causal, scale,
                    dropout_rate, dropout_seed, passes):
    """``f32_dq_pair_kernel``'s and ``f32_dkv_pair_kernel``'s arithmetic
    in plain PyTorch: dq over key tiles of ``D256_BWD_KEYS`` (S = Q Kᵀ and
    dP = dO Vᵀ by ``_chunked``; P from the scores in log2 units with the
    kv_bias, 0 where masked; dP dropped and rescaled; dS = P (dP − δ); each
    tile's dS K from a fresh accumulator, added in fp32), dk and dv over
    query tiles of ``D256_BWD_QUERIES`` (Sᵀ = K Qᵀ, dPᵀ = V dOᵀ; Pᵀ dropped
    for dv += Pᵀ dO, dSᵀ = Pᵀ (dPᵀ' − δ) for dk += dSᵀ Q); the staged rows
    split as ``D256_BWD_OWN_RAW`` and ``D256_BWD_TILE_RAW`` say, P and dS
    rounded."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    log2e = 1.0 / math.log(2.0)
    own, tile = D256_BWD_OWN_RAW, D256_BWD_TILE_RAW
    lse2 = lse * log2e

    def probs(s, qi, kj):
        """P (undropped) and the keep-mask of the scores s [bh, len(qi),
        len(kj)]."""
        s = s * (scale * log2e) + kv_bias[:, None, kj] * log2e
        vis = (qi[:, None] < sq) & (kj[None, :] < sk)
        if causal:
            vis = vis & (qi[:, None] >= kj[None, :])
        s = torch.where(vis, s, torch.tensor(FA.NEG_INF))
        p = torch.where(s > FA.NEG_INF * 0.5,
                        torch.exp2(s - lse2[:, qi, None]), torch.zeros(()))
        keep = FA._keep(torch.arange(bh)[:, None, None], qi[None, :, None],
                        kj[None, None, :], dropout_rate, dropout_seed) \
            if dropout_rate > 0.0 else None
        return p, keep

    def dropped(x, keep):
        if keep is None:
            return x
        return torch.where(keep, x / (1.0 - dropout_rate), torch.zeros(()))

    qi_all = torch.arange(sq)
    dq = torch.zeros(bh, sq, d)
    for k0 in range(0, sk, D256_BWD_KEYS):
        kj = torch.arange(k0, min(k0 + D256_BWD_KEYS, sk))
        p, keep = probs(_chunked(q, k[:, kj], own, tile, passes), qi_all,
                        kj)
        dp = dropped(_chunked(do, v[:, kj], own, tile, passes), keep)
        ds = p * (dp - delta[..., None])
        dq = dq + _mm3(ds, k[:, kj], False, tile, passes)
    dk, dv = torch.zeros(bh, sk, d), torch.zeros(bh, sk, d)
    kj_all = torch.arange(sk)
    for q0 in range(0, sq, D256_BWD_QUERIES):
        qi = torch.arange(q0, min(q0 + D256_BWD_QUERIES, sq))
        p, keep = probs(_chunked(k, q[:, qi], own, tile,
                                 passes).transpose(1, 2), qi, kj_all)
        dp = dropped(_chunked(v, do[:, qi], own, tile,
                              passes).transpose(1, 2), keep)
        ds = p * (dp - delta[:, qi, None])
        dv = dv + _mm3(dropped(p, keep).transpose(1, 2), do[:, qi], False,
                       tile, passes)
        dk = dk + _mm3(ds.transpose(1, 2), q[:, qi], False, tile, passes)
    return dq * scale, dk * scale, dv


@pytest.fixture(scope="module")
def jax_case_d256_bwd():
    """[2, 112, 200] causal with a kv_bias (a quarter of the keys masked)
    and dropout 0.1 at a head dim the fp32 kernels pad to 256: the inputs,
    the JAX package's dq, dk, dv."""
    rs = np.random.RandomState(14)
    bh, s, d = 2, 112, 200
    q, k, v, do = (rs.randn(bh, s, d).astype(np.float32) for _ in range(4))
    kvb = np.where(rs.rand(bh, s) < 0.25, -1.0e30, 0.0).astype(np.float32)
    kw = dict(causal=True, scale=d ** -0.5, dropout_rate=0.1,
              dropout_seed=79)

    def fn(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, kv_bias=jnp.asarray(kvb),
                                   **kw)

    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return (q, k, v, do, kvb, kw, [np.array(t, np.float32) for t in grads])


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "tf32"])
def test_backward_model_at_d256_against_jax_under_the_fp32_rule(
        jax_case_d256_bwd, passes):
    """dq's and dk/dv's arithmetic at head dim 200 as the pair kernels run
    it: padded to 256, the real D's scale, in their tiles, sliced back:
    3xTF32 with the staged rows split as read holds JAX's dq, dk and dv
    under the fp32 rule; one TF32 pass fails it."""
    q, k, v, do, kvb, kw, want = jax_case_d256_bwd
    d = q.shape[-1]
    q, k, v, do, kvb = (torch.from_numpy(a) for a in (q, k, v, do, kvb))
    o, lse = FA.reference_attention(q, k, v, kv_bias=kvb, return_lse=True,
                                    **kw)
    delta = FA.flash_delta(o, do)
    padded = [FA._pad_d(t, FA.padded_head_dim(d)) for t in (q, k, v, do)]
    assert padded[0].shape[-1] == 256
    got = _bwd_model_d256(*padded, lse, delta, kvb, passes=passes, **kw)
    assert not any(t[..., d:].any() for t in got)
    used = [_rule_used(FA._unpad(g, d), torch.from_numpy(w))
            for g, w in zip(got, want)]
    if passes == 3:
        assert max(used) <= 1.0, used
    else:
        assert min(used) > 4.0, used


def test_split_as_read_truncates_small_within_2_to_the_minus_21():
    """``split_raw``'s small keeps its low 13 bits for the tensor cores to
    drop: big is cvt.rna's, and x − big − tf32_trunc(x − big) is under
    2^-21 of |x| (x − big has at most 13 significant bits, TF32 keeps 11),
    on some elements other than cvt.rna's small."""
    x = torch.from_numpy(np.random.RandomState(3).randn(4096)
                         .astype(np.float32))
    big, small = _split(x, raw=True)
    assert torch.equal(big, tf32(x))
    assert bool(((small.view(torch.int32) & 0x1FFF) == 0).all())
    rest = (x - big) - small
    assert bool((rest.abs() <= 2.0 ** -21 * x.abs()).all())
    assert not torch.equal(small, _split(x, raw=False)[1])


# -- the fragment maps of mma.sync.m16n8k8 with TF32 operands ----------------

LANES = [(lane >> 2, lane & 3) for lane in range(32)]    # (g, t)


def _mma(a_regs, b_regs):
    """D [16, 8] = A B as the instruction reads its operands: lane (g, t)
    holds A's (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) in a0-a3 and
    B's (k = t, n = g), (k = t + 4, n = g) in b0, b1."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for (g, t), ar, br in zip(LANES, a_regs, b_regs):
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = ar
        b[t, g], b[t + 4, g] = br
    return a @ b


def _acc_regs(c):
    """An accumulator tile [16, 8] as the lanes hold it: (g, 2t), (g, 2t +
    1), (g + 8, 2t), (g + 8, 2t + 1)."""
    return [(c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
             c[g + 8, 2 * t + 1]) for g, t in LANES]


def test_fragment_maps_give_the_products_and_the_permutation_is_needed():
    rs = np.random.RandomState(0)
    # small integers: every product and sum exact in float64
    qw = rs.randint(-4, 5, (16, 64)).astype(np.float64)     # a warp's rows
    kt = rs.randint(-4, 5, (64, 64)).astype(np.float64)     # a key tile
    # QKᵀ: both operands K-major (product_t)
    s = np.zeros((16, 64))
    for kk in range(8):
        a = [(qw[g, 8 * kk + t], qw[g + 8, 8 * kk + t], qw[g, 8 * kk + t + 4],
              qw[g + 8, 8 * kk + t + 4]) for g, t in LANES]
        for n in range(8):
            b = [(kt[8 * n + g, 8 * kk + t], kt[8 * n + g, 8 * kk + t + 4])
                 for g, t in LANES]
            s[:, 8 * n:8 * n + 8] += _mma(a, b)
    np.testing.assert_array_equal(s, qw @ kt.T)
    # P·K with P from its accumulator registers (product_n)
    p = rs.randint(-4, 5, (16, 64)).astype(np.float64)

    def p_times_k(permuted):
        acc = np.zeros((16, 64))
        for j in range(8):
            a = [(c0, c2, c1, c3) if permuted else (c0, c1, c2, c3)
                 for c0, c1, c2, c3 in _acc_regs(p[:, 8 * j:8 * j + 8])]
            for n in range(8):
                b = [(kt[8 * j + 2 * t, 8 * n + g],
                      kt[8 * j + 2 * t + 1, 8 * n + g]) if permuted else
                     (kt[8 * j + t, 8 * n + g], kt[8 * j + t + 4, 8 * n + g])
                     for g, t in LANES]
                acc[:, 8 * n:8 * n + 8] += _mma(a, b)
        return acc

    np.testing.assert_array_equal(p_times_k(True), p @ kt)
    # the registers taken as they are, with B's rows unpermuted: wrong
    assert not np.array_equal(p_times_k(False), p @ kt)


@pytest.mark.parametrize("d", [64, 128])
def test_padded_rows_put_each_fragment_load_on_distinct_banks(d):
    """The staged tiles' row stride D + 4 (floats, 4-byte banks, 32 of
    them): a warp's K-major loads (row g, column t) and across-rows loads
    (row 2t or 2t + 1, column g) each touch 32 distinct banks; the unpadded
    stride D does not."""
    for ld, distinct in ((d + 4, True), (d, False)):
        kmajor = {(g * ld + t) % 32 for g, t in LANES}
        across = [{((2 * t + h) * ld + g) % 32 for g, t in LANES}
                  for h in (0, 1)]
        assert (len(kmajor) == 32 and all(len(b) == 32 for b in across)) \
            == distinct
