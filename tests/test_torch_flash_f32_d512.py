"""Port parity: the fp32 flash forward, dq and dk/dv at head dims 257-512
in 3xTF32 (``flash_f32_d512_fwd``, ``flash_f32_d512_dq``,
``flash_f32_d512_dkv``: ``ops/cuda/csrc/flash_f32_d512.cu``; the forward
and dq by pairs of warps over 16 query rows, D split between the two warps
of a pair; dk/dv by quads of warps over 16 keys, two warps holding dv's
halves of the columns and two dk's).

Here, on the CPU:

- the launches: the wrappers driven with the card pretended and the
  kernel library replaced by a recorder, so the arguments a launch would
  get are read: the C entry point and the counting wrapper of each kernel
  (the forward, dq and dk/dv the 3xTF32 kernels, each launch counted on
  its own wrapper alone), the width the tensors are
  handed at (a multiple of 4 floats: the kernels zero the columns past it
  up to 384 or 512), their strides, the real D's scale, the biases and
  dropout passed on; the wrappers' refusals (bf16, D <= 256, D > 512);
- the copies: q, k, v and dO are read in place where their strides are
  multiples of 4 floats and their bases 16-byte aligned (head slices of a
  packed projection, broadcast views), padded only where D is not a
  multiple of 4, and copied once otherwise;
- the arithmetic: a model of the forward kernel's (Q Kᵀ over each half of
  D, the two partial scores added as the pair trades them, keys in the
  kernel's tiles, the online softmax in log2 units, O rescaled in fp32
  and each tile's P·V added from a fresh accumulator, every product in
  3xTF32 with the staged rows split as read) and of dq's (S and dP over
  all of D, traded, dS = P (dP − δ), each tile's dS K from a fresh
  accumulator) and of dk/dv's (queries in the kernel's tiles, Sᵀ = K Qᵀ
  and dPᵀ = V dOᵀ each as the sum of its two halves of D as the quad
  trades them, Pᵀ from lse, dropped for dv, dSᵀ = Pᵀ (dP'ᵀ − δ), each
  tile's Pᵀ dO and dSᵀ Q from a fresh accumulator, dk scaled at the end)
  at head dim 320, padded to 384, holds the JAX package's
  ``flash_attention`` (its Pallas kernels in interpret mode) under the
  fp32 flash rule, 2 ulps + 2^-14 of the larger of the row's and the
  tensor's RMS, lse within 1e-4; one TF32 pass fails the rule;
- the LM at 2 heads of 320 in fp32, its attention launched through the
  wrappers onto a stand-in library that runs those models on the
  tensors the C interface is handed (read and written through its
  pointers and strides), against the JAX package's LM: the loss and
  every parameter's gradient.
"""

import ctypes
import importlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import TransformerLM as JLM
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import TransformerLM as TLM
from apex_tpu_torch.ops import flash_attn as FA

JFA = importlib.import_module(
    "apex_tpu.contrib.multihead_attn.flash_attention")

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32

# the keys a staged tile holds in the forward and in dq at D 384, and the
# queries one of dk/dv's holds (flash_f32_d512.cu's xf_tile<384>,
# xq_tile<384>, xk_tile<384>)
FWD_KEYS, DQ_KEYS, DKV_QUERIES = 16, 8, 16


# -- the launches -------------------------------------------------------------

class _Recorder:
    """Stands in for the kernel library: every entry point records its name
    and arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(FA.dispatch, "use_kernel", lambda t: True)
    monkeypatch.setattr(FA._cuda, "lib", lambda: rec)
    monkeypatch.setattr(FA._cuda, "stream", lambda device: 0)
    return rec


def _inputs(dtype, d, bh=3, sq=70, sk=90):
    rs = np.random.RandomState(d)
    q = torch.from_numpy(rs.randn(bh, sq, d).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rs.randn(bh, sk, d).astype(np.float32))
            .to(dtype) for _ in range(2))
    do = torch.from_numpy(rs.randn(bh, sq, d).astype(np.float32)).to(dtype)
    return q, k, v, do, torch.zeros(bh, sq), torch.zeros(bh, sq)


# the wrappers that count the forms a flash kernel past D 256 may take
_WRAPPERS = ("flash_f32_d512_fwd", "flash_f32_d512_dq", "flash_f32_d512_dkv",
             "flash_simt_fwd", "flash_simt_dq", "flash_simt_dkv",
             "flash_f32_fwd", "flash_f32_dq", "flash_f32_dkv",
             "flash_d512_fwd", "flash_d512_dq", "flash_d512_dkv")
_F32X = ("flash_f32_d512_fwd", "flash_f32_d512_dq", "flash_f32_d512_dkv")


@pytest.mark.parametrize("d", [257, 300, 318, 320, 384, 385, 448, 512])
def test_launches_get_their_entry_points_widths_and_strides(recorder, d):
    """fp32 at D 257-512: the forward, dq and dk/dv reach the 3xTF32 entry
    points with q, k, v and dO handed at a multiple of 4 floats
    (zero-padded only to it), their bh and row strides, that width as the
    C side's d, the real D's scale and the biases and dropout passed on,
    dq's dS when asked. Each counts one launch on its own wrapper alone;
    outputs come back at D."""
    q, k, v, do, lse, delta = _inputs(F32, d)
    bh, sq, _ = q.shape
    sk = k.shape[1]
    w = -(-d // 4) * 4
    assert tuple(FA.kernel_form(q, n) for n in ("fwd", "dq", "dkv")) == \
        ("f32_512",) * 3
    before = {n: getattr(FA, n).launches for n in _WRAPPERS}
    kw = dict(causal=True, scale=d ** -0.5, q_start=3, k_start=1,
              kv_bias=torch.zeros(1, sk), bias=torch.zeros(bh, sq, sk),
              dropout_rate=0.1, dropout_seed=9)
    o, lse_out = FA.flash_fwd(q, k, v, **kw)
    dq, ds = FA.flash_bwd_dq(q, k, v, do, lse, delta, return_ds=True, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert o.shape == dq.shape == (bh, sq, d) and lse_out.shape == (bh, sq)
    assert ds.shape == (bh, sq, sk) and dk.shape == dv.shape == (bh, sk, d)
    assert {n: getattr(FA, n).launches - before[n] for n in _WRAPPERS} == \
        {n: int(n in _F32X) for n in _WRAPPERS}
    (fn, fa), (qn, qa), (kn, ka) = recorder.calls
    assert (fn, qn, kn) == ("apex_flash_f32_d512_fwd",
                            "apex_flash_f32_d512_dq",
                            "apex_flash_f32_d512_dkv")
    # forward: dtype, q, k, v, o, lse, 6 strides, then _tail's 16
    assert fa[0] == 0 and len(fa) == 12 + 16
    assert fa[6:12] == (sq * w, w, sk * w, w, sk * w, w)
    tail = fa[12:]
    assert tail[0] is not None and tail[1] == 0           # shared kv_bias
    assert tail[2] is not None and tail[3] == sq * sk     # per-bh bias
    assert tail[6] == pytest.approx(1 / 0.9)
    assert tail[7:15] == (bh, sq, sk, w, 3, 1, 1, d ** -0.5)
    # dq: dtype, q, k, v, dO, lse, delta, dq, ds, 8 strides, the tail
    assert qa[0] == 0 and len(qa) == 17 + 16 and qa[8] is not None
    assert qa[9:17] == (sq * w, w, sk * w, w, sk * w, w, sq * w, w)
    assert qa[17:][7:15] == (bh, sq, sk, w, 3, 1, 1, d ** -0.5)
    # dk/dv: dtype, q, k, v, dO, lse, delta, dk, dv, 8 strides, the tail
    assert ka[0] == 0 and len(ka) == 17 + 16 and None not in ka[1:9]
    assert ka[9:17] == qa[9:17] and ka[17:] == qa[17:]


def test_inputs_are_copied_only_to_a_multiple_of_4():
    """The 16-byte copies' contract: D 300 and 320, head slices of a packed
    [BH, S, 3·D] projection and a k broadcast over bh are read in place;
    D 257 and 318 are zero-padded to 260 and 320; a row stride that is
    not a multiple of 4 floats, or a base off 16 bytes, is copied once."""
    for d in (300, 320):
        q, k, v, do, lse, delta = _inputs(F32, d)
        got = FA._bwd_args("flash_f32_d512_dq", q, k, v, do, lse, delta,
                           "f32_512")
        assert all(a.data_ptr() == b.data_ptr()
                   for a, b in zip(got[:4], (q, k, v, do)))
    qkv = torch.randn(2, 40, 3 * 300)
    q, k, v = qkv[..., :300], qkv[..., 300:600], qkv[..., 600:]
    kb = torch.randn(1, 40, 300).expand(2, 40, 300)
    got = FA._f32x_ready("flash_f32_d512_fwd", q, kb, v)
    assert [a.data_ptr() for a in got] == [t.data_ptr() for t in (q, kb, v)]
    for d, w in ((257, 260), (318, 320)):
        q, k, v, *_ = _inputs(F32, d)
        got = FA._f32x_ready("flash_f32_d512_fwd", q, k, v)
        assert all(t.shape[-1] == w for t in got)
        assert not got[0][..., d:].any() and torch.equal(got[0][..., :d], q)
    odd = torch.randn(2, 40, 2 * 300 + 2)[..., :300]      # row stride 602
    shifted = torch.randn(2 * 40 * 300 + 1)[1:].view(2, 40, 300)
    for t in (odd, shifted):
        got = FA._f32x_ready("flash_f32_d512_fwd", t, t, t)
        assert got[0].is_contiguous() and got[0].data_ptr() != t.data_ptr()
        assert torch.equal(got[0], t)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the fp32 D-384/512 wrappers (the forward, dq and
    dk/dv) are their plain versions, bit for bit, and count no launch."""
    q, k, v, do, _, _ = _inputs(F32, 320, bh=2, sq=33, sk=40)
    bias = torch.randn(2, 33, 40)
    kw = dict(causal=True, scale=320 ** -0.5, bias=bias, dropout_rate=0.1,
              dropout_seed=3)
    before = [getattr(FA, n).launches for n in _F32X]
    o, lse = FA.flash_f32_d512_fwd(q, k, v, **kw)
    plain = {n: x for n, x in kw.items() if n != "bias"}
    o0, lse0 = FA.reference_attention(q, k, v, bias, return_lse=True,
                                      **plain)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    delta = FA.flash_delta(o, do)
    dq, ds = FA.flash_f32_d512_dq(q, k, v, do, lse, delta, return_ds=True,
                                  **kw)
    want = FA.flash_bwd_plain(q, k, v, do, lse, delta, return_ds=True, **kw)
    assert torch.equal(dq, want[0]) and torch.equal(ds, want[3])
    dk, dv = FA.flash_f32_d512_dkv(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
    assert [getattr(FA, n).launches for n in _F32X] == before


def test_wrappers_refuse_what_they_do_not_take(recorder):
    """bf16 and fp16, fp32 at D <= 256 and past 512, and dS without the
    bias it is the gradient of: refused by the forward, dq and dk/dv
    before any launch."""
    for dt, d in ((BF16, 320), (F16, 512), (F32, 256), (F32, 129)):
        q, k, v, do, lse, delta = _inputs(dt, d, sq=5, sk=5)
        with pytest.raises(ValueError, match="fp32 at a head dim of 257 to"):
            FA.flash_f32_d512_fwd(q, k, v, causal=True)
        with pytest.raises(ValueError, match="fp32 at a head dim of 257 to"):
            FA.flash_f32_d512_dq(q, k, v, do, lse, delta, causal=True,
                                 scale=1.0)
        with pytest.raises(ValueError, match="fp32 at a head dim of 257 to"):
            FA.flash_f32_d512_dkv(q, k, v, do, lse, delta, causal=True,
                                  scale=1.0)
    q, k, v, do, lse, delta = _inputs(F32, 513, sq=5, sk=5)
    with pytest.raises(ValueError, match="head dim of 1 to 512"):
        FA.flash_f32_d512_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="head dim of 1 to 512"):
        FA.flash_f32_d512_dkv(q, k, v, do, lse, delta, causal=True,
                              scale=1.0)
    q, k, v, do, lse, delta = _inputs(F32, 320, sq=5, sk=5)
    with pytest.raises(ValueError, match="return_ds needs the bias"):
        FA.flash_f32_d512_dq(q, k, v, do, lse, delta, causal=True,
                             scale=1.0, return_ds=True)
    assert recorder.calls == []


# -- the arithmetic: 3xTF32 models of the kernels -----------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties
    away from zero), on the bit pattern."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 as the tensor cores read a TF32 operand whose low 13 bits were
    left in place: those bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm3(a, b, a_raw: bool, b_raw: bool, passes: int):
    """a @ b through the tensor cores' TF32: small·big + big·small +
    big·big, small rounded where a value is split once (P, dS) and
    truncated where it is split as read (the staged rows), or one pass."""
    if passes == 1:
        return torch.matmul(tf32(a), tf32(b))
    ab, bb = tf32(a), tf32(b.contiguous())
    as_ = (tf32_trunc if a_raw else tf32)(a - ab)
    bs = (tf32_trunc if b_raw else tf32)(b.contiguous() - bb)
    return (torch.matmul(as_, bb) + torch.matmul(ab, bs)
            + torch.matmul(ab, bb))


def _chunked(a, b, passes):
    """a @ bᵀ over their last dim in pairs of k-steps (16 columns), each
    from a fresh accumulator, added in fp32, both operands staged rows."""
    return sum(_mm3(a[..., c:c + 16], b[..., c:c + 16].transpose(-1, -2),
                    True, True, passes)
               for c in range(0, a.shape[-1], 16))


def _rule_used(got, want):
    """The largest |got - want| over the fp32 flash rule's limit, 2 ulps +
    2^-14 of the larger of the row's RMS and the tensor's
    (chip_smoke.py's ``flash_err``): the rule holds at <= 1."""
    a, b = got.float(), want.float()

    def ulp(t):
        return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - 24)
    rms = torch.clamp(b.pow(2).mean(-1, keepdim=True).sqrt(),
                      min=float(b.pow(2).mean().sqrt()))
    lim = 2 * torch.maximum(ulp(a), ulp(b)) + 2.0 ** -14 * rms
    return float(((a - b).abs() / lim).max())


def _visible(sq, k0, k1, causal, q_start, k_start):
    qpos = q_start + torch.arange(sq)[:, None]
    kpos = k_start + torch.arange(k0, k1)[None, :]
    return qpos >= kpos if causal else torch.ones(sq, k1 - k0, dtype=bool)


def _keep(bh, sq, k0, k1, q_start, k_start, rate, seed):
    return FA._keep(torch.arange(bh)[:, None, None],
                    q_start + torch.arange(sq)[None, :, None],
                    k_start + torch.arange(k0, k1)[None, None, :], rate,
                    seed)


def _fwd_model(q, k, v, kv_bias, *, causal, scale, dropout_rate=0.0,
               dropout_seed=0, q_start=0, k_start=0, passes=3,
               bk=FWD_KEYS):
    """``f32x_fwd_kernel``'s arithmetic in plain PyTorch, q, k, v at the
    kernel's D (384 or 512): keys in tiles of ``bk``; each half of D's
    partial scores by ``_chunked``, the two added as the pair trades them;
    scores in log2 units with the kv_bias, NEG_INF where masked; the
    online softmax's running max m and sum l, p summed undropped into l,
    then dropped; O scaled by alpha in fp32 and each tile's P·V (P split
    once, V as read) added; o = O / l, lse = m·ln 2 + log l."""
    bh, sq, d = q.shape
    sk, h = k.shape[1], d // 2
    log2e = 1.0 / math.log(2.0)
    neg = torch.tensor(FA.NEG_INF)
    m = torch.full((bh, sq), FA.NEG_INF)
    l_sum = torch.zeros(bh, sq)
    acc = torch.zeros(bh, sq, d)
    for k0 in range(0, sk, bk):
        k1 = min(k0 + bk, sk)
        kt, vt = k[:, k0:k1], v[:, k0:k1]
        s = _chunked(q[..., :h], kt[..., :h], passes) + \
            _chunked(q[..., h:], kt[..., h:], passes)
        s = s * (scale * log2e)
        if kv_bias is not None:
            s = s + kv_bias[:, None, k0:k1] * log2e
        s = torch.where(_visible(sq, k0, k1, causal, q_start, k_start), s,
                        neg)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.where(s > FA.NEG_INF * 0.5, torch.exp2(s - mx[..., None]),
                        torch.zeros(()))
        l_sum = l_sum * alpha + p.sum(-1)
        m = mx
        if dropout_rate > 0.0:
            keep = _keep(bh, sq, k0, k1, q_start, k_start, dropout_rate,
                         dropout_seed)
            p = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros(()))
        acc = acc * alpha[..., None] + _mm3(p, vt, False, True, passes)
    o = acc / torch.where(l_sum > 0, l_sum, torch.ones(()))[..., None]
    lse = torch.where(l_sum > 0, m * math.log(2.0) + torch.log(l_sum), neg)
    return o, lse


def _dq_model(q, k, v, do, lse, delta, kv_bias, *, causal, scale,
              dropout_rate=0.0, dropout_seed=0, q_start=0, k_start=0,
              passes=3, bk=DQ_KEYS):
    """``f32x_dq_kernel``'s arithmetic in plain PyTorch, at the kernel's D:
    keys in tiles of ``bk``; S = Q Kᵀ and dP = dO Vᵀ over all of D by
    ``_chunked`` (one warp each, traded); P from the scores in log2 units
    with the kv_bias, 0 where masked; dP dropped and rescaled; dS = P (dP −
    δ); each tile's dS K (dS split once, K as read) added in fp32; dq
    scaled at the end."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    log2e = 1.0 / math.log(2.0)
    dq = torch.zeros(bh, sq, d)
    for k0 in range(0, sk, bk):
        k1 = min(k0 + bk, sk)
        kt, vt = k[:, k0:k1], v[:, k0:k1]
        s = _chunked(q, kt, passes) * (scale * log2e)
        if kv_bias is not None:
            s = s + kv_bias[:, None, k0:k1] * log2e
        s = torch.where(_visible(sq, k0, k1, causal, q_start, k_start), s,
                        torch.tensor(FA.NEG_INF))
        p = torch.where(s > FA.NEG_INF * 0.5,
                        torch.exp2(s - lse[..., None] * log2e),
                        torch.zeros(()))
        dp = _chunked(do, vt, passes)
        if dropout_rate > 0.0:
            keep = _keep(bh, sq, k0, k1, q_start, k_start, dropout_rate,
                         dropout_seed)
            dp = torch.where(keep, dp / (1.0 - dropout_rate),
                             torch.zeros(()))
        ds = p * (dp - delta[..., None])
        dq = dq + _mm3(ds, kt, False, True, passes)
    return dq * scale


def _dkv_model(q, k, v, do, lse, delta, kv_bias, *, causal, scale,
               dropout_rate=0.0, dropout_seed=0, q_start=0, k_start=0,
               passes=3, bq=DKV_QUERIES):
    """``f32x_dkv_kernel``'s arithmetic in plain PyTorch, at the kernel's
    D: queries in tiles of ``bq``; Sᵀ = K Qᵀ and dPᵀ = V dOᵀ each as its two
    halves of D by ``_chunked`` (one warp each), added as the quad trades
    them; Pᵀ from the scores in log2 units with the kv_bias, 0 where
    masked; dv += Pᵀ dO with Pᵀ dropped and rescaled, dP'ᵀ dropped and
    rescaled, dk += dSᵀ Q with dSᵀ = Pᵀ (dP'ᵀ − δ), each tile's product
    (Pᵀ, dSᵀ split once, dO and Q as read) from a fresh accumulator added
    in fp32; dk scaled at the end."""
    bh, sq, d = q.shape
    sk, h = k.shape[1], d // 2
    log2e = 1.0 / math.log(2.0)
    dk = torch.zeros(bh, sk, d)
    dv = torch.zeros(bh, sk, d)
    kpos = k_start + torch.arange(sk)[:, None]
    for q0 in range(0, sq, bq):
        q1 = min(q0 + bq, sq)
        qt, ot = q[:, q0:q1], do[:, q0:q1]

        def halves(a, b):
            return _chunked(a[..., :h], b[..., :h], passes) + \
                _chunked(a[..., h:], b[..., h:], passes)
        st = halves(k, qt) * (scale * log2e)
        if kv_bias is not None:
            st = st + kv_bias[:, :, None] * log2e
        qpos = q_start + torch.arange(q0, q1)[None, :]
        if causal:
            st = torch.where(qpos >= kpos, st, torch.tensor(FA.NEG_INF))
        p = torch.where(st > FA.NEG_INF * 0.5,
                        torch.exp2(st - lse[:, None, q0:q1] * log2e),
                        torch.zeros(()))
        dpt = halves(v, ot)
        pd = p
        if dropout_rate > 0.0:
            keep = _keep(bh, sq, 0, sk, q_start, k_start, dropout_rate,
                         dropout_seed)[:, q0:q1].transpose(1, 2)
            pd = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros(()))
            dpt = torch.where(keep, dpt / (1.0 - dropout_rate),
                              torch.zeros(()))
        dv = dv + _mm3(pd, ot, False, True, passes)
        ds = p * (dpt - delta[:, None, q0:q1])
        dk = dk + _mm3(ds, qt, False, True, passes)
    return dk * scale, dv


@pytest.fixture(scope="module")
def jax_case_320():
    """[2, 112, 320] causal with a kv_bias (a quarter of the keys masked)
    and dropout 0.1, at a head dim the kernels run at 384: the inputs, the
    JAX package's o, lse, dq, dk and dv."""
    rs = np.random.RandomState(15)
    bh, s, d = 2, 112, 320
    q, k, v, do = (rs.randn(bh, s, d).astype(np.float32) for _ in range(4))
    kvb = np.where(rs.rand(bh, s) < 0.25, -1.0e30, 0.0).astype(np.float32)
    kw = dict(causal=True, scale=d ** -0.5, dropout_rate=0.1,
              dropout_seed=80)

    def fn(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, kv_bias=jnp.asarray(kvb),
                                   return_lse=True, **kw)

    (o, lse), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.zeros(lse.shape, lse.dtype)))
    return (q, k, v, do, kvb, kw,
            [np.array(t, np.float32) for t in (o, lse, *grads)])


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "tf32"])
def test_forward_model_at_d320_against_jax_under_the_fp32_rule(
        jax_case_320, passes):
    """The forward kernel's arithmetic at head dim 320 as the kernel runs
    it: the columns past 320 zero up to 384, the real D's scale, each
    half's partial scores added, keys in tiles of ``FWD_KEYS``: 3xTF32
    holds JAX's o under the fp32 rule and lse within 1e-4; one TF32 pass
    fails the rule."""
    q, k, v, _, kvb, kw, want = jax_case_320
    d = q.shape[-1]
    assert FA.padded_head_dim(d) == 384
    q, k, v = (FA._pad_d(torch.from_numpy(a), 384) for a in (q, k, v))
    o, lse = _fwd_model(q, k, v, torch.from_numpy(kvb), passes=passes,
                        **kw)
    assert not o[..., d:].any()
    used = _rule_used(FA._unpad(o, d), torch.from_numpy(want[0]))
    lse_err = float((lse - torch.from_numpy(want[1])).abs().max())
    if passes == 3:
        assert used <= 1.0 and lse_err <= 1e-4, (used, lse_err)
    else:
        assert used > 4.0, used


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "tf32"])
def test_dq_model_at_d320_against_jax_under_the_fp32_rule(jax_case_320,
                                                          passes):
    """dq's arithmetic at head dim 320 as the pair kernel runs it (padded
    to 384, the real D's scale, keys in tiles of ``DQ_KEYS``, o, lse and
    delta from the plain forward): 3xTF32 holds JAX's dq under the fp32
    rule; one TF32 pass fails it."""
    q, k, v, do, kvb, kw, want = jax_case_320
    d = q.shape[-1]
    q, k, v, do, kvb = (torch.from_numpy(a) for a in (q, k, v, do, kvb))
    o, lse = FA.reference_attention(q, k, v, kv_bias=kvb, return_lse=True,
                                    **kw)
    delta = FA.flash_delta(o, do)
    padded = [FA._pad_d(t, 384) for t in (q, k, v, do)]
    dq = _dq_model(*padded, lse, delta, kvb, passes=passes, **kw)
    assert not dq[..., d:].any()
    used = _rule_used(FA._unpad(dq, d), torch.from_numpy(want[2]))
    if passes == 3:
        assert used <= 1.0, used
    else:
        assert used > 4.0, used


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "tf32"])
def test_dkv_model_at_d320_against_jax_under_the_fp32_rule(jax_case_320,
                                                           passes):
    """dk/dv's arithmetic at head dim 320 as the quad kernel runs it
    (padded to 384, the real D's scale, queries in tiles of
    ``DKV_QUERIES``, the partial sums over the halves of D added, lse and
    delta from the plain forward): 3xTF32 holds JAX's dk and dv under the
    fp32 rule; one TF32 pass fails it."""
    q, k, v, do, kvb, kw, want = jax_case_320
    d = q.shape[-1]
    q, k, v, do, kvb = (torch.from_numpy(a) for a in (q, k, v, do, kvb))
    o, lse = FA.reference_attention(q, k, v, kv_bias=kvb, return_lse=True,
                                    **kw)
    delta = FA.flash_delta(o, do)
    padded = [FA._pad_d(t, 384) for t in (q, k, v, do)]
    dk, dv = _dkv_model(*padded, lse, delta, kvb, passes=passes, **kw)
    assert not dk[..., d:].any() and not dv[..., d:].any()
    used = [_rule_used(FA._unpad(got, d), torch.from_numpy(w))
            for got, w in ((dk, want[3]), (dv, want[4]))]
    if passes == 3:
        assert max(used) <= 1.0, used
    else:
        assert min(used) > 4.0, used


# -- the LM at 2 heads of 320, in fp32, through the kernels' arithmetic -------

class _ModelLib:
    """Stands in for the kernel library on CPU tensors: the fp32 forward,
    dq and dk/dv at D 384/512 run ``_fwd_model``, ``_dq_model`` and
    ``_dkv_model`` (run at 384 or 512, as the kernels) on the tensors the
    wrappers hand the C interface, read and written through its pointers
    and strides. Biases and dropout are not modelled (the LM has
    neither)."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _at(ptr, shape, strides):
        """The fp32 tensor of ``shape`` and element ``strides`` at host
        address ``ptr`` (sharing its memory)."""
        n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
        buf = (ctypes.c_float * n).from_address(ptr)
        return torch.frombuffer(buf, dtype=torch.float32).as_strided(
            shape, strides)

    def _attn(self, bh, sq, sk, d, ptrs, strides, tail):
        kvb, _, bias, _, _, _, inv = tail[:7]
        q_start, k_start, causal, scale = tail[11:15]
        assert kvb is None and bias is None and inv == 0.0
        shapes = [(bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d)]
        ts = [self._at(p, s, (st[0], st[1], 1)) for p, s, st in
              zip(ptrs, shapes, zip(strides[::2], strides[1::2]))]
        kw = dict(causal=bool(causal), scale=scale, q_start=q_start,
                  k_start=k_start)
        return ts, kw

    def apex_flash_f32_d512_fwd(self, dtype, q, k, v, o, lse, *rest):
        self.calls.append("apex_flash_f32_d512_fwd")
        tail = rest[6:]
        bh, sq, sk, d = tail[7:11]
        (qt, kt, vt), kw = self._attn(bh, sq, sk, d, (q, k, v), rest[:6],
                                      tail)
        dk = 384 if d <= 384 else 512
        om, lm = _fwd_model(*(FA._pad_d(t, dk) for t in (qt, kt, vt)), None,
                            **kw)
        self._at(o, (bh, sq, d), (sq * d, d, 1)).copy_(om[..., :d])
        self._at(lse, (bh, sq), (sq, 1)).copy_(lm)
        return 0

    def apex_flash_f32_d512_dq(self, dtype, q, k, v, do, lse, delta, dq, ds,
                               *rest):
        self.calls.append("apex_flash_f32_d512_dq")
        assert ds is None
        tail = rest[8:]
        bh, sq, sk, d = tail[7:11]
        ts, kw = self._attn(bh, sq, sk, d, (q, k, v, do), rest[:8], tail)
        dk = 384 if d <= 384 else 512
        lt, dt = (self._at(p, (bh, sq), (sq, 1)) for p in (lse, delta))
        got = _dq_model(*(FA._pad_d(t, dk) for t in ts), lt, dt, None, **kw)
        self._at(dq, (bh, sq, d), (sq * d, d, 1)).copy_(got[..., :d])
        return 0

    def apex_flash_f32_d512_dkv(self, dtype, q, k, v, do, lse, delta, dk,
                                dv, *rest):
        self.calls.append("apex_flash_f32_d512_dkv")
        tail = rest[8:]
        bh, sq, sk, d = tail[7:11]
        ts, kw = self._attn(bh, sq, sk, d, (q, k, v, do), rest[:8], tail)
        dp = 384 if d <= 384 else 512
        lt, dt = (self._at(p, (bh, sq), (sq, 1)) for p in (lse, delta))
        gk, gv = _dkv_model(*(FA._pad_d(t, dp) for t in ts), lt, dt, None,
                            **kw)
        self._at(dk, (bh, sk, d), (sk * d, d, 1)).copy_(gk[..., :d])
        self._at(dv, (bh, sk, d), (sk * d, d, 1)).copy_(gv[..., :d])
        return 0


CFG = dict(vocab_size=512, max_seq_len=64, embed_dim=640, num_heads=2,
           num_layers=2, attn_impl="fast", head_chunk=512)
B, S = 2, 64


def test_lm_at_two_heads_of_320_in_fp32_through_the_kernels_matches_jax(
        monkeypatch):
    """The port's TransformerLM at head dim 320 in fp32 with its attention
    launched through ``flash_f32_d512_fwd``, ``flash_f32_d512_dq`` and
    ``flash_f32_d512_dkv`` (the card pretended for the flash wrappers
    alone; the stand-in library runs the kernels' 3xTF32 arithmetic on
    what they are handed) against the JAX package's (its Pallas kernels in interpret
    mode): the loss and every parameter's gradient within the fp32 LM
    parity test's limits."""
    lib = _ModelLib()
    monkeypatch.setattr(FA, "dispatch",
                        types.SimpleNamespace(use_kernel=lambda t: True))
    monkeypatch.setattr(FA._cuda, "lib", lambda: lib)
    monkeypatch.setattr(FA._cuda, "stream", lambda device: 0)
    jm = JLM(**CFG)
    jp = jm.init(jax.random.key(6))
    tm = TLM(**CFG, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(7).randint(0, 512, (B, S)).astype(np.int32)
    loss_j, g_j = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(toks)))(jp)
    leaves, spec = torch.utils._pytree.tree_flatten(tp)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    before = {n: getattr(FA, n).launches for n in _WRAPPERS}
    loss = tm.loss(torch.utils._pytree.tree_unflatten(leaves, spec),
                   torch.from_numpy(toks).long())
    grads = torch.autograd.grad(loss, leaves)
    layers = CFG["num_layers"]
    assert {n: getattr(FA, n).launches - before[n] for n in _WRAPPERS} == {
        n: layers * int(n in _F32X) for n in _WRAPPERS}
    assert sorted(set(lib.calls)) == ["apex_flash_f32_d512_dkv",
                                      "apex_flash_f32_d512_dq",
                                      "apex_flash_f32_d512_fwd"]
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-5, atol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, g_j), device="cpu")
    want_leaves = torch.utils._pytree.tree_flatten(want)[0]
    assert len(want_leaves) == len(grads)
    for g, w in zip(grads, want_leaves):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)
