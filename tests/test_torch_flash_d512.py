"""Port parity: flash attention at head dims 257-512, whose bf16/fp16
forward, dq and dk/dv run on the tensor cores at D 384 or 512
(``flash_d512_fwd``, ``flash_d512_dq``: ``csrc/flash_d512.cu``;
``flash_d512_dkv``: ``csrc/flash_d512_dkv.cu``'s dv and dk kernels; D split
over the two consumer warpgroups), whose fp32 ones run in 3xTF32 there
(``flash_f32_d512_fwd``, ``flash_f32_d512_dq``, ``flash_f32_d512_dkv``:
tests/test_torch_flash_f32_d512.py), while the shared-bias gradient there
stays on the simple form.

Here, on the CPU:

- the route each kernel takes by dtype and head dim (``kernel_form`` per
  kernel) at D 256, 257, 320, 384, 385, 512 and 513, the wrappers driven
  with the card pretended and the kernel library replaced by a recorder,
  so the arguments a launch would get are read: the width the tensors are
  handed at (a multiple of 8: the kernels' maps fill the rest up to 384 or
  512 with zeros), the tensor maps' boxes, the grid of 64-row blocks
  (query rows for the forward and dq, keys for dk/dv); past 512 every
  wrapper raises;
- the padding (pad to 384, the plain versions there with the real D's
  scale, slice) against the JAX package's ``flash_attention`` (its Pallas
  kernels in interpret mode, which pad D to 384 lanes themselves) at D 300
  and 320, causal and not: o, lse, dq, dk and dv within 1e-5 (fp32; the
  packages sum in other orders);
- a model of dk/dv's arithmetic at head dim 320 as ``flash_d512_dkv``
  runs it (padded to 384, S^T from the two halves of D, P^T and dS^T
  rounded to the element type once for their products, fp32 sums, the
  outputs rounded) against the JAX package's ``_bwd_dkv_kernel`` (its
  Pallas kernel in interpret mode) under the 16-bit flash rule, in bf16
  and fp16, with a kv_bias and dropout;
- ``TransformerLM`` at 2 heads of 320 (embed 640, 2 layers, vocab 512, S
  64, fp32, attention "fast") against the JAX package's, params carried by
  ``convert.params_from_jax``: the loss and the gradient of every
  parameter within 1e-5 relative and 1e-6 absolute, the LM step's parity
  test's limits; and the same LM in bf16 with its attention launched
  through ``flash_d512_fwd``, ``flash_d512_dq`` and ``flash_d512_dkv`` onto
  a stand-in library (the tensors read through the maps the wrappers
  describe; dk/dv by the model above, the forward and dq by their plain
  versions) against the JAX package's LM in bf16: the loss within 1% and
  every gradient within 5% of its norm.
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


# -- the route ----------------------------------------------------------------

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
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=132))
    return rec


def _inputs(dtype, d, bh=3, sq=70, sk=90):
    rs = np.random.RandomState(d)
    q = torch.from_numpy(rs.randn(bh, sq, d).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rs.randn(bh, sk, d).astype(np.float32))
            .to(dtype) for _ in range(2))
    do = torch.from_numpy(rs.randn(bh, sq, d).astype(np.float32)).to(dtype)
    return q, k, v, do, torch.zeros(bh, sq), torch.zeros(bh, sq)


# (the forward's, dq's and dk/dv's form) by dtype and head dim
ROUTES = [
    (BF16, 256, ("tc256", "tc256", "tc256")),
    (F16, 256, ("tc256", "tc256", "tc256")),
    (F32, 256, ("f32", "f32", "f32")),
    *[(dt, d, ("tc512",) * 3) for dt in (BF16, F16)
      for d in (257, 320, 384, 385, 512)],
    *[(F32, d, ("f32_512",) * 3) for d in (257, 320, 384, 385, 512)]]
# the C entry point and the counting wrapper of each form
_ENTRY = {"fwd": {"tc256": "apex_flash_fwd", "tc512": "apex_flash_d512_fwd",
                  "f32": "apex_flash_f32_fwd",
                  "f32_512": "apex_flash_f32_d512_fwd",
                  "simt": "apex_flash_simt_fwd"},
          "dq": {"tc256": "apex_flash_bwd_dq", "tc512": "apex_flash_d512_dq",
                 "f32": "apex_flash_f32_dq",
                 "f32_512": "apex_flash_f32_d512_dq",
                 "simt": "apex_flash_simt_dq"},
          "dkv": {"tc256": "apex_flash_bwd_dkv", "tc512": "apex_flash_d512_dkv",
                  "f32": "apex_flash_f32_dkv",
                  "f32_512": "apex_flash_f32_d512_dkv",
                  "simt": "apex_flash_simt_dkv"}}
_COUNTER = {"fwd": {"tc256": "flash_d256_fwd", "tc512": "flash_d512_fwd",
                    "f32": "flash_f32_fwd", "f32_512": "flash_f32_d512_fwd",
                    "simt": "flash_simt_fwd"},
            "dq": {"tc256": "flash_d256_dq", "tc512": "flash_d512_dq",
                   "f32": "flash_f32_dq", "f32_512": "flash_f32_d512_dq",
                   "simt": "flash_simt_dq"},
            "dkv": {"tc256": "flash_d256_dkv", "tc512": "flash_d512_dkv",
                    "f32": "flash_f32_dkv", "f32_512": "flash_f32_d512_dkv",
                    "simt": "flash_simt_dkv"}}


@pytest.mark.parametrize("dtype,d,forms", ROUTES,
                         ids=[f"{str(dt)[6:]}-{d}" for dt, d, _ in ROUTES])
def test_each_kernel_takes_its_route_past_256(recorder, dtype, d, forms):
    """bf16/fp16 past 256: the forward, dq and dk/dv at D 384 or 512 on
    the tensor cores; fp32 past 256: all three at D 384 or 512 in 3xTF32;
    the simple form takes none. Each wrapper reaches its form's C entry
    point once and counts one launch on that form's wrapper alone."""
    q, k, v, do, lse, delta = _inputs(dtype, d)
    assert tuple(FA.kernel_form(q, kn) for kn in ("fwd", "dq", "dkv")) == \
        forms
    assert not FA.tensor_cores(q)
    names = sorted({n for fs in _COUNTER.values() for n in fs.values()})
    before = {n: getattr(FA, n).launches for n in names}
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse_out = FA.flash_fwd(q, k, v, **kw)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert o.shape == dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert [c[0] for c in recorder.calls] == [
        _ENTRY[kn][f] for kn, f in zip(("fwd", "dq", "dkv"), forms)]
    want = {n: 0 for n in names}
    for kn, f in zip(("fwd", "dq", "dkv"), forms):
        want[_COUNTER[kn][f]] += 1
    assert {n: getattr(FA, n).launches - before[n] for n in names} == want


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
def test_past_512_every_wrapper_raises(recorder, dtype):
    """D 513: no kernel takes it; every wrapper raises before a launch."""
    q, k, v, do, lse, delta = _inputs(dtype, 513, sq=5, sk=5)
    kw = dict(causal=True, scale=1.0)
    with pytest.raises(ValueError, match="head dim of 1 to 512"):
        FA.flash_fwd(q, k, v, **kw)
    with pytest.raises(ValueError, match="head dim of 1 to 512"):
        FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    with pytest.raises(ValueError, match="head dim of 1 to 512"):
        FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    with pytest.raises(ValueError, match="head dim of 1 to 512"):
        FA.flash_d512_fwd(q, k, v, **kw)
    with pytest.raises(ValueError, match="head dim of 1 to 512"):
        FA.flash_d512_dq(q, k, v, do, lse, delta, **kw)
    with pytest.raises(ValueError, match="head dim of 1 to 512"):
        FA.flash_d512_dkv(q, k, v, do, lse, delta, **kw)
    assert recorder.calls == []


def test_d512_wrappers_refuse_what_they_do_not_take(recorder):
    """The D-384/512 wrappers (the forward, dq and dk/dv) take bf16 or fp16
    at D 257-512 alone, before any launch."""
    for dt, d in ((BF16, 256), (F16, 129), (F32, 320), (F32, 512)):
        q, k, v, do, lse, delta = _inputs(dt, d, sq=5, sk=5)
        with pytest.raises(ValueError, match="head dim of 257 to 512"):
            FA.flash_d512_fwd(q, k, v, causal=True)
        with pytest.raises(ValueError, match="head dim of 257 to 512"):
            FA.flash_d512_dq(q, k, v, do, lse, delta, causal=True,
                             scale=1.0)
        with pytest.raises(ValueError, match="head dim of 257 to 512"):
            FA.flash_d512_dkv(q, k, v, do, lse, delta, causal=True,
                              scale=1.0)
    q, k, v, do, lse, delta = _inputs(BF16, 320, sq=5, sk=5)
    with pytest.raises(ValueError, match="return_ds needs the bias"):
        FA.flash_d512_dq(q, k, v, do, lse, delta, causal=True, scale=1.0,
                         return_ds=True)
    assert recorder.calls == []


@pytest.mark.parametrize("d,width,dp", [(257, 264, 384), (300, 304, 384),
                                        (320, 320, 384), (384, 384, 384),
                                        (385, 392, 512), (448, 448, 512),
                                        (512, 512, 512)])
def test_kernel_width_and_padded_head_dim(d, width, dp):
    """The kernels run at 384 or 512 (the JAX package's padding to a
    multiple of 128 lanes) and are handed the tensors at a multiple of 8
    (``_kernel_width``); up to 256 the two are one."""
    assert FA.padded_head_dim(d) == dp
    assert FA._kernel_width(d) == width
    for small, dp_small in ((100, 128), (200, 256), (256, 256)):
        assert FA._kernel_width(small) == FA.padded_head_dim(small) == \
            dp_small


@pytest.mark.parametrize("d", [257, 300, 320, 384, 385, 512])
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_d512_launches_get_their_widths_maps_and_grid(recorder, dtype, d):
    """The forward, dq and dk/dv past 256 launch with q, k, v and dO handed
    at a multiple of 8 (zero-padded only to it), maps as wide, boxes of 32
    rows (dq and dk/dv at D 512 16), a grid of 64-row blocks (64 keys for
    dk/dv), the real D's scale and the biases and dropout passed on; dq's
    dS when asked; outputs sliced back to D."""
    q, k, v, do, lse, delta = _inputs(dtype, d)
    bh, sq, _ = q.shape
    sk = k.shape[1]
    w, dp = FA._kernel_width(d), FA.padded_head_dim(d)
    es = q.element_size()
    kw = dict(causal=True, scale=d ** -0.5, q_start=3, k_start=1,
              kv_bias=torch.zeros(1, sk), bias=torch.zeros(bh, sq, sk),
              dropout_rate=0.1, dropout_seed=9)
    o, lse_out = FA.flash_fwd(q, k, v, **kw)
    dq, ds = FA.flash_bwd_dq(q, k, v, do, lse, delta, return_ds=True, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert o.shape == dq.shape == (bh, sq, d) and lse_out.shape == (bh, sq)
    assert ds.shape == (bh, sq, sk) and ds.dtype == torch.float32
    assert dk.shape == dv.shape == (bh, sk, d) and dk.dtype == dtype
    (fwd_name, fa), (dq_name, da), (kv_name, ka) = recorder.calls
    assert (fwd_name, dq_name, kv_name) == (
        "apex_flash_d512_fwd", "apex_flash_d512_dq", "apex_flash_d512_dkv")
    # forward: dtype, q, k, v, o, lse, maps, blocks, then _tail's 16
    assert fa[0] == {BF16: 1, F16: 2}[dtype] and len(fa) == 8 + 16
    box = FA.FWD_D512_KEYS
    assert list(fa[6]) == [w, sq, bh, w * es, sq * w * es, 64, box, 1,
                           w, sk, bh, w * es, sk * w * es, 64, box, 1,
                           w, sk, bh, w * es, sk * w * es, 64, box, 1]
    assert fa[7] == FA.row_blocks(sq, FA.D512_ROWS) == -(-sq // 64)
    tail = fa[8:]
    assert tail[0] is not None and tail[1] == 0           # shared kv_bias
    assert tail[2] is not None and tail[3] == sq * sk     # per-bh bias
    assert tail[6] == pytest.approx(1 / 0.9)
    assert tail[7:15] == (bh, sq, sk, w, 3, 1, 1, d ** -0.5)
    # dq: dtype, q, k, v, dO, lse, delta, dq, ds, maps, blocks, tail
    assert len(da) == 11 + 16 and da[8] is not None
    maps = list(da[9])
    rows = FA.DQ_D512_KEYS[dp]
    assert rows == (32 if dp == 384 else 16)
    assert len(maps) == 32
    assert [maps[8 * i:8 * i + 3] for i in range(4)] == [
        [w, sq, bh], [w, sk, bh], [w, sk, bh], [w, sq, bh]]
    assert [maps[8 * i + 5:8 * i + 8] for i in range(4)] == [[64, rows, 1]] * 4
    assert da[10] == -(-sq // 64) and da[11:][7:11] == (bh, sq, sk, w)
    # dk/dv: dtype, q, k, v, dO, lse, delta, dk, dv, maps (dq's), blocks of
    # 64 keys, the tail
    assert ka[0] == fa[0] and len(ka) == 11 + 16
    assert None not in ka[1:9] and list(ka[9]) == maps
    assert ka[10] == FA.row_blocks(sk, FA.D512_ROWS) == -(-sk // 64)
    assert ka[11:] == da[11:]


def test_d512_inputs_are_padded_only_to_a_multiple_of_8():
    """At D 300 the kernels get q, k, v and dO 304 wide, the 4 columns past
    300 zeros; at D 320 the tensors themselves (no copy where they are
    readable in place)."""
    for d in (300, 320):
        q, k, v, *_ = _inputs(BF16, d)
        padded = FA._bwd_args("flash_d512_dq", q, k, v, q, torch.zeros(3, 70),
                              torch.zeros(3, 70), "tc512")
        w = FA._kernel_width(d)
        assert all(t.shape[-1] == w for t in padded[:4])
        assert bool((padded[0][..., d:] == 0).all())
        assert torch.equal(padded[0][..., :d], q)
        if w == d:
            assert padded[0].data_ptr() == q.data_ptr()


# -- the padding against JAX --------------------------------------------------

def _case(bh, s, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(bh, s, d).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, do, causal):
    scale = 1.0 / np.sqrt(q.shape[-1])

    def fn(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, causal=causal, scale=scale,
                                   return_lse=True)

    (o, lse), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.zeros(lse.shape, lse.dtype)))
    return [np.asarray(t, np.float32) for t in (o, lse, *grads)]


@pytest.mark.parametrize("d", [300, 320])
@pytest.mark.parametrize("causal", [True, False])
def test_padding_to_384_matches_jax(d, causal):
    """Pad to 384 (the width the kernels run at: their maps fill the
    columns past the tensors with zeros), run the plain versions there with
    the real D's scale, slice: JAX's o, lse, dq, dk and dv."""
    q, k, v, do = _case(2, 75, d, seed=d)
    want = _jax(q, k, v, do, causal)
    dp = FA.padded_head_dim(d)
    assert dp == 384
    scale = 1.0 / np.sqrt(d)
    qp, kp, vp, dop = (FA._pad_d(torch.from_numpy(a), dp)
                       for a in (q, k, v, do))
    assert bool((qp[..., d:] == 0).all())
    o, lse = FA._fwd_plain(qp, kp, vp, causal=causal, scale=scale,
                           q_start=0, k_start=0, kv_bias=None, bias=None,
                           dropout_rate=0.0, dropout_seed=0)
    assert bool((o[..., d:] == 0).all())
    delta = FA.flash_delta(o, dop)
    dq, dk, dv = FA.flash_bwd_plain(qp, kp, vp, dop, lse, delta,
                                    causal=causal, scale=scale)
    assert bool((dq[..., d:] == 0).all())
    got = [FA._unpad(t, d) for t in (o, dq, dk, dv)]
    for g, w in zip([got[0], lse, *got[1:]], want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


def test_d512_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the D-384/512 wrappers (the forward, dq and dk/dv)
    are their plain versions, bit for bit, and count no launch."""
    q, k, v, do, _, _ = _inputs(F32, 320, bh=2, sq=33, sk=40)
    q, k, v, do = (t.to(BF16) for t in (q, k, v, do))
    bias = torch.randn(2, 33, 40)
    kw = dict(causal=True, scale=320 ** -0.5, bias=bias, dropout_rate=0.1,
              dropout_seed=3)
    names = ("flash_d512_fwd", "flash_d512_dq", "flash_d512_dkv")
    before = [getattr(FA, n).launches for n in names]
    o, lse = FA.flash_d512_fwd(q, k, v, **kw)
    plain = {n: x for n, x in kw.items() if n != "bias"}
    o0, lse0 = FA.reference_attention(q, k, v, bias, return_lse=True,
                                      **plain)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    delta = FA.flash_delta(o, do)
    dq, ds = FA.flash_d512_dq(q, k, v, do, lse, delta, return_ds=True, **kw)
    want = FA.flash_bwd_plain(q, k, v, do, lse, delta, return_ds=True, **kw)
    assert torch.equal(dq, want[0]) and torch.equal(ds, want[3])
    dk, dv = FA.flash_d512_dkv(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
    assert [getattr(FA, n).launches for n in names] == before


# -- dk/dv's arithmetic against JAX's _bwd_dkv_kernel --------------------------

def _rule_used_16(got, want, dtype):
    """The largest |got - want| over the 16-bit flash rule's limit, 2 ulps
    of dtype + 2^-6 of the row's RMS (at least 2^-6 of the tensor's):
    chip_smoke.py's ``flash_err``; the rule holds at <= 1."""
    bits = {BF16: 8, F16: 11}[dtype]
    a, b = got.float(), want.float()

    def ulp(t):
        return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - bits)
    rms = torch.clamp(b.pow(2).mean(-1, keepdim=True).sqrt(),
                      min=2.0 ** -6 * float(b.pow(2).mean().sqrt()))
    lim = 2 * torch.maximum(ulp(a), ulp(b)) + 2.0 ** -6 * rms
    return float(((a - b).abs() / lim).max())


def _dkv_model_16(q, k, v, do, lse, delta, kv_bias, *, dt, causal, scale,
                  dropout_rate=0.0, dropout_seed=0, q_start=0, k_start=0):
    """``flash_d512_dkv``'s arithmetic in plain PyTorch on fp32 tensors
    holding dt's values at the kernel's D (384 or 512): Sᵀ = K Qᵀ as the sum
    of its two halves of D (the dv kernel's trade; the dk kernel's one
    product over all of D sums the same exact products), in log2 units
    with the kv_bias, masked; Pᵀ = 2^(s − lse), 0 where masked or below
    the value guard; dv = Pᵀ dO with Pᵀ dropped, rescaled and rounded to
    dt once, summed in fp32; dP'ᵀ dropped and rescaled; dSᵀ = Pᵀ (dP'ᵀ − δ)
    · scale rounded to dt once; dk = dSᵀ Q in fp32; both rounded to dt."""
    bh, sq, d = q.shape
    sk, h = k.shape[1], d // 2
    log2e = 1.0 / math.log(2.0)
    s = (torch.matmul(q[..., :h], k[..., :h].transpose(1, 2))
         + torch.matmul(q[..., h:], k[..., h:].transpose(1, 2)))
    s = s * (scale * log2e)
    if kv_bias is not None:
        s = s + kv_bias[:, None, :] * log2e
    qpos = q_start + torch.arange(sq)[:, None]
    kpos = k_start + torch.arange(sk)[None, :]
    live = (qpos >= kpos) if causal else torch.ones(sq, sk, dtype=bool)
    live = live & (s > FA.NEG_INF * 0.5)
    p = torch.where(live, torch.exp2(s - lse[..., None] * log2e),
                    torch.zeros(()))
    dp = torch.matmul(do, v.transpose(1, 2))
    pd = p
    if dropout_rate > 0.0:
        keep = FA._keep(torch.arange(bh)[:, None, None], qpos[None],
                        kpos[None], dropout_rate, dropout_seed)
        inv = 1.0 / (1.0 - dropout_rate)
        pd = torch.where(keep, p * inv, torch.zeros(()))
        dp = torch.where(keep, dp * inv, torch.zeros(()))
    dv = torch.matmul(pd.to(dt).float().transpose(1, 2), do)
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dk = torch.matmul(ds.transpose(1, 2), q)
    return dk.to(dt), dv.to(dt)


@pytest.fixture(scope="module")
def jax_dkv_320():
    """[2, 112, 320] causal with a kv_bias (a quarter of the keys masked)
    and dropout 0.1, the inputs bf16 and fp16 values: per dtype the inputs
    (fp32), the plain forward's lse and delta, and the JAX package's dk and
    dv (its Pallas kernels in interpret mode, in fp32 on those values)."""
    rs = np.random.RandomState(19)
    bh, s, d = 2, 112, 320
    raw = [rs.randn(bh, s, d).astype(np.float32) for _ in range(4)]
    kvb = np.where(rs.rand(bh, s) < 0.25, -1.0e30, 0.0).astype(np.float32)
    kw = dict(causal=True, scale=d ** -0.5, dropout_rate=0.1,
              dropout_seed=77)
    out = {}
    for dt in (BF16, F16):
        q, k, v, do = (torch.from_numpy(a).to(dt).float() for a in raw)
        kvb_t = torch.from_numpy(kvb)

        def fn(q_, k_, v_):
            return JFA.flash_attention(q_, k_, v_, kv_bias=jnp.asarray(kvb),
                                       return_lse=True, **kw)

        (_, lse_j), vjp = jax.vjp(fn, *(jnp.asarray(t.numpy())
                                        for t in (q, k, v)))
        grads = vjp((jnp.asarray(do.numpy()),
                     jnp.zeros(lse_j.shape, lse_j.dtype)))
        o, lse = FA.reference_attention(q, k, v, kv_bias=kvb_t,
                                        return_lse=True, **kw)
        out[dt] = ((q, k, v, do), kvb_t, lse, FA.flash_delta(o, do), kw,
                   [torch.from_numpy(np.array(g, np.float32))
                    for g in grads[1:]])
    return out


@pytest.mark.parametrize("dt", [BF16, F16], ids=["bf16", "f16"])
def test_dkv_model_at_d320_against_jax_under_the_flash_rule(jax_dkv_320,
                                                            dt):
    """dk/dv's arithmetic at head dim 320 as ``flash_d512_dkv`` runs it
    (padded to 384, the real D's scale, Pᵀ and dSᵀ rounded to the element
    type once, the kv_bias and dropout): JAX's dk and dv under the 16-bit
    flash rule, and a result 5% off refused by it."""
    (q, k, v, do), kvb, lse, delta, kw, (dk_j, dv_j) = jax_dkv_320[dt]
    d = q.shape[-1]
    padded = [FA._pad_d(t, 384) for t in (q, k, v, do)]
    dk, dv = _dkv_model_16(*padded, lse, delta, kvb, dt=dt, **kw)
    assert not dk[..., d:].any() and not dv[..., d:].any()
    for got, want in ((dk, dk_j), (dv, dv_j)):
        used = _rule_used_16(FA._unpad(got, d), want, dt)
        assert used <= 1.0, used
        assert _rule_used_16(want * 1.05, want, dt) > 1.0


# -- the LM at 2 heads of 320 -------------------------------------------------

CFG = dict(vocab_size=512, max_seq_len=64, embed_dim=640, num_heads=2,
           num_layers=2, attn_impl="fast", head_chunk=512)
B, S = 2, 64


def test_lm_at_two_heads_of_320_matches_jax():
    """The port's TransformerLM at head dim 320 (its flash calls through
    the plain versions on the CPU) against the JAX package's (its Pallas
    kernels in interpret mode, D padded to 384): the loss and every
    parameter's gradient."""
    jm = JLM(**CFG)
    jp = jm.init(jax.random.key(6))
    tm = TLM(**CFG, device="cpu")
    assert tm.embed_dim // tm.num_heads == 320
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(7).randint(0, 512, (B, S)).astype(np.int32)
    loss_j, g_j = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(toks)))(jp)
    leaves, spec = torch.utils._pytree.tree_flatten(tp)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = tm.loss(torch.utils._pytree.tree_unflatten(leaves, spec),
                   torch.from_numpy(toks).long())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-5, atol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, g_j), device="cpu")
    want_leaves = torch.utils._pytree.tree_flatten(want)[0]
    assert len(want_leaves) == len(grads)
    for g, w in zip(grads, want_leaves):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


class _Half16Lib:
    """Stands in for the kernel library on CPU tensors: the 16-bit forward,
    dq and dk/dv at D 384/512 run on the tensors the wrappers hand the C
    interface, read through the tensor maps they describe (dims and byte
    strides) and written through the output pointers: the forward and dq
    by their plain versions, dk/dv by ``_dkv_model_16`` at 384 or 512.
    Biases and dropout are not modelled (the LM has neither)."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _at(ptr, shape, strides, dtype):
        """The tensor of ``shape``, element ``strides`` and ``dtype`` at host
        address ``ptr`` (sharing its memory)."""
        n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
        ctype = ctypes.c_float if dtype == F32 else ctypes.c_uint16
        buf = (ctype * n).from_address(ptr)
        return torch.frombuffer(buf, dtype=dtype).as_strided(shape, strides)

    def _inputs(self, code, ptrs, tma, tail):
        dt = {1: BF16, 2: F16}[code]
        ts = []
        for i, ptr in enumerate(ptrs):
            d, s, bh, row, bhs = tma[8 * i:8 * i + 5]
            ts.append(self._at(ptr, (bh, s, d), (bhs // 2, row // 2, 1), dt))
        assert tail[0] is None and tail[2] is None and tail[6] == 0.0
        q_start, k_start, causal, scale = tail[11:15]
        return dt, ts, dict(causal=bool(causal), scale=scale,
                            q_start=q_start, k_start=k_start)

    def _stats(self, lse, delta, bh, sq):
        return (self._at(p, (bh, sq), (sq, 1), F32) for p in (lse, delta))

    def apex_flash_d512_fwd(self, code, q, k, v, o, lse, tma, blocks,
                            *tail):
        self.calls.append("apex_flash_d512_fwd")
        dt, (qt, kt, vt), kw = self._inputs(code, (q, k, v), tma, tail)
        om, lm = FA.reference_attention(qt, kt, vt, return_lse=True, **kw)
        bh, sq, dw = qt.shape
        self._at(o, (bh, sq, dw), (sq * dw, dw, 1), dt).copy_(om)
        self._at(lse, (bh, sq), (sq, 1), F32).copy_(lm)
        return 0

    def apex_flash_d512_dq(self, code, q, k, v, do, lse, delta, dq, ds, tma,
                           blocks, *tail):
        self.calls.append("apex_flash_d512_dq")
        assert ds is None
        dt, ts, kw = self._inputs(code, (q, k, v, do), tma, tail)
        bh, sq, dw = ts[0].shape
        got = FA.flash_bwd_plain(*ts, *self._stats(lse, delta, bh, sq),
                                 **kw)[0]
        self._at(dq, (bh, sq, dw), (sq * dw, dw, 1), dt).copy_(got)
        return 0

    def apex_flash_d512_dkv(self, code, q, k, v, do, lse, delta, dk, dv,
                            tma, blocks, *tail):
        self.calls.append("apex_flash_d512_dkv")
        dt, ts, kw = self._inputs(code, (q, k, v, do), tma, tail)
        bh, sq, dw = ts[0].shape
        sk = ts[1].shape[1]
        assert blocks == -(-sk // 64)
        dp = FA.padded_head_dim(dw)
        gk, gv = _dkv_model_16(*(FA._pad_d(t.float(), dp) for t in ts),
                               *self._stats(lse, delta, bh, sq), None, dt=dt,
                               **kw)
        for out, got in ((dk, gk), (dv, gv)):
            self._at(out, (bh, sk, dw), (sk * dw, dw, 1), dt).copy_(
                got[..., :dw])
        return 0


def test_lm_at_two_heads_of_320_in_bf16_through_the_kernels_matches_jax(
        monkeypatch):
    """The port's TransformerLM at head dim 320 in bf16 (the JAX LM's
    params rounded to bf16) with its attention launched through
    ``flash_d512_fwd``, ``flash_d512_dq`` and ``flash_d512_dkv`` (the card
    pretended for the flash wrappers alone; the stand-in library runs
    dk/dv's modelled arithmetic on what they are handed) against the JAX
    package's LM on the same bf16 params (its Pallas kernels in interpret
    mode): the loss within 1%, each parameter's gradient within 5% of its
    norm (both sides round every activation to bf16, at other places)."""
    lib = _Half16Lib()
    monkeypatch.setattr(FA, "dispatch",
                        types.SimpleNamespace(use_kernel=lambda t: True))
    monkeypatch.setattr(FA._cuda, "lib", lambda: lib)
    monkeypatch.setattr(FA._cuda, "stream", lambda device: 0)
    jm = JLM(**CFG)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      jm.init(jax.random.key(6)))
    tm = TLM(**CFG, device="cpu")
    tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      jp), device="cpu")
    tp = jax.tree.map(lambda t: t.to(BF16), tp)
    toks = np.random.RandomState(7).randint(0, 512, (B, S)).astype(np.int32)
    loss_j, g_j = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(toks)))(jp)
    leaves, spec = torch.utils._pytree.tree_flatten(tp)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    names = ("flash_d512_fwd", "flash_d512_dq", "flash_d512_dkv",
             "flash_simt_dkv")
    before = {n: getattr(FA, n).launches for n in names}
    loss = tm.loss(torch.utils._pytree.tree_unflatten(leaves, spec),
                   torch.from_numpy(toks).long())
    grads = torch.autograd.grad(loss, leaves)
    layers = CFG["num_layers"]
    assert {n: getattr(FA, n).launches - before[n] for n in names} == {
        n: layers * int(n != "flash_simt_dkv") for n in names}
    assert sorted(set(lib.calls)) == ["apex_flash_d512_dkv",
                                      "apex_flash_d512_dq",
                                      "apex_flash_d512_fwd"]
    np.testing.assert_allclose(float(loss.detach().float()),
                               float(loss_j.astype(jnp.float32)), rtol=1e-2)
    want = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        g_j), device="cpu")
    want_leaves = torch.utils._pytree.tree_flatten(want)[0]
    assert len(want_leaves) == len(grads)
    for g, w in zip(grads, want_leaves):
        assert g.shape == w.shape
        err = float((g.float() - w).norm())
        assert err <= 0.05 * float(w.norm()) + 1e-6, (err, float(w.norm()))
