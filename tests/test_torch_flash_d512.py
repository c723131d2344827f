"""Port parity: flash attention at head dims 257-512, whose bf16/fp16
forward and dq run on the tensor cores at D 384 or 512 (``flash_d512_fwd``,
``flash_d512_dq``: ``csrc/flash_d512.cu``, D split over the two consumer
warpgroups), whose fp32 forward and dq run in 3xTF32 there
(``flash_f32_d512_fwd``, ``flash_f32_d512_dq``: tests/
test_torch_flash_f32_d512.py), while dk/dv and the shared-bias gradient
there stay on the simple form.

Here, on the CPU:

- the route each kernel takes by dtype and head dim (``kernel_form`` per
  kernel) at D 256, 257, 320, 384, 385, 512 and 513, the wrappers driven
  with the card pretended and the kernel library replaced by a recorder,
  so the arguments a launch would get are read: the width the tensors are
  handed at (a multiple of 8: the kernels' maps fill the rest up to 384 or
  512 with zeros), the tensor maps' boxes, the grid of 64-row blocks; past
  512 every wrapper raises;
- the padding (pad to 384, the plain versions there with the real D's
  scale, slice) against the JAX package's ``flash_attention`` (its Pallas
  kernels in interpret mode, which pad D to 384 lanes themselves) at D 300
  and 320, causal and not: o, lse, dq, dk and dv within 1e-5 (fp32; the
  packages sum in other orders);
- ``TransformerLM`` at 2 heads of 320 (embed 640, 2 layers, vocab 512, S
  64, fp32, attention "fast") against the JAX package's, params carried by
  ``convert.params_from_jax``: the loss and the gradient of every
  parameter within 1e-5 relative and 1e-6 absolute, the LM step's parity
  test's limits.
"""

import importlib
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
    *[(dt, d, ("tc512", "tc512", "simt")) for dt in (BF16, F16)
      for d in (257, 320, 384, 385, 512)],
    *[(F32, d, ("f32_512", "f32_512", "simt")) for d in (257, 320, 384,
                                                         385, 512)]]
# the C entry point and the counting wrapper of each form
_ENTRY = {"fwd": {"tc256": "apex_flash_fwd", "tc512": "apex_flash_d512_fwd",
                  "f32": "apex_flash_f32_fwd",
                  "f32_512": "apex_flash_f32_d512_fwd",
                  "simt": "apex_flash_simt_fwd"},
          "dq": {"tc256": "apex_flash_bwd_dq", "tc512": "apex_flash_d512_dq",
                 "f32": "apex_flash_f32_dq",
                 "f32_512": "apex_flash_f32_d512_dq",
                 "simt": "apex_flash_simt_dq"},
          "dkv": {"tc256": "apex_flash_bwd_dkv", "f32": "apex_flash_f32_dkv",
                  "simt": "apex_flash_simt_dkv"}}
_COUNTER = {"fwd": {"tc256": "flash_d256_fwd", "tc512": "flash_d512_fwd",
                    "f32": "flash_f32_fwd", "f32_512": "flash_f32_d512_fwd",
                    "simt": "flash_simt_fwd"},
            "dq": {"tc256": "flash_d256_dq", "tc512": "flash_d512_dq",
                   "f32": "flash_f32_dq", "f32_512": "flash_f32_d512_dq",
                   "simt": "flash_simt_dq"},
            "dkv": {"tc256": "flash_d256_dkv", "f32": "flash_f32_dkv",
                    "simt": "flash_simt_dkv"}}


@pytest.mark.parametrize("dtype,d,forms", ROUTES,
                         ids=[f"{str(dt)[6:]}-{d}" for dt, d, _ in ROUTES])
def test_each_kernel_takes_its_route_past_256(recorder, dtype, d, forms):
    """bf16/fp16 past 256: the forward and dq at D 384 or 512 on the
    tensor cores, dk/dv the simple form; fp32 past 256: the forward and dq
    at D 384 or 512 in 3xTF32, dk/dv the simple form. Each wrapper
    reaches its form's C entry point once and counts one launch on that
    form's wrapper alone."""
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
    assert recorder.calls == []


def test_d512_wrappers_refuse_what_they_do_not_take(recorder):
    """The D-384/512 wrappers take bf16 or fp16 at D 257-512 alone, before
    any launch."""
    for dt, d in ((BF16, 256), (F16, 129), (F32, 320), (F32, 512)):
        q, k, v, do, lse, delta = _inputs(dt, d, sq=5, sk=5)
        with pytest.raises(ValueError, match="head dim of 257 to 512"):
            FA.flash_d512_fwd(q, k, v, causal=True)
        with pytest.raises(ValueError, match="head dim of 257 to 512"):
            FA.flash_d512_dq(q, k, v, do, lse, delta, causal=True,
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
    """The forward and dq past 256 launch with q, k, v and dO handed at a
    multiple of 8 (zero-padded only to it), maps as wide, boxes of 32 rows
    (dq at D 512 16), a grid of 64-row blocks, the real D's scale and the
    biases and dropout passed on; dq's dS when asked; outputs sliced back
    to D."""
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
    assert o.shape == dq.shape == (bh, sq, d) and lse_out.shape == (bh, sq)
    assert ds.shape == (bh, sq, sk) and ds.dtype == torch.float32
    (fwd_name, fa), (dq_name, da) = recorder.calls
    assert (fwd_name, dq_name) == ("apex_flash_d512_fwd",
                                   "apex_flash_d512_dq")
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
    """On CPU tensors the D-384/512 wrappers are their plain versions, bit
    for bit, and count no launch."""
    q, k, v, do, _, _ = _inputs(F32, 320, bh=2, sq=33, sk=40)
    q, k, v, do = (t.to(BF16) for t in (q, k, v, do))
    bias = torch.randn(2, 33, 40)
    kw = dict(causal=True, scale=320 ** -0.5, bias=bias, dropout_rate=0.1,
              dropout_seed=3)
    before = (FA.flash_d512_fwd.launches, FA.flash_d512_dq.launches)
    o, lse = FA.flash_d512_fwd(q, k, v, **kw)
    plain = {n: x for n, x in kw.items() if n != "bias"}
    o0, lse0 = FA.reference_attention(q, k, v, bias, return_lse=True,
                                      **plain)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    delta = FA.flash_delta(o, do)
    dq, ds = FA.flash_d512_dq(q, k, v, do, lse, delta, return_ds=True, **kw)
    want = FA.flash_bwd_plain(q, k, v, do, lse, delta, return_ds=True, **kw)
    assert torch.equal(dq, want[0]) and torch.equal(ds, want[3])
    assert (FA.flash_d512_fwd.launches, FA.flash_d512_dq.launches) == before


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
