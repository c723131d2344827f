"""Port parity: flash attention at head dims 129-256, whose bf16/fp16
forward, dq and dk/dv run on the tensor cores at D 256
(``flash_d256_fwd``, ``flash_d256_dq``, ``flash_d256_dkv``:
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` at D 256), while the
shared-bias gradient stays on the simple form, and whose fp32 forward,
dq and dk/dv run in 3xTF32 (``flash_f32_fwd``, ``flash_f32_dq``,
``flash_f32_dkv``).

Here, on the CPU:

- the route each kernel takes by dtype and head dim (``kernel_form`` per
  kernel; the wrappers driven with the card pretended and the kernel
  library replaced by a recorder, so the arguments a launch would get are
  read: the padded head dim, the tensor maps, the grid);
- the tensor maps at D 256: four 64-column boxes a row, dq's boxes of
  ``DQ_D256_KEYS`` rows, and dk/dv's grid of ``DKV_D256_KEYS`` keys a
  block;
- the padding to 256 (pad, the plain versions at 256 with the real D's
  scale, slice) against the JAX package's ``flash_attention`` (its Pallas
  kernels in interpret mode, which pad D to 256 lanes themselves) at D 192
  and 200: o, lse, dq, dk and dv within 1e-5 (fp32; the packages sum in
  other orders);
- ``TransformerLM`` at 2 heads of 256 (embed 512, 2 layers, vocab 512, S
  64, fp32, attention "fast") against the JAX package's, params carried by
  ``convert.params_from_jax``: the loss and the gradient of every
  parameter within 1e-5 relative and 1e-6 absolute (fp32 sums in other
  orders over 512-wide rows), the same as the LM step's parity test.
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
    lse = torch.zeros(bh, sq)
    return q, k, v, do, lse, torch.zeros(bh, sq)


# the C entry point each wrapper reaches, by the form kernel_form names
_ENTRY = {
    "fwd": {"tc": "apex_flash_fwd", "tc256": "apex_flash_fwd",
            "tc512": "apex_flash_d512_fwd", "f32": "apex_flash_f32_fwd",
            "f32_512": "apex_flash_f32_d512_fwd",
            "simt": "apex_flash_simt_fwd"},
    "dq": {"tc": "apex_flash_bwd_dq", "tc256": "apex_flash_bwd_dq",
           "tc512": "apex_flash_d512_dq", "f32": "apex_flash_f32_dq",
           "f32_512": "apex_flash_f32_d512_dq",
           "simt": "apex_flash_simt_dq"},
    "dkv": {"tc": "apex_flash_bwd_dkv", "tc256": "apex_flash_bwd_dkv",
            "f32": "apex_flash_f32_dkv", "simt": "apex_flash_simt_dkv"}}
# the wrapper that counts each form's launch
_COUNTER = {
    "fwd": {"tc": "flash_fwd", "tc256": "flash_d256_fwd",
            "tc512": "flash_d512_fwd", "f32": "flash_f32_fwd",
            "f32_512": "flash_f32_d512_fwd", "simt": "flash_simt_fwd"},
    "dq": {"tc": "flash_bwd_dq", "tc256": "flash_d256_dq",
           "tc512": "flash_d512_dq", "f32": "flash_f32_dq",
           "f32_512": "flash_f32_d512_dq", "simt": "flash_simt_dq"},
    "dkv": {"tc": "flash_bwd_dkv", "tc256": "flash_d256_dkv",
            "f32": "flash_f32_dkv", "simt": "flash_simt_dkv"}}


@pytest.mark.parametrize("dtype,d,fwd,dq,dkv", [
    (BF16, 129, "tc256", "tc256", "tc256"),
    (F16, 129, "tc256", "tc256", "tc256"),
    (BF16, 192, "tc256", "tc256", "tc256"),
    (F16, 255, "tc256", "tc256", "tc256"),
    (BF16, 256, "tc256", "tc256", "tc256"),
    (F16, 256, "tc256", "tc256", "tc256"),
    (F32, 129, "f32", "f32", "f32"), (F32, 256, "f32", "f32", "f32"),
    (F32, 257, "f32_512", "f32_512", "simt"),
    (BF16, 257, "tc512", "tc512", "simt"),
    (F16, 512, "tc512", "tc512", "simt"),
    (BF16, 64, "tc", "tc", "tc"), (F16, 100, "tc", "tc", "tc"),
    (BF16, 128, "tc", "tc", "tc"), (F32, 128, "f32", "f32", "f32")])
def test_each_kernel_takes_its_own_form(recorder, dtype, d, fwd, dq, dkv):
    """The forward, dq and dk/dv each take their own form (bf16/fp16 at D
    129-256 all three at D 256; past 256 the forward and dq at D 384 or
    512, dk/dv the simple form; fp32 at 129-256 all three in 3xTF32,
    past 256 the forward and dq in 3xTF32 at D 384 or 512).
    Each wrapper reaches its form's C entry point once and counts one
    launch on that form's wrapper alone; the shared-bias gradient takes
    the tensor-core kernel only where every 16-bit kernel does (D <=
    128)."""
    assert FA.kernel_form(torch.zeros(1, 2, d, dtype=dtype), "fwd") == fwd
    assert FA.kernel_form(torch.zeros(1, 2, d, dtype=dtype), "dq") == dq
    assert FA.kernel_form(torch.zeros(1, 2, d, dtype=dtype), "dkv") == dkv
    q, k, v, do, lse, delta = _inputs(dtype, d)
    kw = dict(causal=True, scale=d ** -0.5)
    names = sorted({n for forms in _COUNTER.values()
                    for n in forms.values()} | {"flash_bwd_dbias"})
    before = {n: getattr(FA, n).launches for n in names}
    FA.flash_fwd(q, k, v, **kw)
    FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    FA.flash_bwd_dbias(q, k, v, do, lse, delta,
                       bias=torch.zeros(1, q.shape[1], k.shape[1]), **kw)
    assert [c[0] for c in recorder.calls] == [
        _ENTRY["fwd"][fwd], _ENTRY["dq"][dq], _ENTRY["dkv"][dkv],
        "apex_flash_bwd_dbias" if dkv == "tc" else "apex_flash_simt_dbias"]
    counted = {n: getattr(FA, n).launches - before[n] for n in names}
    want = {n: 0 for n in names}
    for kernel, form in (("fwd", fwd), ("dq", dq), ("dkv", dkv)):
        want[_COUNTER[kernel][form]] += 1
    want["flash_bwd_dbias"] = 1
    assert counted == want


@pytest.mark.parametrize("d", [129, 200, 256])
def test_f32_backward_launches_get_inputs_padded_to_256(recorder, d):
    """fp32 dq (with dS) and dk/dv at D 129-256 launch the 3xTF32 kernels
    at D 256: q, k, v and dO zero-padded and read through their strides,
    the real D's scale, the bias and dropout passed on, outputs sliced
    back to D."""
    q, k, v, do, lse, delta = _inputs(F32, d)
    bh, sq, _ = q.shape
    sk = k.shape[1]
    kw = dict(causal=True, scale=d ** -0.5, q_start=3, k_start=1,
              bias=torch.zeros(bh, sq, sk), dropout_rate=0.1,
              dropout_seed=9)
    dq, ds = FA.flash_bwd_dq(q, k, v, do, lse, delta, return_ds=True, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert dq.shape == (bh, sq, d) and ds.shape == (bh, sq, sk)
    assert dk.shape == dv.shape == (bh, sk, d)
    (dq_name, da), (dkv_name, ka) = recorder.calls
    assert (dq_name, dkv_name) == ("apex_flash_f32_dq", "apex_flash_f32_dkv")
    for args in (da, ka):
        # dtype, q, k, v, dO, lse, delta, two outputs, 8 strides, _tail's 16
        assert args[0] == 0 and len(args) == 9 + 8 + 16
        assert list(args[9:17]) == [sq * 256, 256, sk * 256, 256,
                                    sk * 256, 256, sq * 256, 256]
        tail = args[17:]
        assert tail[2] is not None and tail[3] == sq * sk   # per-bh bias
        assert tail[6] == pytest.approx(1 / 0.9)
        assert tail[7:15] == (bh, sq, sk, 256, 3, 1, 1, d ** -0.5)
    assert da[8] is not None                                # dS asked


@pytest.mark.parametrize("d", [129, 192, 256])
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_d256_launches_get_inputs_padded_to_256(recorder, dtype, d):
    """At D 129-256 the forward, dq and dk/dv launch at D 256: q, k, v and
    dO zero-padded, the maps four boxes a row (dq's 32 rows deep), dk/dv's
    grid blocks of 64 keys, the real D's scale, outputs sliced back to
    D."""
    q, k, v, do, lse, delta = _inputs(dtype, d)
    bh, sq, _ = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    o, lse_out = FA.flash_fwd(q, k, v, causal=True, scale=scale)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=scale)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True,
                              scale=scale)
    assert o.shape == (bh, sq, d) and dq.shape == (bh, sq, d)
    assert dk.shape == dv.shape == (bh, sk, d)
    assert lse_out.shape == (bh, sq)
    (fwd_name, fa), (dq_name, da), (dkv_name, ka) = recorder.calls
    assert (fwd_name, dq_name, dkv_name) == (
        "apex_flash_fwd", "apex_flash_bwd_dq", "apex_flash_bwd_dkv")
    # forward: dtype, q, k, v, o, lse, maps, blocks, then _tail's 16
    maps = list(fa[6])
    es = q.element_size()
    assert maps == [256, sq, bh, 256 * es, sq * 256 * es, 64, 64, 1,
                    256, sk, bh, 256 * es, sk * 256 * es, 64, 64, 1,
                    256, sk, bh, 256 * es, sk * 256 * es, 64, 64, 1]
    assert fa[7] == FA.row_blocks(sq)
    tail = fa[8:]
    assert tail[7:11] == (bh, sq, sk, 256) and tail[14] == scale
    # dq: dtype, q, k, v, dO, lse, delta, dq, ds, maps, blocks, tail
    maps = list(da[9])
    assert len(maps) == 32
    assert [maps[8 * i + 6] for i in range(4)] == [FA.DQ_D256_KEYS] * 4
    assert [maps[8 * i] for i in range(4)] == [256] * 4
    assert da[10] == FA.row_blocks(sq) and da[11:][7:11] == (bh, sq, sk, 256)
    # dk/dv: dtype, q, k, v, dO, lse, delta, dk, dv, maps, blocks, tail;
    # the maps as the forward's (boxes of 64 rows), blocks of 64 keys
    maps = list(ka[9])
    assert len(maps) == 32
    assert [maps[8 * i + 6] for i in range(4)] == [64] * 4
    assert [maps[8 * i] for i in range(4)] == [256] * 4
    assert maps[8:11] == [256, sk, bh]
    assert FA.DKV_D256_KEYS == 64
    assert ka[10] == FA.row_blocks(sk, FA.DKV_D256_KEYS) == -(-sk // 64)
    assert ka[11:][7:11] == (bh, sq, sk, 256) and ka[11:][14] == scale


def test_d256_wrappers_refuse_what_they_do_not_take(recorder):
    """The D-256 wrappers take bf16 or fp16 at D 129-256 alone, before any
    launch."""
    for dt, d in ((BF16, 128), (F16, 64), (F32, 256), (BF16, 257)):
        q, k, v, do, lse, delta = _inputs(dt, d, sq=5, sk=5)
        with pytest.raises(ValueError, match="head dim of 129 to 256"):
            FA.flash_d256_fwd(q, k, v, causal=True)
        with pytest.raises(ValueError, match="head dim of 129 to 256"):
            FA.flash_d256_dq(q, k, v, do, lse, delta, causal=True,
                             scale=1.0)
        with pytest.raises(ValueError, match="head dim of 129 to 256"):
            FA.flash_d256_dkv(q, k, v, do, lse, delta, causal=True,
                              scale=1.0)
    assert recorder.calls == []


def test_kernel_form_names_its_kernels():
    with pytest.raises(ValueError, match="kernel must be one of"):
        FA.kernel_form(torch.zeros(1, 2, 64, dtype=BF16), "dbias")


# -- the maps -----------------------------------------------------------------

@pytest.mark.parametrize("box_rows", [64, 32])
def test_tma_layout_at_d256_is_four_boxes_a_row(box_rows):
    t = torch.zeros(5, 33, 256, dtype=BF16)
    lay = FA.tma_layout(t, box_rows)
    assert lay == (256, 33, 5, 512, 33 * 512, 64, box_rows, 1)
    assert lay[0] // lay[5] == 4
    # a strided view keeps its own strides
    wide = torch.zeros(5, 33, 3 * 256, dtype=F16)[..., 256:512]
    assert FA.tma_layout(wide)[:5] == (256, 33, 5, 3 * 512, 33 * 3 * 512)


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


@pytest.mark.parametrize("d", [192, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_padding_to_256_matches_jax(d, causal):
    """Pad to 256, run the plain versions there with the real D's scale,
    slice: JAX's o, lse, dq, dk and dv."""
    q, k, v, do = _case(2, 75, d, seed=d)
    want = _jax(q, k, v, do, causal)
    dp = FA.padded_head_dim(d)
    assert dp == 256
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
    got = [FA._unpad(t, d) for t in (o, dq, dk, dv)]
    for g, w in zip([got[0], lse, *got[1:]], want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


# -- the LM at 2 heads of 256 -------------------------------------------------

CFG = dict(vocab_size=512, max_seq_len=64, embed_dim=512, num_heads=2,
           num_layers=2, attn_impl="fast", head_chunk=512)
B, S = 2, 64


def test_lm_at_two_heads_of_256_matches_jax():
    """The port's TransformerLM at head dim 256 (its flash calls through
    the plain versions on the CPU) against the JAX package's (its Pallas
    kernels in interpret mode): the loss and every parameter's gradient."""
    jm = JLM(**CFG)
    jp = jm.init(jax.random.key(4))
    tm = TLM(**CFG, device="cpu")
    assert tm.embed_dim // tm.num_heads == 256
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(5).randint(0, 512, (B, S)).astype(np.int32)
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


# -- impl="auto" at head dims 129-256 -----------------------------------------

@pytest.mark.parametrize("d", [129, 200, 256])
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_auto_takes_d256_by_the_2gib_rule_alone(monkeypatch, dtype, d):
    """bf16/fp16 at D 129-256, every kernel on the tensor cores at D 256
    since dk/dv joined the forward and dq there, now cross over as D <= 128
    does: from ``DEFAULT_FLASH_MIN_S`` (the H100's crossover at head dim
    256), not by the 2 GiB rule alone; shorter calls go to the plain path
    unless their scores pass 2 GiB; a set ``flash_min_s`` still rules."""
    modules = importlib.import_module(
        "apex_tpu_torch.contrib.multihead_attn.modules")
    monkeypatch.setattr(modules, "_on_card", lambda t: True)
    mha = modules.SelfMultiheadAttn(512, 2, causal=True, impl="auto")
    long = torch.zeros(2, 4096, d, dtype=dtype)
    assert mha._flash_wins(long, long)
    at = torch.zeros(2, modules.DEFAULT_FLASH_MIN_S, d, dtype=dtype)
    assert mha._flash_wins(at, at)
    short = torch.zeros(2, modules.DEFAULT_FLASH_MIN_S - 1, d, dtype=dtype)
    assert not mha._flash_wins(short, short)
    big = torch.zeros(32768, 64, d, dtype=dtype)   # past 2 GiB, S 64
    assert mha._flash_wins(big, big)
    fixed = modules.SelfMultiheadAttn(512, 2, impl="auto", flash_min_s=8192)
    assert not fixed._flash_wins(long, long)


@pytest.mark.parametrize("d", [129, 256])
def test_auto_takes_fp32_past_128_by_the_2gib_rule_alone(monkeypatch, d):
    """fp32 at D 129-256 (the forward, dq and dk/dv in 3xTF32, whose
    forward loses to the plain path from S 1024 without a causal mask on
    the H100) gets no crossover length: only scores past 2 GiB, or a set
    ``flash_min_s``, take the kernels."""
    modules = importlib.import_module(
        "apex_tpu_torch.contrib.multihead_attn.modules")
    monkeypatch.setattr(modules, "_on_card", lambda t: True)
    mha = modules.SelfMultiheadAttn(512, 2, causal=True, impl="auto")
    long = torch.zeros(2, 4096, d)
    assert [FA.kernel_form(long, kn) for kn in ("fwd", "dq", "dkv")] == \
        ["f32"] * 3
    assert not mha._flash_wins(long, long)
    big = torch.zeros(8192, 128, d)                     # past 2 GiB
    assert mha._flash_wins(big, torch.zeros(8192, 4096, d))
    fixed = modules.SelfMultiheadAttn(512, 2, impl="auto", flash_min_s=1024)
    assert fixed._flash_wins(long, long)
