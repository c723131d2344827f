"""Port parity: the gradient of a learned bias [1, Sq, Sk] shared over bh
(``flash_bwd_dbias``), whose kernels (``csrc/flash_dbias.cu``) take every
head dim up to 512 in both dtype families: bf16/fp16 on ``wgmma``
("tc"), fp32 in 3xTF32 ("f32"). The simple form's dS summed over bh
(``flash_simt_dbias``) stays off every path, as a yardstick.

Here, on the CPU:

- the route by dtype and head dim (``kernel_form(q, "dbias")``; the
  wrapper driven with the card pretended and the kernel library replaced
  by a recorder, so the arguments a launch would get are read: one C
  entry point of the dtype family, never the simple form's, one launch
  counted on ``flash_bwd_dbias`` and none on the dq wrappers, as many
  arguments as the C signature has, the inputs at their width rounded up
  to 16 bytes and no padded copy past it, the runs' scratch and no [BH,
  Sq, Sk] tensor);
- the port's ``flash_attention`` gradients against the JAX package's
  ``flash_attention`` (its Pallas kernels in interpret mode, the shared
  bias's gradient from its own dbias kernel) with a learned [1, Sq, Sk]
  bias, causal, a kv_bias and dropout, Sq != Sk, at D 200 and 320, in
  fp32: o, lse, dq, dk, dv and dbias within atol 1e-5 plus rtol 1e-5 (the
  two sum the keys, and dbias the heads, in other orders), as
  ``tests/test_torch_flash_dropout.py`` holds them.
"""

import importlib
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.contrib.multihead_attn import flash_attention
from apex_tpu_torch.ops import flash_attn as FA

JFA = importlib.import_module(
    "apex_tpu.contrib.multihead_attn.flash_attention")

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
CSRC = Path(FA.__file__).resolve().parent / "cuda" / "csrc"


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


def _c_params(entry: str) -> list:
    """The parameter names of a C entry point of csrc/flash_dbias.cu."""
    text = (CSRC / "flash_dbias.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, entry
    return [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]


def _inputs(dtype, d, bh=3, sq=70, sk=90):
    rs = np.random.RandomState(d)
    q, do = (torch.from_numpy(rs.randn(bh, sq, d).astype(np.float32))
             .to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rs.randn(bh, sk, d).astype(np.float32))
            .to(dtype) for _ in range(2))
    bias = torch.from_numpy(rs.randn(1, sq, sk).astype(np.float32))
    return q, k, v, do, torch.zeros(bh, sq), torch.zeros(bh, sq), bias


# every wrapper that launches a dq kernel
_DQ = ("flash_bwd_dq", "flash_d256_dq", "flash_d512_dq", "flash_f32_dq",
       "flash_f32_d512_dq", "flash_simt_dq")
HEAD_DIMS = (64, 96, 128, 200, 256, 257, 320, 512)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [BF16, F16, F32], ids=["bf16", "f16",
                                                          "f32"])
def test_dbias_takes_its_dtype_familys_kernel_at_every_head_dim(
        recorder, dtype, d):
    """One launch of the dtype family's entry point, counted on
    ``flash_bwd_dbias`` alone, with the arguments of its C signature: q,
    k, v and dO at their width rounded up to a multiple of 8 (16-bit: TMA
    maps of 64 x 64 boxes) or 4 (fp32: strides), the real scale, the
    shared bias (bh stride 0), kv_bias and dropout passed on."""
    form = "f32" if dtype == F32 else "tc"
    assert FA.kernel_form(torch.zeros(1, 2, d, dtype=dtype), "dbias") == form
    q, k, v, do, lse, delta, bias = _inputs(dtype, d)
    bh, sq, _ = q.shape
    sk = k.shape[1]
    kvb = torch.zeros(bh, sk)
    kw = dict(causal=True, scale=d ** -0.5, q_start=3, k_start=1, bias=bias,
              kv_bias=kvb, dropout_rate=0.1, dropout_seed=9)
    names = ("flash_bwd_dbias", "flash_simt_dbias") + _DQ
    before = {n: getattr(FA, n).launches for n in names}
    db = FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw)
    assert db.shape == (1, sq, sk) and db.dtype == F32
    counted = {n: getattr(FA, n).launches - before[n] for n in names}
    assert counted == {n: int(n == "flash_bwd_dbias") for n in names}
    [(entry, args)] = recorder.calls
    assert entry == {"tc": "apex_flash_tc_dbias",
                     "f32": "apex_flash_f32_dbias"}[form]
    params = _c_params(entry)
    assert len(args) == len(params)
    at = dict(zip(params, args))
    unit = 8 if form == "tc" else 4
    dw = -(-d // unit) * unit
    runs = FA.dbias_runs(bh, sq, sk, 132)
    assert at["dtype"] == {BF16: 1, F16: 2, F32: 0}[dtype]
    assert (at["bh"], at["sq"], at["sk"], at["d"]) == (bh, sq, sk, dw)
    assert (at["q_start"], at["k_start"], at["causal"]) == (3, 1, 1)
    assert at["scale"] == d ** -0.5 and at["runs"] == runs
    assert at["bias"] is not None and at["bias_bh"] == 0
    assert at["kvb"] is not None and at["kvb_bh"] == sk
    assert at["drop_inv"] == pytest.approx(1 / 0.9)
    assert (at["part"] is not None) == (runs > 1)
    if form == "tc":
        maps = list(at["tma"])
        es = q.element_size()
        for i, s in enumerate((sq, sk, sk, sq)):
            assert maps[8 * i:8 * i + 8] == [dw, s, bh, dw * es,
                                             s * dw * es, 64, 64, 1]
    else:
        strides = [at[n] for n in ("q_bh", "q_s", "k_bh", "k_s", "v_bh",
                                   "v_s", "do_bh", "do_s")]
        assert strides == [sq * dw, dw, sk * dw, dw, sk * dw, dw, sq * dw,
                           dw]


def test_dbias_never_reaches_the_simple_form(recorder):
    """Across the dtypes and the head dims of every form of the other
    kernels (and the odd ones), the simple form's entry point is never
    called and its wrapper counts nothing."""
    before = FA.flash_simt_dbias.launches
    for dtype in (BF16, F16, F32):
        for d in (1, 7, 33, 64, 129, 255, 384, 500, 512):
            q, k, v, do, lse, delta, bias = _inputs(dtype, d, bh=2, sq=9,
                                                    sk=11)
            FA.flash_bwd_dbias(q, k, v, do, lse, delta, causal=False,
                               scale=0.1, bias=bias)
    assert FA.flash_simt_dbias.launches == before
    entries = {c[0] for c in recorder.calls}
    assert entries == {"apex_flash_tc_dbias", "apex_flash_f32_dbias"}
    assert len(recorder.calls) == 27


def test_dbias_allocates_no_per_bh_tensor(recorder, monkeypatch):
    """The wrapper's allocations: dbias [1, Sq, Sk] and the runs' scratch
    [runs, Sq, Sk] (runs < BH at these tiles), no [BH, Sq, Sk] dS, and no
    padded copy at a head dim that is a multiple of 16 bytes."""
    made = []
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", spy)
    for dtype in (BF16, F32):
        q, k, v, do, lse, delta, bias = _inputs(dtype, 64, bh=16, sq=600,
                                                sk=600)
        made.clear()
        FA.flash_bwd_dbias(q, k, v, do, lse, delta, causal=True, scale=0.125,
                           bias=bias)
        runs = FA.dbias_runs(16, 600, 600, 132)
        assert 1 < runs < 16
        assert sorted(made) == sorted([(1, 600, 600), (runs, 600, 600)])
    q, k, v, do, lse, delta, bias = _inputs(BF16, 320, bh=2, sq=9, sk=9)
    q2 = q.clone()
    FA.flash_bwd_dbias(q, k, v, do, lse, delta, causal=False, scale=0.1,
                       bias=bias)
    assert recorder.calls[-1][1][1] == q.data_ptr()     # q read in place
    assert torch.equal(q, q2)


def test_dbias_wrappers_refuse_a_bias_not_shared():
    q, k, v, do, lse, delta, _ = _inputs(F32, 64, bh=2, sq=5, sk=6)
    for fn in (FA.flash_bwd_dbias, FA.flash_simt_dbias):
        for bias in (None, torch.zeros(2, 5, 6), torch.zeros(5, 6)):
            with pytest.raises(ValueError, match=r"\[1, Sq, Sk\]"):
                fn(q, k, v, do, lse, delta, causal=False, scale=0.1,
                   bias=bias)


def test_simple_form_on_the_cpu_is_the_plain_version():
    """``flash_simt_dbias`` on CPU tensors runs ``flash_bwd_dbias_plain``
    and launches nothing, as ``flash_bwd_dbias`` does."""
    q, k, v, do, _, _, bias = _inputs(F32, 40, bh=2, sq=20, sk=24)
    kw = dict(causal=True, scale=40 ** -0.5, bias=bias, q_start=4,
              dropout_rate=0.2, dropout_seed=3)
    plain = {n: x for n, x in kw.items() if n != "bias"}
    o, lse = FA.reference_attention(q, k, v, bias, return_lse=True, **plain)
    delta = FA.flash_delta(o, do)
    before = (FA.flash_simt_dbias.launches, FA.flash_bwd_dbias.launches)
    got = FA.flash_simt_dbias(q, k, v, do, lse, delta, **kw)
    want = FA.flash_bwd_dbias_plain(q, k, v, do, lse, delta, **kw)
    assert torch.equal(got, want)
    assert torch.equal(FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw),
                       want)
    assert (FA.flash_simt_dbias.launches,
            FA.flash_bwd_dbias.launches) == before


# -- against JAX --------------------------------------------------------------

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [200, 320])
def test_shared_bias_gradient_matches_jax(d):
    """A learned [1, Sq, Sk] bias (some keys masked at -1e30), causal with
    q_start, a kv_bias, dropout 0.1, Sq 40 != Sk 52, bh 3: the port's
    ``flash_attention`` (the plain versions on the CPU, dbias summed over
    bh) against the JAX package's, o and lse and every gradient."""
    rs = np.random.RandomState(d)
    bh, sq, sk = 3, 40, 52
    q, do = (rs.randn(bh, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(bh, sk, d).astype(np.float32) for _ in range(2))
    dlse = rs.randn(bh, sq).astype(np.float32)
    bias = rs.randn(1, sq, sk).astype(np.float32)
    bias[0, :, ::7] = -1.0e30
    kv = np.where(rs.rand(bh, sk) < 0.2, -1.0e30, 0.0).astype(np.float32)
    kw = dict(causal=True, q_start=12, k_start=0, scale=d ** -0.5,
              dropout_rate=0.1, dropout_seed=77, return_lse=True)
    ins = (q, k, v, bias)

    def jfn(*a):
        return JFA.flash_attention(*a, kv_bias=jnp.asarray(kv), **kw)

    (o_j, lse_j), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in ins))
    grads_j = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    o, lse = flash_attention(*ts, kv_bias=torch.from_numpy(kv), **kw)
    grads = torch.autograd.grad((o, lse), ts, (torch.from_numpy(do),
                                               torch.from_numpy(dlse)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_j),
                               **TOL)
    for got, want in zip(grads, grads_j):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert grads[3].shape == (1, sq, sk) and grads[3].abs().sum() > 0
