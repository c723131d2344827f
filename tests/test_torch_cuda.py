"""The port's hand kernels on an NVIDIA card (marker ``cuda``).

Each kernel against its plain PyTorch version on the same card tensors,
the wrappers' refusals, a small engine whose paged greedy streams must
equal its dense ones while every kernel launches, and the CI ResNet's
training steps through the kernels against the plain versions. Without a card
every test here skips. On a machine with one (no JAX needed)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: f32 1e-5 (the kernels sum in another order); bf16 1e-2
absolute and relative (one bf16 rounding of the output).
"""

import pytest
import torch

from apex_tpu_torch.ops import decode_attn as DA
from apex_tpu_torch.ops import dispatch
from apex_tpu_torch.ops import layer_norm as LN

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_match_plain_and_each_other(card, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    s, h, length, page = 4, 2, 256, 16
    q = torch.randn(s, h, 128, generator=g, device=card).to(dtype)
    k = torch.randn(s, h, length, 128, generator=g, device=card).to(dtype)
    v = torch.randn(s, h, length, 128, generator=g, device=card).to(dtype)
    lengths = torch.tensor([0, 1, 100, length], dtype=torch.int32,
                           device=card)
    got = DA.decode_attention(q, k, v, lengths)
    _close(got, DA.decode_attention_plain(q, k, v, lengths), dtype)
    assert not got[0].any()                       # length 0 gives zeros
    # the same bytes as a page pool behind a shuffled table
    n_pages = length // page
    table = (torch.randperm(s * n_pages, generator=g, device=card)
             .to(torch.int32) + 1).reshape(s, n_pages)
    kp = torch.full((1 + s * n_pages, h, page, 128), 9.0, device=card,
                    dtype=dtype)
    vp = kp.clone()
    for t, c in ((kp, k), (vp, v)):
        t[table.reshape(-1).long()] = (c.reshape(s, h, n_pages, page, 128)
                                       .transpose(1, 2)
                                       .reshape(-1, h, page, 128))
    got_p = DA.paged_decode_attention(q, kp, vp, lengths, page_table=table)
    _close(got_p, DA.paged_decode_attention_plain(q, kp, vp, lengths,
                                                  page_table=table), dtype)
    assert torch.equal(got_p, got)                # one body, same bits


@pytest.mark.parametrize("rows", [1, 8, 37, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [256, 1001, 1024, 4096])
def test_ln_kernel_matches_plain(card, dtype, rows, f):
    g = torch.Generator(device=card).manual_seed(rows)
    x = (torch.randn(rows, f, generator=g, device=card) * 3 + 1).to(dtype)
    w = torch.randn(f, generator=g, device=card).to(dtype)
    b = torch.randn(f, generator=g, device=card).to(dtype)
    y, mean, inv = LN.ln_fwd(x, w, b, 1e-5)
    y0, mean0, inv0 = LN.ln_fwd_plain(x, w, b, 1e-5)
    _close(y, y0, dtype)
    _close(mean, mean0, torch.float32)
    _close(inv, inv0, torch.float32)
    y, _, _ = LN.ln_fwd(x, None, None, 1e-5)
    _close(y, LN.ln_fwd_plain(x, None, None, 1e-5)[0], dtype)


def test_ln_kernel_on_a_row_not_vector_aligned(card):
    """A view one element into its storage takes the scalar loads."""
    g = torch.Generator(device=card).manual_seed(5)
    buf = torch.randn(8 * 1024 + 1, generator=g, device=card)
    x = buf[1:].view(8, 1024)
    w = torch.randn(1024, generator=g, device=card)
    y, _, _ = LN.ln_fwd(x, w, w, 1e-5)
    _close(y, LN.ln_fwd_plain(x, w, w, 1e-5)[0], torch.float32)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros(2, 2, 64, device=card)
    kv = torch.zeros(2, 2, 16, 64, device=card)
    lengths = torch.ones(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        DA.decode_attention(q, kv, kv, lengths)
    q = torch.zeros(2, 2, 128, device=card)
    kv = torch.zeros(2, 2, 16, 128, device=card)
    with pytest.raises(TypeError, match="int32"):
        DA.decode_attention(q, kv, kv, lengths.long())
    with pytest.raises(TypeError, match="dtypes"):
        DA.decode_attention(q, kv.half(), kv.half(), lengths)
    pool = torch.zeros(5, 2, 4, 128, device=card)
    table = torch.ones(2, 2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="page_size"):
        DA.paged_decode_attention(q, pool, pool, lengths, page_table=table)
    with pytest.raises(NotImplementedError, match="wide"):
        LN.ln_fwd(torch.zeros(2, 8193, device=card), None, None, 1e-5)
    x = torch.zeros(4, 8, device=card).t()
    with pytest.raises(ValueError, match="contiguous"):
        LN.ln_fwd(x, None, None, 1e-5)


def test_engine_paged_equals_dense_through_the_kernels(card):
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                      poisson_requests)
    m = TransformerLM(vocab_size=512, max_seq_len=64, embed_dim=256,
                      num_heads=2, num_layers=2)
    p = m.init(0)
    reqs = poisson_requests(8, rate=0.0, prompt_dist="uniform:3,20",
                            new_dist="uniform:2,12", vocab_size=512,
                            seed=1, max_len=64, prefill_chunk=8)
    kw = dict(slots=3, max_len=64, prefill_chunk=8)
    counts = (DA.decode_attention, DA.paged_decode_attention, LN.ln_fwd)
    before = [c.launches for c in counts]
    dense, _ = ContinuousBatchingEngine(m, p, **kw).run(reqs)
    paged, _ = ContinuousBatchingEngine(m, p, paged=True, page_size=8,
                                        kv_pages=12, **kw).run(reqs)
    assert [r.tokens for r in paged] == [r.tokens for r in dense]
    assert all(c.launches > b for c, b in zip(counts, before))
    # and the plain versions on the same card give the same f32 streams
    with dispatch.backend("reference"):
        plain, _ = ContinuousBatchingEngine(m, p, **kw).run(reqs)
    assert [r.tokens for r in plain] == [r.tokens for r in dense]


# -- the training slice: scale and the two LAMB phases ------------------------

@pytest.mark.parametrize("n", [128, 128 * 8, 128 * 1037, 1001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scale_kernel_matches_plain(card, n, dtype):
    from apex_tpu_torch.ops import multi_tensor as MT
    g = torch.Generator(device=card).manual_seed(n)
    x = torch.randn(n, generator=g, device=card).to(dtype)
    s = torch.full((), 0.3, device=card)
    out, inf = MT.scale(x, s)
    out0, inf0 = MT.scale_plain(x, s)
    assert torch.equal(out, out0)          # one fp32 multiply, one rounding
    assert not bool(inf) and not bool(inf0)
    # an offset view takes the scalar loads
    out1, _ = MT.scale(x[1:], 0.3)
    assert torch.equal(out1, MT.scale_plain(x[1:], 0.3)[0])


@pytest.mark.parametrize("pos", [0, 64, -1])
@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_scale_kernel_flags_non_finite_input(card, pos, bad):
    from apex_tpu_torch.ops import multi_tensor as MT
    x = torch.ones(128 * 9 + 3, device=card)
    x[pos] = bad
    _, inf = MT.scale(x, 1.0)
    assert bool(inf)
    # the flag reads the input: a finite input that saturates is no overflow
    _, inf = MT.scale(torch.full((256,), 3e38, device=card), 10.0)
    assert not bool(inf)


def _lamb_inputs(card, dtype, sizes=(1000, 128, 77, 4096, 1)):
    from apex_tpu_torch.ops import flat
    g = torch.Generator(device=card).manual_seed(3)
    tree = {f"p{i}": torch.randn(n, generator=g, device=card)
            for i, n in enumerate(sizes)}
    p, table = flat.flatten(tree)
    mask = table.valid_mask(card)
    rnd = [torch.randn(table.total, generator=g, device=card) * mask
           for _ in range(3)]
    grad, m, v = rnd[0], rnd[1] * 0.1, rnd[2].abs() * 0.01
    return grad, p.to(dtype), m.to(dtype), v.to(dtype), table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", [0, 1])
def test_lamb_kernels_match_plain(card, dtype, mode):
    from apex_tpu_torch.ops import multi_tensor as MT
    grad, p, m, v, table = _lamb_inputs(card, dtype)
    step = torch.tensor(3, dtype=torch.int32, device=card)
    sc = MT.lamb_scalars(beta1=0.9, beta2=0.999, eps=1e-6, step=step,
                         bias_correction=True, weight_decay=0.01,
                         grad_averaging=True,
                         global_grad_norm=grad.norm(), max_grad_norm=1.0,
                         device=card)
    got = MT.lamb_phase1(grad, p, m, v, sc, mode)
    want = MT.lamb_phase1_plain(grad, p, m, v, sc, mode)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)           # same operations, same roundings
    for a, b in zip(got[3:], want[3:]):
        _close(a, b, torch.float32)        # row sums: another order
    ratio = torch.rand(table.num_segments, device=card)
    row_seg = table.row_segment_ids(card)
    assert torch.equal(MT.lamb_phase2(p, got[0], ratio, row_seg),
                       MT.lamb_phase2_plain(p, got[0], ratio, row_seg))
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, step=step,
              weight_decay=0.01, mode=mode, global_grad_norm=grad.norm(),
              max_grad_norm=1.0)
    a = MT.lamb_step(grad, p, m, v, table, **kw)
    b = MT.lamb_step(grad, p, m, v, table, **kw)
    c = MT.lamb_step_plain(grad, p, m, v, table, **kw)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)           # bitwise repeatable
        _close(x, z, dtype)


def test_multi_tensor_wrappers_refuse_what_the_kernels_do_not_take(card):
    from apex_tpu_torch.ops import kernels as K
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.ops import multi_tensor as MT
    with pytest.raises(TypeError, match="dtype"):
        MT.scale(torch.zeros(128, dtype=torch.float16, device=card), 1.0)
    with pytest.raises(ValueError, match="flat"):
        MT.scale(torch.zeros(2, 128, device=card), 1.0)
    grad, p, m, v, table = _lamb_inputs(card, torch.float32)
    sc = torch.ones(9, device=card)
    with pytest.raises(ValueError, match="multiple of 128"):
        MT.lamb_phase1(grad[:-1], p[:-1], m[:-1], v[:-1], sc, 0)
    with pytest.raises(TypeError, match="one dtype"):
        MT.lamb_phase1(grad, p, m.bfloat16(), v, sc, 0)
    tree = {"a": torch.zeros(3, device=card), "b": torch.zeros(5,
                                                               device=card)}
    buf, t1 = flat.flatten(tree, align=1)
    with pytest.raises(ValueError, match="row-aligned"):
        K.lamb_step(buf, buf, buf, buf, t1, aligned_segments=True, lr=1e-3,
                    beta1=0.9, beta2=0.999, eps=1e-6, step=1,
                    global_grad_norm=1.0)


def test_trainer_through_the_kernels_matches_plain(card):
    """Three O0 steps of the CI ResNet with the kernels and with the plain
    versions on the card: masters within 1e-4; every kernel of the step
    launched (the 9 BNs: one moments pass forward, one reduce and one dx
    pass backward, each)."""
    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.ops import multi_tensor as MT
    from apex_tpu_torch.ops import welford as WF
    from apex_tpu_torch.train import Trainer
    torch.backends.cudnn.deterministic = True
    m = ResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10, width=8)
    params, state = m.init(0)
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(4, 3, 32, 32, generator=g, device=card)
    y = torch.randint(0, 10, (4,), generator=g, device=card)

    def run():
        tr = Trainer(m, params, state, opt_level="O0")
        losses = [tr.step(x, y) for _ in range(3)]
        return tr.opt.state[0].master, torch.stack(losses)

    fns = (MT.scale, MT.lamb_phase1, MT.lamb_phase2, WF.bn_moments,
           WF.bn_backward_fused_reduce, WF.bn_backward_dx)
    before = [f.launches for f in fns]
    master, losses = run()
    after = [f.launches for f in fns]
    assert [a - b for a, b in zip(after, before)] == [3, 3, 3, 27, 27, 27]
    with dispatch.backend("reference"):
        master0, losses0 = run()
        assert [f.launches for f in fns] == after
    torch.testing.assert_close(master, master0, atol=1e-4, rtol=0)
    assert bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]


# -- the BatchNorm welford passes ---------------------------------------------

def _bn_case(card, rows, c, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn(rows, c, generator=g, device=card) * 2 + 0.5).to(dtype)
    dy = torch.randn(rows, c, generator=g, device=card).to(dtype)
    out = torch.relu(torch.randn(rows, c, generator=g, device=card)).to(dtype)
    s, sq = (x.float().sum(0), x.float().square().sum(0))
    mean = s / rows
    invvar = torch.rsqrt(sq / rows - mean * mean + 1e-5)
    return x, dy, out, mean, invvar


def _sums_close(got, want, terms):
    """Sums in another order: within 1e-5 of each column's sum of |terms|."""
    bound = 1e-5 * terms.abs().sum(0) + 1e-6
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("rows,c", [(1, 4), (37, 8), (1000, 64),
                                    (4099, 200), (300, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_welford_kernels_match_plain(card, rows, c, dtype):
    from apex_tpu_torch.ops import welford as WF
    x, dy, out, mean, invvar = _bn_case(card, rows, c, dtype, seed=rows)
    s, sq = WF.bn_moments(x)
    s0, sq0 = WF.bn_moments_plain(x)
    _sums_close(s, s0, x.float())
    _sums_close(sq, sq0, x.float().square())
    for mask in (None, out):
        sd, sx = WF.bn_backward_fused_reduce(dy, x, mean, invvar, mask)
        sd0, sx0 = WF.bn_backward_fused_reduce_plain(dy, x, mean, invvar,
                                                     mask)
        dyf = dy.float() * ((out.float() > 0) if mask is not None else 1.0)
        _sums_close(sd, sd0, dyf)
        _sums_close(sx, sx0, dyf * (x.float() - mean) * invvar)
        winv = invvar * 1.5
        args = (dy, x, mean, invvar, winv, sd0 / rows, sx0 / rows, mask)
        dx, dz = WF.bn_backward_dx(*args, emit_dz=True)
        dx0, dz0 = WF.bn_backward_dx_plain(*args, emit_dz=True)
        assert torch.equal(dx, dx0)        # same operations, same roundings
        assert torch.equal(dz, dz0)
        assert WF.bn_backward_dx(*args)[1] is None
    # two runs give the same bits: the chunks add in a fixed order
    assert torch.equal(WF.bn_moments(x)[1], sq)


def test_welford_wrappers_refuse_what_the_kernels_do_not_take(card):
    from apex_tpu_torch.ops import welford as WF
    x = torch.zeros(16, 6, device=card)
    with pytest.raises(ValueError, match="multiple of 4"):
        WF.bn_moments(x)
    x = torch.zeros(8, 16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        WF.bn_moments(torch.zeros(16, 8, device=card).t())
    mean = torch.zeros(16, device=card)
    with pytest.raises(ValueError, match="one dtype"):
        WF.bn_backward_fused_reduce(x.bfloat16(), x, mean, mean)
    with pytest.raises(ValueError, match="per-channel"):
        WF.bn_backward_dx(x, x, mean[:8], mean, mean, mean, mean)
    with pytest.raises(TypeError, match="dtype"):
        WF.bn_moments(x.double())


# -- the LM training slice: Adam, LayerNorm backward, flash attention ---------

@pytest.mark.parametrize("n", [4, 1000, 128 * 1037])
@pytest.mark.parametrize("gdt,pdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("mode", [0, 1])
def test_adam_kernel_is_bit_equal_to_plain(card, n, gdt, pdt, mode):
    from apex_tpu_torch.ops import multi_tensor as MT
    g = torch.Generator(device=card).manual_seed(n)
    grad = torch.randn(n, generator=g, device=card).to(gdt)
    p = torch.randn(n, generator=g, device=card).to(pdt)
    m = (torch.randn(n, generator=g, device=card) * 0.1).to(pdt)
    v = (torch.rand(n, generator=g, device=card) * 0.01).to(pdt)
    sc = MT.adam_scalars(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                         step=torch.tensor(3, device=card),
                         bias_correction=True, weight_decay=0.01,
                         device=card)
    before = MT.adam.launches
    got = MT.adam(grad, p, m, v, sc, mode)
    assert MT.adam.launches == before + 1
    for a, b in zip(got, MT.adam_plain(grad, p, m, v, sc, mode)):
        assert torch.equal(a, b)           # same operations, same roundings


@pytest.mark.parametrize("rows,f", [(0, 256), (1, 4), (37, 256), (37, 1000),
                                    (300, 4096), (4099, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_bwd_kernel_matches_plain_and_repeats(card, rows, f, dtype):
    g = torch.Generator(device=card).manual_seed(rows + f)
    x = (torch.randn(rows, f, generator=g, device=card) * 3 + 1).to(dtype)
    dy = torch.randn(rows, f, generator=g, device=card).to(dtype)
    w = torch.randn(f, generator=g, device=card).to(dtype)
    _, mean, inv = LN.ln_fwd(x, w, w, 1e-5)
    for weight in (w, None):
        got = LN.ln_bwd(dy, x, weight, mean, inv)
        want = LN.ln_bwd_plain(dy, x, weight, mean, inv)
        _close(got[0], want[0], dtype)
        if weight is not None:
            xhat = (x.float() - mean[:, None]) * inv[:, None]
            _sums_close(got[1], want[1], dy.float() * xhat)
            _sums_close(got[2], want[2], dy.float())
        again = LN.ln_bwd(dy, x, weight, mean, inv)
        assert all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None)         # no float atomics


def test_layer_norm_autograd_runs_the_kernels(card):
    from apex_tpu_torch.normalization import fused_layer_norm_affine
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(4, 9, 256, generator=g, device=card,
                    dtype=torch.bfloat16).requires_grad_(True)
    w = torch.randn(256, generator=g, device=card).requires_grad_(True)
    b = torch.randn(256, generator=g, device=card).requires_grad_(True)
    dy = torch.randn(4, 9, 256, generator=g, device=card,
                     dtype=torch.bfloat16)
    before = (LN.ln_fwd.launches, LN.ln_bwd.launches)
    y = fused_layer_norm_affine(x, (256,), w, b, 1e-5)
    dx, dw, db = torch.autograd.grad(y, (x, w, b), dy)
    assert (LN.ln_fwd.launches, LN.ln_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    with dispatch.backend("reference"):
        y0 = fused_layer_norm_affine(x, (256,), w, b, 1e-5)
        dx0, dw0, db0 = torch.autograd.grad(y0, (x, w, b), dy)
    _close(dx, dx0, torch.bfloat16)
    _close(dw, dw0, torch.float32)
    _close(db, db0, torch.float32)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32


def _flash_close(got, want):
    """The kernels round P and dS to bf16 before their second products:
    each element within 2 bf16 ulps of itself plus 2^-6 of its row's RMS
    over D, a row's RMS taken as at least 2^-6 of the tensor's (the rule
    of chip_smoke.py's flash check)."""
    a, b = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(a), torch.frexp(
        torch.maximum(a.abs(), b.abs()))[1] - 8)
    rms = torch.clamp(b.pow(2).mean(-1, keepdim=True).sqrt(),
                      min=2.0 ** -6 * float(b.pow(2).mean().sqrt()))
    assert bool(((a - b).abs() <= 2 * ulp + 2.0 ** -6 * rms).all())


@pytest.mark.parametrize("bh,sq,sk,d,causal,q_start", [
    (3, 40, 40, 64, True, 0), (2, 257, 257, 128, True, 0),
    (2, 257, 300, 64, False, 0), (2, 33, 100, 64, True, 67),
    (2, 130, 100, 128, True, -50), (1, 1, 1, 64, False, 0)])
def test_flash_kernels_match_plain(card, bh, sq, sk, d, causal, q_start):
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(sq + sk)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=card).to(torch.bfloat16)

    q, do = rnd(bh, sq, d), rnd(bh, sq, d)
    k, v = rnd(bh, sk, d), rnd(bh, sk, d)
    dlse = torch.randn(bh, sq, generator=g, device=card)
    kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    with dispatch.backend("reference"):
        o0, lse0 = FA.flash_fwd(q, k, v, **kw)
    _flash_close(o, o0)
    live = lse0 > FA.NEG_INF * 0.5
    assert float(torch.where(live, (lse - lse0).abs(), 0.0).max()) <= 1e-3
    assert torch.equal(lse[~live], lse0[~live]) and not o[~live].any()
    delta = FA.flash_delta(o, do, dlse)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq0, dk0, dv0 = FA.flash_bwd_plain(q, k, v, do, lse, delta, **kw)
    for a, b in ((dq, dq0), (dk, dk0), (dv, dv0)):
        _flash_close(a, b)
    # each block owns its output rows: bitwise repeatable
    assert torch.equal(FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)[0],
                       dk)


def test_flash_reads_strided_views(card):
    """The time-major MHA split (``_split_heads``) gives [BH, S, D]
    transposed views, strides (D, BH·D, 1); the kernels read them through
    their strides, the same bits as from contiguous copies."""
    from apex_tpu_torch.contrib.multihead_attn import flash_attention
    g = torch.Generator(device=card).manual_seed(4)
    t, b, h, d = 70, 2, 2, 64
    qkv = torch.randn(t, b, 3 * h * d, generator=g, device=card).to(
        torch.bfloat16)
    q, k, v = (x.reshape(t, b * h, d).transpose(0, 1)
               for x in torch.split(qkv, h * d, dim=-1))
    assert not q.is_contiguous()
    o = flash_attention(q, k, v, causal=True)
    o0 = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=True)
    assert torch.equal(o, o0)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(card):
    from apex_tpu_torch.contrib.multihead_attn import flash_attention
    from apex_tpu_torch.ops import flash_attn as FA
    q = torch.zeros(2, 16, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        FA.flash_fwd(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros(2, 16, 32, device=card, dtype=torch.bfloat16)
        FA.flash_fwd(x, x, x)
    with pytest.raises(NotImplementedError, match="item 15"):
        flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="kv_bias"):
        FA.flash_fwd(q, q, q, kv_bias=torch.zeros(3, 16, device=card))
    with pytest.raises(ValueError, match="fp32"):
        FA.flash_bwd_dq(q, q, q, q, torch.zeros(2, 16, device=card),
                        torch.zeros(2, 15, device=card), causal=True,
                        scale=0.125)


def test_lm_trainer_through_the_kernels_matches_plain(card):
    """Three bf16 O2 steps of a small LM with the kernels and with the
    plain versions on the card: every kernel of the step launched (per
    step one flash forward, dq and dk/dv per layer, five LayerNorms
    forward and backward, one Adam), losses finite, falling and close to
    the plain run's, and the same bits when run twice."""
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.ops import flash_attn as FA
    from apex_tpu_torch.ops import multi_tensor as MT
    from apex_tpu_torch.train import LMTrainer
    m = TransformerLM(vocab_size=512, max_seq_len=256, embed_dim=128,
                      num_heads=2, num_layers=2, attn_impl="fast",
                      head_chunk=256)
    params = m.init(0)
    toks = torch.randint(0, 512, (2, 257), generator=torch.Generator()
                         .manual_seed(1)).to(card)

    def run():
        tr = LMTrainer(m, params, lr=1e-3)
        return torch.stack([tr.step(toks) for _ in range(3)]), tr

    fns = (FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv, LN.ln_fwd,
           LN.ln_bwd, MT.adam)
    before = [f.launches for f in fns]
    losses, tr = run()
    after = [f.launches for f in fns]
    assert [a - b for a, b in zip(after, before)] == [6, 6, 6, 15, 15, 3]
    losses2, tr2 = run()
    assert torch.equal(losses, losses2)
    assert torch.equal(tr.opt.state[0].master, tr2.opt.state[0].master)
    with dispatch.backend("reference"):
        before = [f.launches for f in fns]
        losses0, _ = run()
        # the backward too, which runs on the autograd device thread
        assert [f.launches for f in fns] == before
    assert bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]
    torch.testing.assert_close(losses, losses0, atol=2e-2, rtol=0)


# -- the ImageNet slice: per-row norms, SGD, NovoGrad -------------------------

@pytest.mark.parametrize("n", [128, 128 * 8, 128 * 1037])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_norm_kernels_match_plain(card, n, dtype):
    from apex_tpu_torch.ops import multi_tensor as MT
    g = torch.Generator(device=card).manual_seed(n)
    x = (torch.randn(n, generator=g, device=card) * 3).to(dtype)
    before = (MT.rowsumsq.launches, MT.rowmaxabs.launches)
    s, mx = MT.rowsumsq(x), MT.rowmaxabs(x)
    assert (MT.rowsumsq.launches, MT.rowmaxabs.launches) == (
        before[0] + 1, before[1] + 1)
    # the row's sum adds in another order: within 1e-5 relative
    torch.testing.assert_close(s, MT.rowsumsq_plain(x), rtol=1e-5, atol=0)
    assert torch.equal(mx, MT.rowmaxabs_plain(x))     # a max is exact
    y = x.clone()
    y[-1] = float("-inf")
    assert MT.rowmaxabs(y)[-1].item() == float("inf")
    y[5] = float("nan")                   # NaN wins over any value
    assert torch.isnan(MT.rowmaxabs(y)[0])


def test_per_segment_norms_through_the_kernels(card):
    from apex_tpu_torch.ops import kernels as K
    from apex_tpu_torch.ops import dispatch as D
    grad, _, _, _, table = _lamb_inputs(card, torch.float32)
    l2 = K.l2norm_per_segment(grad, table, aligned_segments=True)
    mx = K.maxnorm_per_segment(grad, table, aligned_segments=True)
    with D.backend("reference"):
        l20 = K.l2norm_per_segment(grad, table, aligned_segments=True)
        mx0 = K.maxnorm_per_segment(grad, table, aligned_segments=True)
    torch.testing.assert_close(l2, l20, rtol=1e-5, atol=0)
    assert torch.equal(mx, mx0)
    # fixed-order segment sums: two runs give the same bits
    assert torch.equal(K.l2norm_per_segment(grad, table,
                                            aligned_segments=True), l2)


@pytest.mark.parametrize("flags", range(16))
@pytest.mark.parametrize("gdt,pdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("first_run", [False, True])
def test_sgd_kernel_is_bit_equal_to_plain(card, flags, gdt, pdt, first_run):
    from apex_tpu_torch.ops import multi_tensor as MT
    n = 128 * 37 + 4
    g = torch.Generator(device=card).manual_seed(flags)
    grad = torch.randn(n, generator=g, device=card).to(gdt)
    p = torch.randn(n, generator=g, device=card).to(pdt)
    m = (torch.randn(n, generator=g, device=card) * 0.1).to(pdt)
    sc = MT.sgd_scalars(wd=1e-4, lr=0.1, momentum=0.9, dampening=0.1,
                        first_run=torch.tensor(first_run, device=card),
                        scale=torch.tensor(0.5, device=card), device=card)
    before = MT.sgd.launches
    got = MT.sgd(grad, p, m, sc, flags)
    assert MT.sgd.launches == before + 1
    for a, b in zip(got, MT.sgd_plain(grad, p, m, sc, flags)):
        assert torch.equal(a, b)           # same operations, same roundings


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("gdt,pdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_novograd_kernel_is_bit_equal_to_plain(card, mode, gdt, pdt):
    from apex_tpu_torch.ops import multi_tensor as MT
    grad, p, m, _, table = _lamb_inputs(card, pdt)
    grad = grad.to(gdt)
    g = torch.Generator(device=card).manual_seed(mode)
    denom = torch.rand(table.num_segments, generator=g, device=card) + 0.1
    row_seg = table.row_segment_ids(card)
    sc = MT.novograd_scalars(lr=1e-2, beta1=0.95, weight_decay=1e-3,
                             grad_averaging=True,
                             bc1=torch.tensor(0.1426, device=card),
                             device=card)
    before = MT.novograd.launches
    got = MT.novograd(grad, p, m, denom, row_seg, sc, mode)
    assert MT.novograd.launches == before + 1
    for a, b in zip(got, MT.novograd_plain(grad, p, m, denom, row_seg, sc,
                                           mode)):
        assert torch.equal(a, b)
    # the whole step: norms, blend and update, against its plain run
    v = torch.rand(table.num_segments, generator=g, device=card)
    kw = dict(lr=1e-2, beta1=0.95, beta2=0.98, eps=1e-8,
              step=torch.tensor(3, device=card), weight_decay=1e-3,
              mode=mode)
    for nt in (MT.NORM_LINF, MT.NORM_L2):
        a = MT.novograd_step(grad, p, m, v, table, norm_type=nt, **kw)
        with dispatch.backend("reference"):
            b = MT.novograd_step(grad, p, m, v, table, norm_type=nt, **kw)
        for x, y in zip(a, b):
            torch.testing.assert_close(x.float(), y.float(), rtol=1e-5,
                                       atol=1e-7)


def test_optimizer_kernel_wrappers_refuse_what_the_kernels_do_not_take(card):
    from apex_tpu_torch.ops import multi_tensor as MT
    x = torch.zeros(256, device=card)
    with pytest.raises(ValueError, match="multiple of 128"):
        MT.rowsumsq(x[:200])
    with pytest.raises(TypeError, match="dtype"):
        MT.rowmaxabs(x.half())
    with pytest.raises(ValueError, match="aligned"):
        MT.rowsumsq(torch.zeros(260, device=card)[1:257])
    sc6 = torch.zeros(6, device=card)
    with pytest.raises(ValueError, match="multiple of 4"):
        MT.sgd(x[:6], x[:6], x[:6], sc6, 0)
    with pytest.raises(TypeError, match="one dtype"):
        MT.sgd(x, x, x.bfloat16(), sc6, 0)
    with pytest.raises(ValueError, match=r"fp32 \[6\]"):
        MT.sgd(x, x, x, torch.zeros(5, device=card), 0)
    seg = torch.zeros(2, dtype=torch.int32, device=card)
    sc5 = torch.zeros(5, device=card)
    with pytest.raises(ValueError, match="row_seg"):
        MT.novograd(x, x, x, x[:1], seg.long(), sc5, 0)
    with pytest.raises(ValueError, match="mode"):
        MT.novograd(x, x, x, x[:1], seg, sc5, 2)


@pytest.mark.parametrize("case", ["sgd", "larc", "novograd_l2",
                                  "novograd_linf"])
def test_imagenet_trainer_through_the_kernels_matches_plain(card, case):
    """Three O0 steps of main_amp's step on the CI ResNet (uint8 NHWC
    batch) with the kernels and with the plain versions on the card:
    masters within 1e-4; the optimizer's kernels launched as designed and
    none in the plain run; two kernel runs give the same bits."""
    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.ops import multi_tensor as MT
    from apex_tpu_torch.train import Trainer
    torch.backends.cudnn.deterministic = True
    m = ResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10, width=8)
    params, state = m.init(0)
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randint(0, 256, (4, 32, 32, 3), generator=g, device=card,
                      dtype=torch.uint8)
    y = torch.randint(0, 10, (4,), generator=g, device=card)
    kw = {"sgd": dict(optimizer="sgd"),
          "larc": dict(optimizer="sgd", larc=True),
          "novograd_l2": dict(optimizer="novograd", lr=1e-2),
          "novograd_linf": dict(optimizer="novograd", lr=1e-2,
                                norm_type=0)}[case]
    per_step = {"sgd": (1, 0, 0, 0), "larc": (1, 2, 0, 0),
                "novograd_l2": (0, 1, 0, 1),
                "novograd_linf": (0, 0, 1, 1)}[case]

    def run():
        tr = Trainer(m, params, state, opt_level="O0", **kw)
        losses = [tr.step(x, y) for _ in range(3)]
        return tr.opt.state[0], torch.stack(losses)

    fns = (MT.sgd, MT.rowsumsq, MT.rowmaxabs, MT.novograd)
    before = [f.launches for f in fns]
    gs, losses = run()
    after = [f.launches for f in fns]
    assert [a - b for a, b in zip(after, before)] == [3 * k for k in per_step]
    gs2, _ = run()
    assert torch.equal(gs.master, gs2.master)
    again = [f.launches for f in fns]
    with dispatch.backend("reference"):
        gs0, losses0 = run()
        # the backward too, which runs on the autograd device thread
        assert [f.launches for f in fns] == again
    torch.testing.assert_close(gs.master, gs0.master, atol=1e-4, rtol=0)
    assert bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]


# -- the seq2seq slice: softmax cross-entropy, kv_bias flash ----------------


@pytest.mark.parametrize("n,v", [(0, 37), (1, 1), (37, 37), (64, 1001),
                                 (40, 4096), (33, 37000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_xent_kernels_match_plain_and_repeat(card, n, v, dtype, smoothing):
    """Loss and lse within 1e-5 relative of the plain versions (the row's
    sums in another order); dx bit-equal to the plain version's in fp32
    and bf16 (given lse, each element is the same expf and _rn
    operations, then one round to nearest); a label at V - 1, one
    outside [0, V); int32 and int64 labels; two runs equal bit for
    bit."""
    from apex_tpu_torch.ops import xentropy as XE
    g = torch.Generator(device=card).manual_seed(n + v)
    x = (torch.randn(n, v, generator=g, device=card) * 3).to(dtype)
    lab = torch.randint(0, v, (n,), generator=g, device=card)
    if n > 2:
        lab[1], lab[2] = v - 1, -1
    gr = torch.randn(n, generator=g, device=card)
    for labels in (lab, lab.to(torch.int32)):
        loss, lse = XE.xent_fwd(x, labels, smoothing)
        loss0, lse0 = XE.xent_fwd_plain(x, labels, smoothing)
        torch.testing.assert_close(loss, loss0, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(lse, lse0, atol=1e-5, rtol=1e-5)
        dx = XE.xent_bwd(x, labels, lse, gr, smoothing)
        dx0 = XE.xent_bwd_plain(x, labels, lse, gr, smoothing)
        assert dx.dtype == dtype and dx.shape == (n, v)
        assert torch.equal(dx, dx0), float((dx.float() - dx0.float())
                                           .abs().max())
        again = XE.xent_fwd(x, labels, smoothing)
        assert torch.equal(again[0], loss) and torch.equal(again[1], lse)
        assert torch.equal(XE.xent_bwd(x, labels, lse, gr, smoothing), dx)


def test_xent_kernels_read_a_strided_view(card):
    """Logits that are the first V columns of a wider buffer (a row stride
    that is not V) give the bits of a contiguous copy."""
    from apex_tpu_torch.ops import xentropy as XE
    g = torch.Generator(device=card).manual_seed(3)
    wide = torch.randn(9, 1003, generator=g, device=card)
    x = wide[:, :1000]
    lab = torch.randint(0, 1000, (9,), generator=g, device=card)
    gr = torch.randn(9, generator=g, device=card)
    got = XE.xent_fwd(x, lab, 0.1)
    want = XE.xent_fwd(x.contiguous(), lab, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(XE.xent_bwd(x, lab, got[1], gr, 0.1),
                       XE.xent_bwd(x.contiguous(), lab, got[1], gr, 0.1))


def test_xent_wrappers_refuse_what_the_kernels_do_not_take(card):
    from apex_tpu_torch.ops import xentropy as XE
    x = torch.zeros(4, 8, device=card)
    lab = torch.zeros(4, dtype=torch.long, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        XE.xent_fwd(x.half(), lab, 0.0)
    with pytest.raises(ValueError, match="labels"):
        XE.xent_fwd(x, lab.float(), 0.0)
    with pytest.raises(ValueError, match="V >= 1"):
        XE.xent_fwd(torch.zeros(4, 0, device=card), lab, 0.0)
    with pytest.raises(ValueError, match="g"):
        XE.xent_bwd(x, lab, torch.zeros(4, device=card),
                    torch.zeros(3, device=card), 0.0)


@pytest.mark.parametrize("bh,sq,sk,d,causal,shared", [
    (3, 40, 40, 64, True, False), (4, 129, 128, 64, False, False),
    (2, 257, 257, 128, False, True), (4, 129, 129, 64, True, False),
    (2, 1, 70, 64, False, False)])
def test_flash_kv_bias_kernels_match_plain(card, bh, sq, sk, d, causal,
                                           shared):
    """The three kernels with a per-key bias (key-padding masks plus small
    finite values), shared or per bh, bh 0 masking every key: the
    per-element rule of ``_flash_close``; the fully masked rows give
    o = 0, lse = NEG_INF and no gradient, as the plain versions."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(sq + sk + bh)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=card).to(torch.bfloat16)

    q, do = rnd(bh, sq, d), rnd(bh, sq, d)
    k, v = rnd(bh, sk, d), rnd(bh, sk, d)
    dlse = torch.randn(bh, sq, generator=g, device=card)
    rows = 1 if shared else bh
    lengths = torch.randint(sk // 2, sk + 1, (rows,), generator=g,
                            device=card)
    if not shared:
        lengths[0] = 0
    keep = torch.arange(sk, device=card)[None, :] < lengths[:, None]
    kvb = torch.where(keep, torch.randn(rows, sk, generator=g, device=card)
                      * 0.5, torch.full((rows, sk), FA.NEG_INF,
                                        device=card))
    kw = dict(causal=causal, scale=d ** -0.5, kv_bias=kvb)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    o0, lse0 = FA.reference_attention(q, k, v, return_lse=True, **kw)
    _flash_close(o, o0)
    live = lse0 > FA.NEG_INF * 0.5
    assert float(torch.where(live, (lse - lse0).abs(), 0.0).max()) <= 1e-3
    assert torch.equal(lse[~live], lse0[~live]) and not o[~live].any()
    delta = FA.flash_delta(o, do, dlse)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq0, dk0, dv0 = FA.flash_bwd_plain(q, k, v, do, lse, delta, **kw)
    for a, b in ((dq, dq0), (dk, dk0), (dv, dv0)):
        _flash_close(a, b)
    if not shared:
        assert not (dq[0].any() or dk[0].any() or dv[0].any())
    assert torch.equal(FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)[0],
                       dk)
    assert torch.equal(FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw), dq)


def test_lm_full_logits_loss_through_the_kernels_matches_plain(card):
    """``TransformerLM(head_chunk=0).loss`` runs the softmax cross-entropy
    kernels once each a step; its loss and gradients are within 1e-4 of
    the plain versions' on the card (f32)."""
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.ops import xentropy as XE
    m = TransformerLM(vocab_size=1000, max_seq_len=64, embed_dim=128,
                      num_heads=2, num_layers=2, attn_impl="default")
    params = {k: v for k, v in m.init(0).items()}
    toks = torch.randint(0, 1000, (2, 33), generator=torch.Generator()
                         .manual_seed(2)).to(card)

    def run():
        p = {k: v for k, v in params.items()}
        emb = p["tok_emb"].clone().requires_grad_(True)
        p["tok_emb"] = emb
        loss = m.loss(p, toks)
        (g,) = torch.autograd.grad(loss, emb)
        return loss, g

    before = XE.xent_fwd.launches, XE.xent_bwd.launches
    loss, g = run()
    assert (XE.xent_fwd.launches - before[0],
            XE.xent_bwd.launches - before[1]) == (1, 1)
    with dispatch.backend("reference"):
        loss0, g0 = run()
    torch.testing.assert_close(loss, loss0, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(g, g0, atol=1e-4, rtol=1e-4)


def test_seq2seq_trainer_through_the_kernels_matches_plain(card):
    """Three bf16 O2 steps of a small Seq2Seq Transformer (ragged sources,
    label smoothing 0.1) with the kernels and with the plain versions on
    the card: every kernel of the step launched (per step one of each
    xent kernel, three of each flash kernel per decoder layer and one per
    encoder layer, 2·enc + 3·dec + 2 LayerNorms forward and backward, one
    Adam), none in the plain run, losses finite, falling and close to
    the plain run's, and the same bits when run twice."""
    from apex_tpu_torch.models import Seq2SeqTransformer
    from apex_tpu_torch.ops import flash_attn as FA
    from apex_tpu_torch.ops import multi_tensor as MT
    from apex_tpu_torch.ops import xentropy as XE
    from apex_tpu_torch.train import LMTrainer
    m = Seq2SeqTransformer(src_vocab_size=500, tgt_vocab_size=500,
                           max_seq_len=64, embed_dim=128, num_heads=2,
                           num_encoder_layers=2, num_decoder_layers=1,
                           attn_impl="fast")
    params = m.init(0)
    g = torch.Generator().manual_seed(1)
    src = torch.randint(3, 500, (4, 40), generator=g)
    tgt = torch.randint(3, 500, (4, 42), generator=g)
    for i, n in enumerate((40, 31, 17, 5)):
        src[i, n:] = 0
        tgt[i, n + 2:] = 0
    src, tgt = src.to(card), tgt.to(card)

    def run():
        tr = LMTrainer(m, params, lr=5e-4, betas=(0.9, 0.98), eps=1e-9)
        losses = [tr.step(src, tgt, label_smoothing=0.1) for _ in range(3)]
        return torch.stack(losses), tr

    fns = (XE.xent_fwd, XE.xent_bwd, FA.flash_fwd, FA.flash_bwd_dq,
           FA.flash_bwd_dkv, LN.ln_fwd, LN.ln_bwd, MT.adam)
    before = [f.launches for f in fns]
    losses, tr = run()
    after = [f.launches for f in fns]
    assert [a - b for a, b in zip(after, before)] == \
        [3, 3, 12, 12, 12, 27, 27, 3]
    losses2, tr2 = run()
    assert torch.equal(losses, losses2)
    assert torch.equal(tr.opt.state[0].master, tr2.opt.state[0].master)
    with dispatch.backend("reference"):
        before = [f.launches for f in fns]
        losses0, _ = run()
        assert [f.launches for f in fns] == before
    assert bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]
    torch.testing.assert_close(losses, losses0, atol=2e-2, rtol=0)


# -- gradient accumulation and fp16_utils: axpby, l2norm, Adagrad -------------

DT_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
            (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("n", [1, 4, 1001, 128 * 1037])
@pytest.mark.parametrize("xdt,ydt", DT_PAIRS)
@pytest.mark.parametrize("arg_to_check", [-1, 0, 1])
def test_axpby_kernel_is_bit_equal_to_plain(card, n, xdt, ydt,
                                            arg_to_check):
    from apex_tpu_torch.ops import multi_tensor as MT
    g = torch.Generator(device=card).manual_seed(n)
    x = (torch.randn(n, generator=g, device=card) * 1e3).to(xdt)
    y = torch.randn(n, generator=g, device=card).to(ydt)
    a = torch.full((), 2.0 ** -10, device=card)
    before = MT.axpby.launches
    got, fi = MT.axpby(a, x, 1.0, y, arg_to_check)
    assert MT.axpby.launches == before + 1
    want, fi0 = MT.axpby_plain(a, x, 1.0, y, arg_to_check)
    assert got.dtype == xdt and torch.equal(got, want)
    assert not bool(fi) and not bool(fi0)
    # an unaligned view takes the scalar path, same bits
    if n > 4:
        got_u, _ = MT.axpby(0.5, x[1:], -3.0, y[1:], arg_to_check)
        assert torch.equal(got_u, MT.axpby_plain(0.5, x[1:], -3.0, y[1:],
                                                 arg_to_check)[0])


@pytest.mark.parametrize("pos", [0, 64, -1])
@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
@pytest.mark.parametrize("arg", ["x", "y"])
def test_axpby_kernel_flags_the_checked_input(card, pos, bad, arg):
    from apex_tpu_torch.ops import multi_tensor as MT
    x = torch.ones(1001, device=card)
    y = torch.ones(1001, device=card)
    (x if arg == "x" else y)[pos] = bad
    for arg_to_check in (-1, 0, 1):
        want = arg_to_check == -1 or arg_to_check == (0 if arg == "x" else 1)
        assert bool(MT.axpby(0.5, x, 1.0, y, arg_to_check)[1]) == want
        assert bool(MT.axpby_plain(0.5, x, 1.0, y, arg_to_check)[1]) == want


@pytest.mark.parametrize("n", [1, 5, 1000, 128 * 1037, 3_000_001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2norm_kernel_matches_plain_and_repeats(card, n, dtype):
    from apex_tpu_torch.ops import multi_tensor as MT
    g = torch.Generator(device=card).manual_seed(n)
    x = (torch.randn(n, generator=g, device=card) * 3).to(dtype)
    before = MT.l2norm.launches
    got = MT.l2norm(x)
    assert MT.l2norm.launches == before + 1
    want = MT.l2norm_plain(x)
    assert got.dtype == torch.float32 and got.dim() == 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert torch.equal(MT.l2norm(x), got)          # no atomics: same bits
    if n > 1:                                       # an unaligned view
        torch.testing.assert_close(MT.l2norm(x[1:]), MT.l2norm_plain(x[1:]),
                                   rtol=1e-5, atol=0)
    assert float(MT.l2norm(x[:0])) == 0.0


@pytest.mark.parametrize("n", [4, 1000, 128 * 1037])
@pytest.mark.parametrize("gdt,pdt", DT_PAIRS[:3])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adagrad_kernel_is_bit_equal_to_plain(card, n, gdt, pdt, mode, wd):
    from apex_tpu_torch.ops import multi_tensor as MT
    g = torch.Generator(device=card).manual_seed(n)
    grad = torch.randn(n, generator=g, device=card).to(gdt)
    p = torch.randn(n, generator=g, device=card).to(pdt)
    h = (torch.rand(n, generator=g, device=card) * 0.01).to(pdt)
    sc = MT.adagrad_scalars(lr=1e-2, eps=1e-10, weight_decay=wd,
                            device=card)
    before = MT.adagrad.launches
    got = MT.adagrad(grad, p, h, sc, mode)
    assert MT.adagrad.launches == before + 1
    for a, b in zip(got, MT.adagrad_plain(grad, p, h, sc, mode)):
        assert a.dtype == pdt and torch.equal(a, b)


def test_accum_kernel_wrappers_refuse_what_the_kernels_do_not_take(card):
    from apex_tpu_torch.ops import multi_tensor as MT
    x = torch.zeros(256, device=card)
    with pytest.raises(ValueError, match="one length"):
        MT.axpby(1.0, x, 1.0, x[:128])
    with pytest.raises(TypeError, match="dtype"):
        MT.axpby(1.0, x.half(), 1.0, x)
    with pytest.raises(ValueError, match="device"):
        MT.axpby(torch.tensor(1.0), x, 1.0, x)
    with pytest.raises(ValueError, match="flat"):
        MT.l2norm(x.view(16, 16))
    with pytest.raises(TypeError, match="dtype"):
        MT.l2norm(x.double())
    sc3 = torch.zeros(3, device=card)
    with pytest.raises(ValueError, match="multiple of 4"):
        MT.adagrad(x[:6], x[:6], x[:6], sc3, 0)
    with pytest.raises(TypeError, match="one dtype"):
        MT.adagrad(x, x, x.bfloat16(), sc3, 0)
    with pytest.raises(ValueError, match=r"fp32 \[3\]"):
        MT.adagrad(x, x, x, torch.zeros(4, device=card), 0)
    with pytest.raises(ValueError, match="mode"):
        MT.adagrad(x, x, x, sc3, 2)


def test_auto_takes_the_kernel_at_the_translation_shape(card):
    """impl="auto" on the card: the translation encoder's [B·H, S, D] =
    [1024, 128, 64] bf16 self-attention takes the flash kernels (S 128 is
    the H100's crossover), the same output as impl="fast"; an fp32 input
    and a head dim of 32 go to the plain path, where "fast" raises."""
    from apex_tpu_torch.contrib.multihead_attn import (
        DEFAULT_FLASH_MIN_S, EncdecMultiheadAttn, SelfMultiheadAttn)
    from apex_tpu_torch.ops import flash_attn as FA
    assert DEFAULT_FLASH_MIN_S == 128
    g = torch.Generator().manual_seed(0)
    auto = SelfMultiheadAttn(512, 8, bias=True, impl="auto")
    fast = SelfMultiheadAttn(512, 8, bias=True, impl="fast")
    p = {k: v.to(card, torch.bfloat16) for k, v in auto.init(g).items()}
    x = torch.randn(128, 128, 512, generator=g).to(card, torch.bfloat16)
    q = torch.zeros(1024, 128, 64, device=card, dtype=torch.bfloat16)
    assert auto._flash_wins(q, q)
    kpm = torch.zeros(128, 128, dtype=torch.bool, device=card)
    kpm[:, 100:] = True                     # padded sources: kv_bias
    before = FA.flash_fwd.launches
    out, _ = auto.apply(p, x, key_padding_mask=kpm)
    assert FA.flash_fwd.launches == before + 1
    out_f, _ = fast.apply(p, x, key_padding_mask=kpm)
    assert torch.equal(out, out_f)
    cross = EncdecMultiheadAttn(512, 8, bias=True, impl="auto")
    pc = {k: v.to(card, torch.bfloat16) for k, v in cross.init(g).items()}
    tq = torch.randn(129, 128, 512, generator=g).to(card, torch.bfloat16)
    before = FA.flash_fwd.launches
    cross.apply(pc, tq, x, key_padding_mask=kpm)     # Sq 129 x Sk 128
    assert FA.flash_fwd.launches == before + 1
    # what the kernels do not take goes plain under "auto"
    p32 = {k: v.float() for k, v in p.items()}
    before = FA.flash_fwd.launches
    out32, _ = auto.apply(p32, x.float())
    assert FA.flash_fwd.launches == before and out32.dtype == torch.float32
    with pytest.raises(TypeError, match="bfloat16"):
        fast.apply(p32, x.float())
    narrow = SelfMultiheadAttn(512, 16, bias=True, impl="auto")
    before = FA.flash_fwd.launches
    narrow.apply(p, x)
    assert FA.flash_fwd.launches == before


def test_lm_accumulation_through_the_kernels_matches_plain(card):
    """Three steps of a small LM with two microbatches and a dynamic loss
    scale (train_ring's step): two axpby launches and one Adam a step,
    the same bits twice, the plain run's losses within 2e-2 and none of
    its kernels launched."""
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.ops import multi_tensor as MT
    from apex_tpu_torch.train import LMTrainer
    m = TransformerLM(vocab_size=512, max_seq_len=256, embed_dim=128,
                      num_heads=2, num_layers=2, attn_impl="fast",
                      head_chunk=256)
    params = m.init(0)
    toks = torch.randint(0, 512, (4, 257), generator=torch.Generator()
                         .manual_seed(1)).to(card)

    def run():
        tr = LMTrainer(m, params, lr=1e-3, microbatches=2,
                       loss_scale="dynamic")
        return torch.stack([tr.step(toks) for _ in range(3)]), tr

    before = (MT.axpby.launches, MT.adam.launches)
    losses, tr = run()
    assert (MT.axpby.launches - before[0], MT.adam.launches - before[1]) \
        == (6, 3)
    losses2, tr2 = run()
    assert torch.equal(losses, losses2)
    assert torch.equal(tr.opt.state[0].master, tr2.opt.state[0].master)
    with dispatch.backend("reference"):
        before = MT.axpby.launches
        losses0, _ = run()
        assert MT.axpby.launches == before
    assert bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]
    torch.testing.assert_close(losses, losses0, atol=2e-2, rtol=0)
    assert float(tr.handle.loss_scale(tr.amp_state)) == 65536.0


def test_fp16_optimizer_adagrad_through_the_kernels_matches_plain(card):
    """Three clipped FP16_Optimizer(FusedAdagrad) steps of a small LM:
    one l2norm, one adagrad and 1 + leaves scale launches a step, norms
    within 1e-5 of the plain run's on the same grads, and an overflow
    that skips the step and names its leaf."""
    from apex_tpu_torch import fp16_utils as F16
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.ops import multi_tensor as MT
    from apex_tpu_torch.optimizers import FusedAdagrad
    m = TransformerLM(vocab_size=512, max_seq_len=256, embed_dim=128,
                      num_heads=2, num_layers=2, attn_impl="fast",
                      head_chunk=256)
    opt = F16.FP16_Optimizer(FusedAdagrad(m.init(0), lr=1e-3,
                                          weight_decay=1e-2,
                                          model_dtype=torch.bfloat16),
                             dynamic_loss_scale=True)
    toks = torch.randint(0, 512, (2, 257), generator=torch.Generator()
                         .manual_seed(1)).to(card)
    n_leaves = opt.optimizer._tables[0].num_segments

    def grads_of():
        params = flat.tree_map(lambda t: t.detach().requires_grad_(True),
                               opt.params_tree())
        leaves, treedef = flat.tree_flatten(params)
        loss = m.loss(params, toks)
        g = torch.autograd.grad(opt.scale_loss(loss), leaves)
        return flat.tree_unflatten(treedef, g), loss

    fns = (MT.l2norm, MT.adagrad, MT.scale)
    losses = []
    for _ in range(3):
        grads, loss = grads_of()
        before = [f.launches for f in fns]
        clipped, norm = opt.clip_master_grads(0.5, grads)
        opt.step(clipped)
        assert [f.launches - b for f, b in zip(fns, before)] == \
            [1, 1, 1 + n_leaves]
        with dispatch.backend("reference"):
            _, norm0 = opt.clip_master_grads(0.5, grads)
        torch.testing.assert_close(norm, norm0, rtol=1e-5, atol=0)
        assert not opt.overflow
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    grads, _ = grads_of()
    grads["layer_1"]["mlp"]["w1"][3, 5] = float("inf")
    master = opt.optimizer.state[0].master.clone()
    opt.step(opt.clip_master_grads(0.5, grads)[0])
    assert opt.overflow and opt.loss_scale == 32768.0
    assert torch.equal(opt.optimizer.state[0].master, master)
    assert opt.last_culprits[0]["path"] == "layer_1/mlp/w1"
