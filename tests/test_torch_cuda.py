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
    q = torch.zeros(2, 2, 96, device=card)
    kv = torch.zeros(2, 2, 16, 96, device=card)
    lengths = torch.ones(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        DA.decode_attention(q, kv, kv, lengths)
    q = torch.zeros(2, 2, 128, device=card)
    kv = torch.zeros(2, 2, 16, 128, device=card)
    with pytest.raises(TypeError, match="int32"):
        DA.decode_attention(q, kv, kv, lengths.long())
    with pytest.raises(TypeError, match="dtypes"):
        DA.decode_attention(q, kv.half(), kv.half(), lengths)
    # a page of 4 and a row of 8193 are taken (the split decode follows
    # the table per key; the LayerNorm kernels have scalar forms)
    pool = torch.zeros(5, 2, 4, 128, device=card)
    table = torch.ones(2, 2, dtype=torch.int32, device=card)
    DA.paged_decode_attention(q, pool, pool, lengths, page_table=table)
    LN.ln_fwd(torch.zeros(2, 8193, device=card), None, None, 1e-5)
    with pytest.raises(ValueError, match="width 0"):
        LN.ln_fwd(torch.zeros(2, 0, device=card), None, None, 1e-5)
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


@pytest.mark.parametrize("c,offset", [(6, 0), (7, 0), (8, 1), (64, 2)])
def test_welford_kernels_take_any_width_and_alignment(card, c, offset):
    """C not a multiple of 4, or a base one or two elements into its
    storage, takes the scalar form the C side picks: the sums within 1e-5
    of their terms, dx and dz bit-equal to the plain versions, repeats
    bit-equal."""
    from apex_tpu_torch.ops import welford as WF
    rows = 1000
    views = []
    for t in _bn_case(card, rows, c, torch.bfloat16, seed=c)[:3]:
        buf = torch.empty(rows * c + offset, dtype=t.dtype, device=card)
        views.append(buf[offset:].view(rows, c).copy_(t))
    x, dy, out = views
    _, _, _, mean, invvar = _bn_case(card, rows, c, torch.bfloat16, seed=c)
    s, sq = WF.bn_moments(x)
    _sums_close(s, WF.bn_moments_plain(x)[0], x.float())
    assert torch.equal(WF.bn_moments(x)[1], sq)
    sd, sx = WF.bn_backward_fused_reduce(dy, x, mean, invvar, out)
    sd0, sx0 = WF.bn_backward_fused_reduce_plain(dy, x, mean, invvar, out)
    dyf = dy.float() * (out.float() > 0)
    _sums_close(sd, sd0, dyf)
    _sums_close(sx, sx0, dyf * (x.float() - mean) * invvar)
    args = (dy, x, mean, invvar, invvar * 1.5, sd0 / rows, sx0 / rows, out)
    dx, dz = WF.bn_backward_dx(*args, emit_dz=True)
    dx0, dz0 = WF.bn_backward_dx_plain(*args, emit_dz=True)
    assert torch.equal(dx, dx0) and torch.equal(dz, dz0)
    rd, rx = WF.bn_backward_reduce(dy, x)
    _sums_close(rd, WF.bn_backward_reduce_plain(dy, x)[0], dy.float())
    assert torch.equal(WF.bn_backward_reduce(dy, x)[1], rx)


def test_welford_wrappers_refuse_what_the_kernels_do_not_take(card):
    from apex_tpu_torch.ops import welford as WF
    with pytest.raises(ValueError, match="C=0"):
        WF.bn_moments(torch.zeros(16, 0, device=card))
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
    (2, 130, 100, 128, True, -50), (1, 1, 1, 64, False, 0),
    # the edges of the backward's tiles: blocks of 128 rows, staged tiles
    # of 64, rounds of 32 queries in dk/dv at head dim 128
    (2, 127, 127, 64, True, 0), (2, 128, 128, 128, True, 0),
    (2, 129, 129, 64, False, 0), (1, 255, 256, 128, False, 0),
    (1, 256, 255, 64, True, 0), (2, 129, 255, 128, True, 0),
    (3, 200, 129, 128, True, -30), (2, 127, 256, 128, True, -1)])
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
    _repeats(FA, (q, k, v, do, lse, delta), kw, (dq, dk, dv))


def _repeats(FA, args, kw, outs, return_ds=False):
    """dq (and dS), dk and dv of a second run, bit for bit the first's."""
    out = FA.flash_bwd_dq(*args, return_ds=return_ds, **kw)
    again = (*(out if return_ds else (out,)), *FA.flash_bwd_dkv(*args, **kw))
    assert len(again) == len(outs)
    for a, b in zip(again, outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sq,sk", [(129, 129), (200, 257)])
def test_flash_backward_reads_strided_views_at_d128(card, sq, sk):
    """The backward's TMA maps read the time-major split's [BH, S, 128]
    views (strides (D, B·H·D, 1)) in place: the same bits as from
    contiguous copies."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(sq)
    bh, d = 4, 128

    def view(s):
        x = torch.randn(s, bh, d, generator=g, device=card).to(
            torch.bfloat16)
        return x.transpose(0, 1)

    q, do, k, v = view(sq), view(sq), view(sk), view(sk)
    assert not q.is_contiguous() and FA._tma_readable(q) is q
    kw = dict(causal=True, scale=d ** -0.5, q_start=sk - sq)
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    o, lse = FA.flash_fwd(qc, kc, vc, **kw)
    delta = FA.flash_delta(o, doc)
    got = (FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
           *FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    want = (FA.flash_bwd_dq(qc, kc, vc, doc, lse, delta, **kw),
            *FA.flash_bwd_dkv(qc, kc, vc, doc, lse, delta, **kw))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        FA.flash_fwd(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="one dtype"):
        FA.flash_fwd(q, q.half(), q)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros(2, 16, 520, device=card, dtype=torch.bfloat16)
        FA.flash_fwd(x, x, x)
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, q, q, torch.zeros(1, 16, 15, device=card))
    with pytest.raises(ValueError, match="bias"):
        FA.flash_fwd(q, q, q, bias=torch.zeros(3, 16, 16, device=card))
    with pytest.raises(ValueError, match="dropout_rate"):
        FA.flash_fwd(q, q, q, dropout_rate=1.0)
    with pytest.raises(ValueError, match=r"\[1, Sq, Sk\]"):
        FA.flash_bwd_dbias(q, q, q, q, torch.zeros(2, 16, device=card),
                           torch.zeros(2, 16, device=card), causal=False,
                           scale=0.125, bias=torch.zeros(2, 16, 16,
                                                         device=card))
    with pytest.raises(ValueError, match="kv_bias"):
        FA.flash_fwd(q, q, q, kv_bias=torch.zeros(3, 16, device=card))
    with pytest.raises(ValueError, match="fp32"):
        FA.flash_bwd_dq(q, q, q, q, torch.zeros(2, 16, device=card),
                        torch.zeros(2, 15, device=card), causal=True,
                        scale=0.125)


def _forward_holds(FA, q, k, v, kw):
    """The forward against its plain version on the same card tensors: o
    under the flash rule, lse within 1e-3 where a row sees a key, exactly
    NEG_INF (and o = 0) where it sees none, and a second run bit for bit
    the first (a block owns its output rows)."""
    o, lse = FA.flash_fwd(q, k, v, **kw)
    with dispatch.backend("reference"):
        o0, lse0 = FA.flash_fwd(q, k, v, **kw)
    assert o.shape == o0.shape and lse.shape == lse0.shape
    _flash_close(o, o0)
    live = lse0 > FA.NEG_INF * 0.5
    assert float(torch.where(live, (lse - lse0).abs(), 0.0).max()) <= 1e-3
    assert torch.equal(lse[~live], lse0[~live]) and not o[~live].any()
    o2, lse2 = FA.flash_fwd(q, k, v, **kw)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    return o, lse


# the forward's tile edges: blocks of 128 query rows (two warpgroups of
# 64), staged key tiles of 128 keys (64 at D 256), the ragged tails; Sq !=
# Sk
FWD_EDGES = [(1, 63), (63, 64), (64, 65), (65, 127), (127, 128),
             (128, 129), (129, 197), (197, 4095), (4095, 1), (4095, 197)]


@pytest.mark.parametrize("sq,sk", FWD_EDGES)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mask", ["none", "causal", "causal_offset"])
def test_flash_forward_at_the_tile_edges(card, sq, sk, d, mask):
    """The Hopper forward at every edge of its tiles, causal and not; with
    offsets that leave the first rows seeing nothing and the diagonal
    crossing tiles off their corners."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(7 * sq + sk + d)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=card).to(torch.bfloat16)

    q, k, v = rnd(3, sq, d), rnd(3, sk, d), rnd(3, sk, d)
    kw = dict(causal=mask != "none", scale=d ** -0.5)
    if mask == "causal_offset":
        kw.update(q_start=sk - sq + 5, k_start=3)
    _forward_holds(FA, q, k, v, kw)


@pytest.mark.parametrize("sq,sk", [(63, 129), (129, 197), (197, 197),
                                   (128, 255)])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("form", ["kv_bias", "shared", "per_bh", "dropout"])
def test_flash_forward_extra_forms_at_the_tile_edges(card, sq, sk, d, form):
    """Each input of the EXTRA form alone at the tile edges: the per-key
    kv_bias (a fifth of the keys masked), the full bias shared over bh or
    one per bh (every seventh key masked), dropout 0.1, causal with an
    offset."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(3 * sq + sk + d)
    bh = 4

    def rnd(*s):
        return torch.randn(*s, generator=g, device=card).to(torch.bfloat16)

    q, k, v = rnd(bh, sq, d), rnd(bh, sk, d), rnd(bh, sk, d)
    kw = dict(causal=True, scale=d ** -0.5, q_start=sk - sq, k_start=0)
    if form == "kv_bias":
        kw["kv_bias"] = torch.where(
            torch.rand(bh, sk, generator=g, device=card) < 0.2, FA.NEG_INF,
            0.0)
    elif form == "dropout":
        kw.update(dropout_rate=0.1, dropout_seed=12345)
    else:
        kw["bias"] = torch.randn(1 if form == "shared" else bh, sq, sk,
                                 generator=g, device=card)
        kw["bias"][..., ::7] = FA.NEG_INF
    _forward_holds(FA, q, k, v, kw)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_forward_reads_strided_and_broadcast_views(card, d):
    """The forward's TMA maps read the time-major split's [BH, S, D] views
    (strides (D, B·H·D, 1)) in place, and copy k and v broadcast over bh:
    the same bits as from contiguous tensors."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(d)
    t, bh = 200, 4

    def view(s):
        return torch.randn(s, bh, d, generator=g, device=card).to(
            torch.bfloat16).transpose(0, 1)

    q, k, v = view(t), view(t + 57), view(t + 57)
    assert not q.is_contiguous() and FA._tma_readable(q) is q
    kw = dict(causal=True, scale=d ** -0.5, q_start=57)
    got = FA.flash_fwd(q, k, v, **kw)
    want = FA.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    kb, vb = k[:1].expand(bh, -1, -1), v[:1].expand(bh, -1, -1)
    got = FA.flash_fwd(q, kb, vb, **kw)
    want = FA.flash_fwd(q, kb.contiguous(), vb.contiguous(), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _forward_holds(FA, q, kb, vb, kw)


@pytest.mark.parametrize("n", [128, 256])
def test_flash_dropout_mask_reads_back_over_a_whole_key_tile(card, n):
    """The exact read-back of the dropout mask (as below) at head dim n
    over n keys, v = I: at 128 one whole staged key tile of the forward,
    at 256 four of the D-256 forward's."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, rate, seed = 3, 0.1, 0x1234567
    eye = torch.eye(n, device=card, dtype=torch.bfloat16)
    q = torch.zeros(bh, n, n, device=card, dtype=torch.bfloat16)
    v = eye.expand(bh, n, n).contiguous()
    kw = dict(causal=False, scale=0.125, q_start=300, k_start=5,
              dropout_rate=rate, dropout_seed=seed)
    o, _ = FA.flash_fwd(q, q, v, **kw)
    pos = torch.arange(n, device=card)
    keep = FA.dropout_bits(seed, torch.arange(bh, device=card)[:, None, None],
                           300 + pos[None, :, None],
                           5 + pos[None, None, :]) >= FA.drop_threshold(rate)
    assert torch.equal(o != 0, keep)
    assert 0.8 < float(keep.float().mean()) < 1.0


# (bh, sq, sk, d, causal, q_start, k_start, bias: None, "shared" or
# "per_bh", kv_bias, dropout rate): the ViT's ragged 197, Sq != Sk, offsets
# that leave rows with nothing to see, every input at once
EXTRA_CASES = [
    (6, 197, 197, 64, False, 0, 0, None, False, 0.1),
    (6, 197, 197, 64, False, 0, 0, "shared", False, 0.0),
    (6, 197, 197, 64, False, 0, 0, "per_bh", False, 0.1),
    (3, 130, 100, 128, True, -50, 0, "shared", True, 0.1),
    (4, 257, 300, 64, True, 40, 3, "per_bh", True, 0.25),
    (2, 64, 64, 64, True, 0, 0, "shared", False, 0.0),
    # the backward's tile edges (128-row blocks, 64-row tiles, 32-query
    # rounds at head dim 128) in every form
    (2, 127, 129, 64, True, 0, 0, "per_bh", True, 0.1),
    (2, 256, 255, 128, False, 0, 0, "shared", True, 0.2),
    (2, 129, 128, 128, True, -20, 0, None, True, 0.1),
    (2, 255, 256, 64, True, 0, 1, "per_bh", False, 0.0),
    (1, 128, 200, 128, True, 72, 0, "per_bh", True, 0.1),
]


@pytest.mark.parametrize("bh,sq,sk,d,causal,q_start,k_start,bias,kvb,rate",
                         EXTRA_CASES)
def test_flash_bias_and_dropout_kernels_match_plain(card, bh, sq, sk, d,
                                                     causal, q_start,
                                                     k_start, bias, kvb,
                                                     rate):
    """The full bias, kv_bias and dropout in the forward, dq (with the
    per-bh dS), dk/dv and the shared-bias gradient kernel, against their
    plain versions on the same card tensors (the flash rule; dS and dbias
    under the same rule over their rows of keys); dbias twice, bit for
    bit."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(sq + sk + bh)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=card).to(torch.bfloat16)

    q, do = rnd(bh, sq, d), rnd(bh, sq, d)
    k, v = rnd(bh, sk, d), rnd(bh, sk, d)
    dlse = torch.randn(bh, sq, generator=g, device=card)
    kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start,
              k_start=k_start, dropout_rate=rate, dropout_seed=-7)
    if bias is not None:
        rows = 1 if bias == "shared" else bh
        kw["bias"] = torch.randn(rows, sq, sk, generator=g, device=card)
        kw["bias"][0, :, ::7] = FA.NEG_INF          # masked keys
    if kvb:
        kw["kv_bias"] = torch.where(
            torch.rand(bh, sk, generator=g, device=card) < 0.2, FA.NEG_INF,
            0.0)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    with dispatch.backend("reference"):
        o0, lse0 = FA.flash_fwd(q, k, v, **kw)
    _flash_close(o, o0)
    live = lse0 > FA.NEG_INF * 0.5
    assert float(torch.where(live, (lse - lse0).abs(), 0.0).max()) <= 1e-3
    assert torch.equal(lse[~live], lse0[~live]) and not o[~live].any()
    delta = FA.flash_delta(o, do, dlse)
    per_bh = bias == "per_bh"
    out = FA.flash_bwd_dq(q, k, v, do, lse, delta, return_ds=per_bh, **kw)
    dq, ds = out if per_bh else (out, None)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq0, dk0, dv0, ds0 = FA.flash_bwd_plain(q, k, v, do, lse, delta,
                                            return_ds=True, **kw)
    for a, b in ((dq, dq0), (dk, dk0), (dv, dv0)):
        _flash_close(a, b)
    if per_bh:
        _flash_close(ds, ds0)
    _repeats(FA, (q, k, v, do, lse, delta), kw,
             (dq, ds, dk, dv) if per_bh else (dq, dk, dv), per_bh)
    if bias == "shared":
        db = FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw)
        assert db.shape == (1, sq, sk) and db.dtype == torch.float32
        _flash_close(db, ds0.sum(0, keepdim=True))
        assert torch.equal(FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw),
                           db)                    # no float atomics


def test_flash_dropout_mask_reads_back_exactly(card):
    """q = 0 makes every probability 1/64 over Sk = 64 keys, and v = I
    puts p[i, j]·keep/(1 − rate) at o[i, j]: o[i, j] != 0 exactly where
    the mask keeps (i, j). dO = I does the same for dv[j, i]. Both equal
    ``dropout_bits`` >= the threshold at a nonzero bh, q_start and
    k_start."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, n, rate, seed = 5, 64, 0.1, 0xDEADBEEF
    eye = torch.eye(n, device=card, dtype=torch.bfloat16)
    q = torch.zeros(bh, n, n, device=card, dtype=torch.bfloat16)
    v = eye.expand(bh, n, n).contiguous()
    kw = dict(causal=False, scale=0.125, q_start=1000, k_start=77,
              dropout_rate=rate, dropout_seed=seed)
    o, lse = FA.flash_fwd(q, q, v, **kw)
    pos = torch.arange(n, device=card)
    keep = FA.dropout_bits(seed, torch.arange(bh, device=card)[:, None, None],
                           1000 + pos[None, :, None],
                           77 + pos[None, None, :]) >= FA.drop_threshold(rate)
    assert torch.equal(o != 0, keep)
    assert 0.8 < float(keep.float().mean()) < 1.0
    delta = FA.flash_delta(o, v)
    _, dv = FA.flash_bwd_dkv(q, q, v, v, lse, delta, **kw)
    assert torch.equal(dv != 0, keep.transpose(1, 2))


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
    the 3xTF32 kernels (their crossover is S 128 too) and a head dim of
    32 the tensor-core kernels (padded to 64); a float64 input goes to the
    plain path, where "fast" raises."""
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
    # fp32 at these lengths: the 3xTF32 forward, not the simple form
    p32 = {k: v.float() for k, v in p.items()}
    before = (FA.flash_fwd.launches, FA.flash_simt_fwd.launches,
              FA.flash_f32_fwd.launches)
    out32, _ = auto.apply(p32, x.float())
    assert out32.dtype == torch.float32
    assert (FA.flash_fwd.launches, FA.flash_simt_fwd.launches,
            FA.flash_f32_fwd.launches) == (before[0], before[1],
                                           before[2] + 1)
    # a head dim of 32 takes the tensor-core kernels, padded to 64
    narrow = SelfMultiheadAttn(512, 16, bias=True, impl="auto")
    before = FA.flash_fwd.launches
    narrow.apply(p, x)
    assert FA.flash_fwd.launches == before + 1
    # what no kernel takes goes plain under "auto"; "fast" raises
    p64 = {k: v.double() for k, v in p.items()}
    before = (FA.flash_fwd.launches, FA.flash_simt_fwd.launches)
    auto.apply(p64, x.double())
    assert (FA.flash_fwd.launches, FA.flash_simt_fwd.launches) == before
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fast.apply(p64, x.double())


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


# -- the fp32 forward on the tensor cores in 3xTF32 (flash_f32.cu) -----------

def _f32_forward_holds(FA, q, k, v, kw):
    """The fp32 forward on the tensor cores against its plain version on
    the same card tensors: o under the fp32 flash rule, lse within 1e-4
    where a row sees a key and exactly NEG_INF (o = 0) where it sees none,
    one launch of ``flash_f32_fwd`` and none of the simple form's, and a
    second run bit for bit the first."""
    before = (FA.flash_f32_fwd.launches, FA.flash_simt_fwd.launches)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    assert (FA.flash_f32_fwd.launches, FA.flash_simt_fwd.launches) == (
        before[0] + 1, before[1])
    with dispatch.backend("reference"):
        o0, lse0 = FA.flash_fwd(q, k, v, **kw)
    assert o.dtype == torch.float32 and o.shape == o0.shape
    _flash_rule(o, o0, torch.float32)
    live = lse0 > FA.NEG_INF * 0.5
    assert float(torch.where(live, (lse - lse0).abs(), 0.0).max()) <= 1e-4
    assert torch.equal(lse[~live], lse0[~live]) and not o[~live].any()
    o2, lse2 = FA.flash_fwd(q, k, v, **kw)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    return o, lse


# (sq, sk, d, causal, q_start, k_start): the blocks' 128 query rows (64 at
# D 128), the warps' 16, the staged tiles' 64 keys (32 at D 128) and their
# edges, Sq != Sk, causal offsets, rows that see no key, D padded from 1,
# 32, 65 and 96
F32_FWD_EDGES = [(1, 1, 64, False, 0, 0), (1, 15, 1, True, 14, 0),
                 (15, 16, 64, True, 0, 0), (16, 17, 32, False, 0, 0),
                 (17, 31, 128, True, 14, 0), (31, 32, 64, True, 1, 0),
                 (32, 33, 96, False, 0, 0), (33, 63, 128, True, 30, 0),
                 (63, 64, 64, True, 1, 0), (64, 65, 65, True, 1, 0),
                 (65, 127, 128, True, 62, 0), (127, 128, 64, False, 0, 0),
                 (128, 129, 128, True, 1, 0), (129, 33, 64, True, 0, 40),
                 (200, 77, 128, True, 5, 130), (300, 250, 64, True, -40, 0),
                 (4095, 1000, 64, True, 3095, 0),
                 (1000, 4095, 96, False, 0, 0),
                 (4095, 4095, 64, True, 0, 0),
                 (4095, 4095, 128, True, 0, 0),
                 # D 129-256 (padded to 256): 8-key tiles, 64 rows a block
                 (1, 7, 256, True, 6, 0), (15, 9, 129, False, 0, 0),
                 (63, 17, 256, True, 0, 0), (65, 8, 200, True, 1, 0),
                 (129, 33, 256, True, 0, 40), (200, 77, 256, True, 5, 130),
                 (300, 250, 192, True, -40, 0),
                 (1000, 1023, 256, False, 0, 0),
                 (1024, 1024, 256, True, 0, 0)]


@pytest.mark.parametrize("sq,sk,d,causal,q_start,k_start", F32_FWD_EDGES)
def test_f32_forward_at_the_tile_edges(card, sq, sk, d, causal, q_start,
                                       k_start):
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(5 * sq + sk + d)
    q = torch.randn(3, sq, d, generator=g, device=card)
    k, v = (torch.randn(3, sk, d, generator=g, device=card)
            for _ in range(2))
    kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start,
              k_start=k_start)
    o, lse = _f32_forward_holds(FA, q, k, v, kw)
    if causal and k_start > q_start:       # rows that see no key
        assert bool((lse[:, :k_start - q_start] == FA.NEG_INF).all())


@pytest.mark.parametrize("form", ["kv_bias", "shared", "per_bh", "dropout",
                                  "all"])
@pytest.mark.parametrize("sq,sk,d", [(63, 129, 64), (197, 197, 64),
                                     (129, 200, 128), (129, 200, 256),
                                     (70, 61, 160)])
def test_f32_forward_with_biases_and_dropout(card, sq, sk, d, form):
    """The EXTRA form: a kv_bias (a fifth of the keys masked), a full bias
    shared over bh or one per bh (every seventh key masked), dropout 0.1,
    and all of them at once, causal with an offset."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(3 * sq + sk + d)
    bh = 4
    q = torch.randn(bh, sq, d, generator=g, device=card)
    k, v = (torch.randn(bh, sk, d, generator=g, device=card)
            for _ in range(2))
    kw = dict(causal=True, scale=d ** -0.5, q_start=sk - sq, k_start=0)
    if form in ("kv_bias", "all"):
        kw["kv_bias"] = torch.where(
            torch.rand(bh, sk, generator=g, device=card) < 0.2, FA.NEG_INF,
            0.0)
    if form in ("dropout", "all"):
        kw.update(dropout_rate=0.1, dropout_seed=-99)
    if form in ("shared", "per_bh", "all"):
        kw["bias"] = torch.randn(1 if form == "shared" else bh, sq, sk,
                                 generator=g, device=card)
        kw["bias"][..., ::7] = FA.NEG_INF
    _f32_forward_holds(FA, q, k, v, kw)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_f32_forward_dropout_mask_reads_back_exactly(card, d):
    """q = k = 0 makes every probability 1/64 over 64 keys (a whole staged
    tile at D 64, two at D 128, eight at D 256), v = I puts p·keep/(1 −
    rate) at o[i, j]: o[i, j] != 0 exactly where ``dropout_bits`` keeps
    (i, j), at a nonzero bh, q_start and k_start."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, n, rate, seed = 3, 64, 0.1, 0x2468ACE
    q = torch.zeros(bh, n, d, device=card)
    v = torch.eye(n, d, device=card).expand(bh, n, d).contiguous()
    kw = dict(causal=False, scale=0.125, q_start=700, k_start=9,
              dropout_rate=rate, dropout_seed=seed)
    before = FA.flash_f32_fwd.launches
    o, _ = FA.flash_fwd(q, q, v, **kw)
    assert FA.flash_f32_fwd.launches == before + 1
    pos = torch.arange(n, device=card)
    keep = FA.dropout_bits(seed, torch.arange(bh, device=card)[:, None, None],
                           700 + pos[None, :, None],
                           9 + pos[None, None, :]) >= FA.drop_threshold(rate)
    assert torch.equal(o[..., :n] != 0, keep) and not o[..., n:].any()
    assert 0.8 < float(keep.float().mean()) < 1.0


def test_f32_forward_reads_strided_and_broadcast_views(card):
    """q as heads split from a packed [BH, S, 3, D] buffer (a row stride of
    3·D), k and v broadcast over bh (stride 0), read in place; v at an odd
    element offset (copied once): the same bits as from contiguous
    copies."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(9)
    bh, s, d = 6, 150, 64
    q = torch.randn(bh, s, 3, d, generator=g, device=card)[:, :, 0]
    k = torch.randn(1, s, d, generator=g, device=card).expand(bh, s, d)
    v = torch.randn(bh * s * d + 1, generator=g, device=card)[1:].view(
        bh, s, d)
    assert FA._readable(q) is q and FA._readable(k) is k
    assert FA._readable(v) is not v
    kw = dict(causal=True, scale=d ** -0.5, q_start=20)
    got = _f32_forward_holds(FA, q, k, v, kw)
    want = FA.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_f32_forward_at_d256_at_more_than_65535_heads(card):
    """BH = 65536 + 7 at D 256, S 16, fp32: the heads around and past 65535
    give the same bits as a launch of their own and hold against the
    plain version."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(8)
    bh, s, d = 65536 + 7, 16, 256
    q, k, v = (torch.randn(bh, s, d, generator=g, device=card)
               for _ in range(3))
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    tail = slice(65536 - 9, bh)
    ot, lset = _f32_forward_holds(FA, q[tail], k[tail], v[tail], kw)
    assert torch.equal(o[tail], ot) and torch.equal(lse[tail], lset)


# -- the wide LayerNorm (F > 8192) and bn_backward_reduce ---------------------

@pytest.mark.parametrize("rows,f", [(1, 8196), (13, 9344), (13, 16384),
                                    (37, 12288), (520, 9344), (4, 200704),
                                    (5, 16388)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_wide_kernels_match_plain_and_repeat(card, rows, f, dtype):
    # the one-pass forward to 16384, the chunked one above
    g = torch.Generator(device=card).manual_seed(rows + f)
    x = (torch.randn(rows, f, generator=g, device=card) * 3 + 1).to(dtype)
    dy = torch.randn(rows, f, generator=g, device=card).to(dtype)
    w = (torch.randn(f, generator=g, device=card) + 1).to(dtype)
    b = torch.randn(f, generator=g, device=card).to(dtype)
    fns = (LN.ln_fwd, LN.ln_bwd, LN.ln_fwd_wide, LN.ln_bwd_wide)
    for weight, bias in ((w, b), (None, None)):
        before = [fn.launches for fn in fns]
        y, mean, inv = LN.ln_fwd(x, weight, bias, 1e-5)
        got = LN.ln_bwd(dy, x, weight, mean, inv)
        assert [fn.launches - n for fn, n in zip(fns, before)] == \
            [0, 0, 1, 1]
        y0, mean0, inv0 = LN.ln_fwd_plain(x, weight, bias, 1e-5)
        _close(y, y0, dtype)
        _close(mean, mean0, torch.float32)
        _close(inv, inv0, torch.float32)
        want = LN.ln_bwd_plain(dy, x, weight, mean, inv)
        _close(got[0], want[0], dtype)
        if weight is not None:
            xhat = (x.float() - mean[:, None]) * inv[:, None]
            _sums_close(got[1], want[1], dy.float() * xhat)
            _sums_close(got[2], want[2], dy.float())
        else:
            assert got[1] is None and got[2] is None
        # no float atomics: both passes repeat bit for bit
        again = LN.ln_fwd(x, weight, bias, 1e-5)
        assert all(torch.equal(a, c) for a, c in zip((y, mean, inv), again))
        again = LN.ln_bwd(dy, x, weight, mean, inv)
        assert all(torch.equal(a, c) for a, c in zip(got, again)
                   if a is not None)


@pytest.mark.parametrize("f", [9344, 12288, 16384, 200704])
def test_ln_wide_forward_holds_a_large_mean(card, f):
    """x = 1000 + 0.01·N(0, 1): the naive E[x²] − E[x]² cancels in fp32;
    within 0.05 of an fp64 reference, the JAX package's own bar, in the
    one-pass form (F <= 16384) and the chunked one."""
    g = torch.Generator(device=card).manual_seed(7)
    x = 1000.0 + 0.01 * torch.randn(9, f, generator=g, device=card)
    y, mean, inv = LN.ln_fwd(x, None, None, 1e-5)
    xd = x.double()
    ref = (xd - xd.mean(1, keepdim=True)) * torch.rsqrt(
        xd.var(1, unbiased=False, keepdim=True) + 1e-5)
    assert bool(torch.isfinite(y).all())
    assert float((y.double() - ref).abs().max()) <= 0.05


def test_ln_wide_wrappers_refuse_what_the_kernels_do_not_take(card):
    # a width not a multiple of 4 and a misaligned base take the scalar
    # forms; what is refused is a strided view and a lone weight
    x = torch.randn(2, 8194, device=card)
    y, mean, inv = LN.ln_fwd(x, None, None, 1e-5)
    _close(y, LN.ln_fwd_plain(x, None, None, 1e-5)[0], torch.float32)
    dx, _, _ = LN.ln_bwd(x, x, None, mean, inv)
    _close(dx, LN.ln_bwd_plain(x, x, None, mean, inv)[0], torch.float32)
    buf = torch.randn(2 * 9216 + 1, device=card)
    xm = buf[1:].view(2, 9216)
    _close(LN.ln_fwd(xm, None, None, 1e-5)[0],
           LN.ln_fwd_plain(xm, None, None, 1e-5)[0], torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        LN.ln_fwd(torch.zeros(9216, 2, device=card).t(), None, None, 1e-5)
    w = torch.ones(9216, device=card)
    with pytest.raises(ValueError, match="weight and bias together"):
        LN.ln_fwd(torch.zeros(2, 9216, device=card), w, None, 1e-5)


@pytest.mark.parametrize("f", [12290, 8194, 12289])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_bwd_wide_at_even_and_odd_widths(card, f, dtype):
    """The wide backward's 2-wide form (F 12290 and 8194, even, every
    buffer 2-element aligned) and its scalar form (odd F 12289, and an even
    F from a base one element off): chip_smoke.py's LN rule (dx within one
    ulp of the dtype plus 1e-5 of its terms, fp32 with the row means at
    their own rounding scale; dγ and dβ within 1e-5 of their columns'
    Σ|terms|) against the plain version, and two runs bit for bit."""
    g = torch.Generator(device=card).manual_seed(f)
    rows = 64
    x = (torch.randn(rows, f, generator=g, device=card) * 2 + 0.5).to(dtype)
    dy = torch.randn(rows, f, generator=g, device=card).to(dtype)
    w = (torch.randn(f, generator=g, device=card) + 1).to(dtype)
    _, mean, inv = LN.ln_fwd(x, w, torch.zeros_like(w), 1e-5)
    got = LN.ln_bwd_wide(dy, x, w, mean, inv)
    want = LN.ln_bwd_plain(dy, x, w, mean, inv)
    xhat = (x.float() - mean[:, None]) * inv[:, None]
    dxh = dy.float() * w.float()
    if dtype == torch.float32:             # the row means' own rounding
        m1 = dxh.abs().mean(1, keepdim=True)
        m2 = (dxh * xhat).abs().mean(1, keepdim=True)
    else:
        m1 = dxh.mean(1, keepdim=True)
        m2 = (dxh * xhat).mean(1, keepdim=True)
    terms = inv[:, None] * (dxh.abs() + m1.abs() + (xhat * m2).abs())
    bits = 8 if dtype == torch.bfloat16 else 24
    want_dx = want[0].float()

    def ulp(t):
        return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - bits)

    def dx_ok(a):
        lim = torch.maximum(ulp(a.float()), ulp(want_dx)) + 1e-5 * terms
        return bool(((a.float() - want_dx).abs() <= lim).all())
    assert dx_ok(got[0])
    for a, b, t in ((got[1], want[1], dy.float() * xhat),
                    (got[2], want[2], dy.float())):
        assert bool(((a - b).abs() <= 1e-5 * t.abs().sum(0) + 1e-6).all())
    again = LN.ln_bwd_wide(dy, x, w, mean, inv)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    if f % 2 == 0:                         # the scalar form beside it
        buf = torch.empty(2 * rows * f + 1, device=card, dtype=dtype)
        dy1 = buf[1:rows * f + 1].view(rows, f)
        x1 = buf[rows * f + 1:].view(rows, f)
        dy1.copy_(dy)
        x1.copy_(x)
        scalar = LN.ln_bwd_wide(dy1, x1, w, mean, inv)
        assert dx_ok(scalar[0])


def test_lm_at_a_wide_row_takes_the_wide_kernels(card):
    """A one-layer LM of width 8320 (65 heads of 128): its three
    LayerNorms, forward and backward, launch the wide kernels and never
    the one-pass ones, and the loss matches the plain versions'."""
    from apex_tpu_torch.models import TransformerLM
    m = TransformerLM(vocab_size=512, max_seq_len=128, embed_dim=8320,
                      num_heads=65, num_layers=1, attn_impl="fast",
                      head_chunk=512)
    params = m.init(0, dtype=torch.bfloat16)
    leaves = [params["ln_f"]["g"], params["layer_0"]["ln1"]["g"]]
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.randint(0, 512, (2, 129), generator=torch.Generator()
                         .manual_seed(1)).to(card)
    fns = (LN.ln_fwd, LN.ln_bwd, LN.ln_fwd_wide, LN.ln_bwd_wide)
    before = [fn.launches for fn in fns]
    loss = m.loss(params, toks)
    grads = torch.autograd.grad(loss, leaves)
    assert [fn.launches - n for fn, n in zip(fns, before)] == [0, 0, 3, 3]
    with dispatch.backend("reference"):
        loss0 = m.loss(params, toks)
        grads0 = torch.autograd.grad(loss0, leaves)
    assert [fn.launches - n for fn, n in zip(fns, before)] == [0, 0, 3, 3]
    torch.testing.assert_close(loss.float(), loss0.float(), atol=2e-2,
                               rtol=0)
    for a, b0 in zip(grads, grads0):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.float(), b0.float(), atol=5e-2,
                                   rtol=5e-2)


@pytest.mark.parametrize("rows,c", [(1, 4), (1000, 256), (4099, 200),
                                    (300, 2048)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16),
                                    (torch.float16, torch.float32)],
                         ids=["f32", "bf16", "f32_bf16", "f16_f32"])
def test_bn_backward_reduce_matches_plain_and_repeats(card, rows, c, dtypes):
    from apex_tpu_torch.ops import welford as WF
    g = torch.Generator(device=card).manual_seed(rows + c)
    dy = torch.randn(rows, c, generator=g, device=card).to(dtypes[0])
    xhat = torch.randn(rows, c, generator=g, device=card).to(dtypes[1])
    before = WF.bn_backward_reduce.launches
    sd, sx = WF.bn_backward_reduce(dy, xhat)
    assert WF.bn_backward_reduce.launches == before + 1
    sd0, sx0 = WF.bn_backward_reduce_plain(dy, xhat)
    _sums_close(sd, sd0, dy.float())
    _sums_close(sx, sx0, dy.float() * xhat.float())
    again = WF.bn_backward_reduce(dy, xhat)
    assert torch.equal(again[0], sd) and torch.equal(again[1], sx)
    # one channel fewer: the scalar form
    dy3, xh3 = (t[:, :c - 1 if c > 4 else 3].contiguous() for t in (dy, xhat))
    sd, sx = WF.bn_backward_reduce(dy3, xh3)
    sd0, sx0 = WF.bn_backward_reduce_plain(dy3, xh3)
    _sums_close(sd, sd0, dy3.float())
    _sums_close(sx, sx0, dy3.float() * xh3.float())



# -- Queue 3's refusals, repaired: decode at head dim 64, flash in fp16 and
# -- fp32 and at any head dim and BH, LayerNorm and welford at any width ----

def _flash_rule(got, want, dtype):
    """Each element within 2 ulps of dtype plus a share of its row's RMS,
    as chip_smoke.py's flash rule: 16-bit 2^-6 of the row's RMS (at least
    2^-6 of the tensor's), fp32 2^-14 of the larger of the row's and the
    tensor's."""
    bits = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}[dtype]
    frac, floor = (2.0 ** -14, 1.0) if dtype == torch.float32 \
        else (2.0 ** -6, 2.0 ** -6)
    a, b = got.float(), want.float()

    def ulp(t):
        return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - bits)
    rms = torch.clamp(b.pow(2).mean(-1, keepdim=True).sqrt(),
                      min=floor * float(b.pow(2).mean().sqrt()))
    lim = 2 * torch.maximum(ulp(a), ulp(b)) + frac * rms
    assert bool(((a - b).abs() <= lim).all()), float(((a - b).abs()
                                                       / lim).max())


def _flash_kernels_against_plain(q, k, v, do, dtype, **kw):
    """The forward against ``reference_attention`` and dq, dk, dv against
    ``flash_bwd_plain`` on the same inputs (the kernel forward's lse and
    its o's delta), each under ``_flash_rule``; lse within 1e-3."""
    from apex_tpu_torch.ops import flash_attn as FA
    o, lse = FA.flash_fwd(q, k, v, **kw)
    bias = kw.pop("bias", None)
    o0, lse0 = FA.reference_attention(q, k, v, bias, return_lse=True, **kw)
    _flash_rule(o, o0, dtype)
    torch.testing.assert_close(lse, lse0, atol=1e-3, rtol=0)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, bias=bias, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, bias=bias, **kw)
    want = FA.flash_bwd_plain(q, k, v, do, lse, delta, bias=bias, **kw)
    for a, b0 in zip((dq, dk, dv), want):
        assert a.dtype == dtype and a.shape == b0.shape
        _flash_rule(a, b0, dtype)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("cap", [1000, 2100])
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_split_edges_repeat_and_paged_equal(card, hd, cap):
    """The split kernel at no key, one, a chunk's edges and the arena's
    length (up to 16 chunks, whose partials the merge loads at once, and
    past them): against the plain version, two runs bit for bit, and a
    paged arena of page 5 equal to the dense one bit for bit."""
    g = torch.Generator(device=card).manual_seed(hd)
    lens = [0, 1, 63, 64, 65, 127, 129, cap]
    s, h = len(lens), 16 if hd == 64 else 8
    lengths = torch.tensor(lens, dtype=torch.int32, device=card)
    q = torch.randn(s, h, hd, generator=g, device=card).bfloat16()
    k = torch.randn(s, h, cap, hd, generator=g, device=card).bfloat16()
    v = torch.randn(s, h, cap, hd, generator=g, device=card).bfloat16()
    before = (DA.decode_attention.launches, DA.decode_merge.launches)
    got = DA.decode_attention(q, k, v, lengths)
    assert (DA.decode_attention.launches, DA.decode_merge.launches) == (
        before[0] + 1, before[1] + 1)
    _close(got, DA.decode_attention_plain(q, k, v, lengths), torch.bfloat16)
    assert not got[0].any()
    assert torch.equal(DA.decode_attention(q, k, v, lengths), got)
    page, n_pages = 5, cap // 5
    table = (torch.randperm(s * n_pages, generator=g, device=card)
             .to(torch.int32) + 1).reshape(s, n_pages)
    kp = torch.full((1 + s * n_pages, h, page, hd), 9.0, device=card,
                    dtype=torch.bfloat16)
    vp = kp.clone()
    for t, c in ((kp, k), (vp, v)):
        t[table.reshape(-1).long()] = (c.reshape(s, h, n_pages, page, hd)
                                       .transpose(1, 2)
                                       .reshape(-1, h, page, hd))
    assert torch.equal(DA.paged_decode_attention(q, kp, vp, lengths,
                                                 page_table=table), got)


def test_engine_at_head_dim_64_paged_equals_dense(card):
    """lm_bench's head dim on a small LM: every decode step by the split
    kernel and its merge (the arena holds 128 positions), paged streams
    equal to dense."""
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                      poisson_requests)
    m = TransformerLM(vocab_size=512, max_seq_len=128, embed_dim=256,
                      num_heads=4, num_layers=2)
    p = m.init(0, dtype=torch.bfloat16)
    reqs = poisson_requests(8, rate=0.0, prompt_dist="uniform:3,60",
                            new_dist="uniform:2,40", vocab_size=512,
                            seed=2, max_len=128, prefill_chunk=8)
    kw = dict(slots=3, max_len=128, prefill_chunk=8)
    fns = (DA.decode_attention, DA.paged_decode_attention, DA.decode_merge)
    before = [f.launches for f in fns]
    dense, ds = ContinuousBatchingEngine(m, p, **kw).run(reqs)
    mid = [f.launches for f in fns]
    paged, ps = ContinuousBatchingEngine(m, p, paged=True, page_size=8,
                                         kv_pages=24, **kw).run(reqs)
    after = [f.launches for f in fns]
    steps = m.num_layers * ds["decode_steps"]
    assert [a - b for a, b in zip(mid, before)] == [steps, 0, steps]
    steps = m.num_layers * ps["decode_steps"]
    assert [a - b for a, b in zip(after, mid)] == [0, steps, steps]
    assert [r.tokens for r in paged] == [r.tokens for r in dense]


@pytest.mark.parametrize("d", [32, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32],
                         ids=["f16", "f32"])
def test_flash_in_fp16_and_fp32_at_any_head_dim(card, dtype, d):
    """fp16 at D <= 128 by the tensor-core kernels (D padded to 64 or 128),
    fp32 there by the 3xTF32 kernels, fp16 at D 256 by the D-256 forward,
    dq and dk/dv, fp32 at D 256 by the 3xTF32 forward, dq and dk/dv, with
    a kv_bias and causal masking: each kernel
    against its plain version on the same inputs, and the public
    ``flash_attention`` (forward and backward) launching the forms the
    dtype and head dim choose, its outputs in the input dtype."""
    from apex_tpu_torch.contrib.multihead_attn import flash_attention
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(d)
    bh, s = 12, 200
    q, k, v, do = (torch.randn(bh, s, d, generator=g, device=card)
                   .to(dtype) for _ in range(4))
    kvb = torch.zeros(bh, s, device=card)
    kvb[:, -7:] = -1e30
    _flash_kernels_against_plain(q, k, v, do, dtype, kv_bias=kvb,
                                 causal=True, scale=d ** -0.5)
    fns = (FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv,
           FA.flash_simt_fwd, FA.flash_simt_dq, FA.flash_simt_dkv,
           FA.flash_f32_fwd, FA.flash_f32_dq, FA.flash_f32_dkv,
           FA.flash_d256_fwd, FA.flash_d256_dq, FA.flash_d256_dkv)
    before = [f.launches for f in fns]
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention(qs, ks, vs, kv_bias=kvb, causal=True)
    grads = torch.autograd.grad(o, (qs, ks, vs), do)
    assert [f.launches - n for f, n in zip(fns, before)] == {
        ("tc", "tc"): [1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        ("f32", "f32"): [0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0],
        ("tc256", "tc256"): [0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1]}[
            (FA.kernel_form(q, "fwd"), FA.kernel_form(q, "dkv"))]
    for t in (o, *grads):
        assert t.dtype == dtype and t.shape == (bh, s, d)
        assert bool(torch.isfinite(t).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_at_more_than_65535_heads(card, dtype):
    """BH = 65536 + 7, S 64: the grid folds bh into its one dim. The heads
    around and past 65535 give the same bits as a launch of their own,
    and they hold against the plain versions."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(3)
    bh, s, d = 65536 + 7, 64, 64
    q, k, v, do = (torch.randn(bh, s, d, generator=g, device=card)
                   .to(dtype) for _ in range(4))
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    tail = slice(65536 - 9, bh)
    args = (q[tail], k[tail], v[tail])
    ot, lset = FA.flash_fwd(*args, **kw)
    dqt = FA.flash_bwd_dq(*args, do[tail], lse[tail], delta[tail], **kw)
    dkt, dvt = FA.flash_bwd_dkv(*args, do[tail], lse[tail], delta[tail],
                                **kw)
    for a, b0 in zip((o, lse, dq, dk, dv), (ot, lset, dqt, dkt, dvt)):
        assert torch.equal(a[tail], b0)
    _flash_kernels_against_plain(*args, do[tail], dtype, **kw)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32],
                         ids=["f16", "f32"])
def test_flash_shared_bias_gradient_in_every_dtype(card, dtype):
    """A learned [1, Sq, Sk] bias at D 96: fp16 on wgmma, fp32 in 3xTF32
    (``csrc/flash_dbias.cu``, D unpadded); both against the plain per-bh
    dS summed under the dtype's flash rule, and two runs bit for bit.
    Either form counts one launch of ``flash_bwd_dbias`` and none of the
    dq wrappers."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(4)
    bh, s, d = 24, 197, 96
    q, k, v, do = (torch.randn(bh, s, d, generator=g, device=card)
                   .to(dtype) for _ in range(4))
    bias = torch.randn(1, s, s, generator=g, device=card)
    kw = dict(causal=False, scale=d ** -0.5, bias=bias)
    o, lse = FA.reference_attention(q, k, v, bias, return_lse=True,
                                    scale=d ** -0.5)
    delta = FA.flash_delta(o, do)
    fns = (FA.flash_bwd_dbias, FA.flash_bwd_dq, FA.flash_simt_dq)
    before = [f.launches for f in fns]
    got = FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw)
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 0, 0]
    want = FA.flash_bwd_dbias_plain(q, k, v, do, lse, delta, **kw)
    _flash_rule(got, want, dtype)
    assert torch.equal(FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw),
                       got)


def test_fused_layer_norm_1022_trains(card):
    """FusedLayerNorm(1022): the forward's and the backward's scalar
    forms against the plain versions (y within one bf16 ulp + 1e-5; dx
    and the column sums by the LN rule)."""
    from apex_tpu_torch.normalization import FusedLayerNorm
    g = torch.Generator(device=card).manual_seed(6)
    ln = FusedLayerNorm(1022, device=card)
    with torch.no_grad():
        ln.weight.copy_(torch.rand(1022, generator=g, device=card) + 0.5)
        ln.bias.copy_(torch.randn(1022, generator=g, device=card))
    x = (torch.randn(4, 300, 1022, generator=g, device=card) * 2 + 0.5
         ).bfloat16().requires_grad_(True)
    dy = torch.randn(4, 300, 1022, generator=g, device=card).bfloat16()

    def run():
        y = ln(x)
        return (y, *torch.autograd.grad(y, (x, ln.weight, ln.bias), dy))
    before = (LN.ln_fwd.launches, LN.ln_bwd.launches)
    y, dx, dw, db = run()
    assert (LN.ln_fwd.launches, LN.ln_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    with dispatch.backend("reference"):
        y0, dx0, dw0, db0 = run()
    _close(y, y0, torch.bfloat16)
    _close(dx, dx0, torch.bfloat16)
    for a, b0 in ((dw, dw0), (db, db0)):
        torch.testing.assert_close(a, b0, atol=2e-3, rtol=1e-4)
    again = run()
    assert all(torch.equal(a, b0) for a, b0 in zip(again, (y, dx, dw, db)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_sync_batchnorm_6_channels_trains(card, dtype):
    """SyncBatchNorm(6, axis_name=None) forward and backward by the welford
    kernels' scalar form, against the plain versions: out, dx, dz within
    the dtype's tolerance, dγ and dβ within 1e-5 of their sums' terms."""
    from apex_tpu_torch.ops import welford as WF
    from apex_tpu_torch.parallel import SyncBatchNorm
    g = torch.Generator(device=card).manual_seed(8)
    bn = SyncBatchNorm(6, axis_name=None, fuse_relu=True)
    params, state = bn.init(card)
    params = {k: (torch.rand(6, generator=g, device=card) + 0.5)
              .requires_grad_(True) for k in params}
    x = (torch.randn(8, 14, 14, 6, generator=g, device=card) * 2 + 0.5
         ).to(dtype).requires_grad_(True)
    z = torch.randn(8, 14, 14, 6, generator=g, device=card).to(dtype)
    z.requires_grad_(True)
    dy = torch.randn(8, 14, 14, 6, generator=g, device=card).to(dtype)

    def run():
        out, _ = bn(params, state, x, z=z)
        return (out, *torch.autograd.grad(
            out, (x, z, params["weight"], params["bias"]), dy))
    fns = (WF.bn_moments, WF.bn_backward_fused_reduce, WF.bn_backward_dx)
    before = [f.launches for f in fns]
    got = run()
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 1, 1]
    with dispatch.backend("reference"):
        want = run()
    for a, b0 in zip(got[:3], want[:3]):
        _close(a, b0, dtype)
    for a, b0 in zip(got[3:], want[3:]):
        torch.testing.assert_close(a, b0, atol=1e-2, rtol=1e-4)


# -- the fp32 backward on the tensor cores in 3xTF32 (flash_f32.cu) -----------

def _f32_case(card, bh, sq, sk, d, seed, **kw):
    """fp32 q, k, v, dO and the plain forward's lse and delta (with an lse
    cotangent folded in)."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(seed)
    q, do = (torch.randn(bh, sq, d, generator=g, device=card)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=g, device=card)
            for _ in range(2))
    o, lse = FA.reference_attention(q, k, v, kw.get("bias"),
                                    return_lse=True, **{
                                        n: x for n, x in kw.items()
                                        if n != "bias"})
    dlse = torch.randn(bh, sq, generator=g, device=card)
    return q, k, v, do, lse, FA.flash_delta(o, do, dlse)


def _f32_backward_holds(FA, args, kw, return_ds=False):
    """dq (and dS), dk, dv of the fp32 kernels against ``flash_bwd_plain``
    under the fp32 flash rule, one launch of each, and a second run bit
    for bit the first's."""
    before = (FA.flash_f32_dq.launches, FA.flash_f32_dkv.launches,
              FA.flash_simt_dq.launches, FA.flash_simt_dkv.launches)
    out = FA.flash_bwd_dq(*args, return_ds=return_ds, **kw)
    got = (*(out if return_ds else (out,)), *FA.flash_bwd_dkv(*args, **kw))
    assert (FA.flash_f32_dq.launches, FA.flash_f32_dkv.launches,
            FA.flash_simt_dq.launches, FA.flash_simt_dkv.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    want = FA.flash_bwd_plain(*args, return_ds=return_ds, **kw)
    want = (want[0], want[3], *want[1:3]) if return_ds else want
    names = ("dq", "ds", "dk", "dv") if return_ds else ("dq", "dk", "dv")
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        try:
            _flash_rule(a, b, torch.float32)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
    _repeats(FA, args, kw, got, return_ds)
    return got


# (sq, sk, d, causal, q_start, k_start): Sq and Sk over the blocks' 64 rows
# and the staged tiles' 64 (D <= 64) or 32 (D 128), Sq != Sk, causal
# offsets, rows that see no key (lse at NEG_INF), D padded from 1, 32, 65
# and 96
F32_EDGES = [(1, 1, 64, False, 0, 0), (1, 63, 1, True, 62, 0),
             (63, 64, 32, True, 0, 0), (64, 65, 64, False, 0, 0),
             (65, 127, 65, True, 64, 2), (127, 129, 96, True, 0, 0),
             (129, 33, 128, False, 0, 0), (200, 77, 128, True, 5, 130),
             (31, 97, 128, True, 70, 0), (300, 250, 64, True, -40, 0),
             (4095, 1000, 64, True, 3095, 0), (1000, 4095, 96, False, 0, 0),
             (4095, 4095, 128, True, 0, 0)]


@pytest.mark.parametrize("sq,sk,d,causal,q_start,k_start", F32_EDGES)
def test_f32_backward_kernels_at_the_tile_edges(card, sq, sk, d, causal,
                                                q_start, k_start):
    from apex_tpu_torch.ops import flash_attn as FA
    kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start,
              k_start=k_start)
    args = _f32_case(card, 3, sq, sk, d, sq + sk + d, **kw)
    dq = _f32_backward_holds(FA, args, kw)[0]
    if causal and k_start > q_start:       # rows that see no key
        assert not dq[:, :k_start - q_start].any()


# name -> (sq, sk, d, causal, q_start, kv_bias, bias rows, dropout rate)
F32_EXTRAS = {
    "kv_bias": (197, 200, 64, False, 0, True, None, 0.0),
    "bias_shared_ds": (197, 197, 96, False, 0, False, 1, 0.0),
    "bias_bh_ds_causal": (130, 140, 64, True, 10, False, "bh", 0.0),
    "dropout": (257, 257, 64, True, 0, False, None, 0.1),
    "all_d128": (129, 200, 128, True, 71, True, "bh", 0.2),
}


@pytest.mark.parametrize("name", list(F32_EXTRAS))
def test_f32_backward_kernels_with_biases_and_dropout(card, name):
    """The EXTRA forms: a kv_bias with masked keys, a full bias shared or
    per bh (dq's dS beside dq), dropout; each held as the plain forms."""
    from apex_tpu_torch.ops import flash_attn as FA
    sq, sk, d, causal, q_start, kvb, rows, rate = F32_EXTRAS[name]
    g = torch.Generator(device=card).manual_seed(sq * sk)
    bh = 4
    kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start,
              dropout_rate=rate, dropout_seed=-123)
    if kvb:
        kw["kv_bias"] = torch.where(
            torch.rand(bh, sk, generator=g, device=card) < 0.25,
            torch.full((), -1e30, device=card),
            torch.zeros((), device=card))
    if rows is not None:
        bias = torch.randn(1 if rows == 1 else bh, sq, sk, generator=g,
                           device=card)
        bias[..., ::7] = -1e30
        kw["bias"] = bias
    args = _f32_case(card, bh, sq, sk, d, sq - sk, **kw)
    _f32_backward_holds(FA, args, kw, return_ds=rows is not None)


def test_f32_backward_kernels_read_strided_and_broadcast_views(card):
    """q, k, v and dO as views: heads split from a packed [BH, S, 3, D]
    buffer (a row stride of 3·D), k and v broadcast over bh (stride 0),
    dO at an odd element offset (copied once): the same bits as from
    contiguous copies."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(8)
    bh, s, d = 6, 150, 64
    qkv = torch.randn(bh, s, 3, d, generator=g, device=card)
    q = qkv[:, :, 0]
    k, v = (torch.randn(1, s, d, generator=g, device=card).expand(bh, s, d)
            for _ in range(2))
    do = torch.randn(bh * s * d + 1, generator=g, device=card)[1:].view(
        bh, s, d)
    assert FA._readable(q) is q and FA._readable(k) is k
    assert FA._readable(do) is not do
    kw = dict(causal=True, scale=d ** -0.5)
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    o, lse = FA.reference_attention(qc, kc, vc, return_lse=True, **kw)
    delta = FA.flash_delta(o, doc)
    got = _f32_backward_holds(FA, (q, k, v, do, lse, delta), kw)
    want = (FA.flash_bwd_dq(qc, kc, vc, doc, lse, delta, **kw),
            *FA.flash_bwd_dkv(qc, kc, vc, doc, lse, delta, **kw))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_f32_wrappers_refuse_what_the_kernels_do_not_take(card):
    from apex_tpu_torch.ops import flash_attn as FA
    q = torch.zeros(2, 16, 64, device=card)
    lse = torch.zeros(2, 16, device=card)
    kw = dict(causal=False, scale=0.125)
    # the forward, dq and dk/dv take fp32 to D 256
    for t in (q.bfloat16(), torch.zeros(2, 16, 257, device=card)):
        with pytest.raises(ValueError, match="takes fp32 at a head dim"):
            FA.flash_f32_fwd(t, t, t, **kw)
    for t in (q.bfloat16(), torch.zeros(2, 16, 257, device=card)):
        with pytest.raises(ValueError, match="takes fp32 at a head dim"):
            FA.flash_f32_dq(t, t, t, t, lse, lse, **kw)
        with pytest.raises(ValueError, match="takes fp32 at a head dim"):
            FA.flash_f32_dkv(t, t, t, t, lse, lse, **kw)
    with pytest.raises(ValueError, match="return_ds needs the bias"):
        FA.flash_f32_dq(q, q, q, q, lse, lse, return_ds=True, **kw)


# -- the bf16/fp16 forward, dq and dk/dv at head dims 129-256 (run at D 256)

# bh, sq, sk, d, causal, q_start, k_start: blocks of 128 query rows, the
# forward's 64-key tiles and dq's 32-key ones, dk/dv's blocks of 64 keys
# and its 64-query tiles, ragged tails, offsets
D256_CASES = [
    (2, 300, 300, 256, True, 0, 0), (2, 197, 197, 256, False, 0, 0),
    (2, 1023, 1023, 192, True, 0, 0), (3, 130, 100, 129, True, -50, 0),
    (2, 33, 100, 256, True, 67, 0), (1, 255, 256, 192, False, 0, 0),
    (2, 129, 255, 129, True, 0, 10), (1, 1, 5, 256, False, 0, 0),
    (2, 64, 31, 200, True, 0, 0), (1, 128, 97, 256, False, 5, 3),
    (2, 130, 129, 256, True, 0, 0), (2, 63, 65, 256, False, 0, 0),
    (1, 65, 64, 250, True, 0, 1), (2, 200, 191, 256, True, 9, 0)]


def _d256_inputs(card, bh, sq, sk, d, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(bh, sq, d, generator=g, device=card).to(dtype)
    k, v = (torch.randn(bh, sk, d, generator=g, device=card).to(dtype)
            for _ in range(2))
    do = torch.randn(bh, sq, d, generator=g, device=card).to(dtype)
    return q, k, v, do


# the wrappers that count the forms past head dim 128
WIDE_FORMS = ("flash_d256_fwd", "flash_d256_dq", "flash_d256_dkv",
              "flash_d512_fwd", "flash_d512_dq", "flash_d512_dkv",
              "flash_simt_fwd", "flash_simt_dq", "flash_simt_dkv",
              "flash_f32_d512_fwd", "flash_f32_d512_dq",
              "flash_f32_d512_dkv")
D256 = ("flash_d256_fwd", "flash_d256_dq", "flash_d256_dkv")
D512 = ("flash_d512_fwd", "flash_d512_dq", "flash_d512_dkv")
F32X = ("flash_f32_d512_fwd", "flash_f32_d512_dq", "flash_f32_d512_dkv")


def _d256_against_plain(q, k, v, do, dtype, launched=D256, lse_tol=1e-3,
                        **kw):
    """The forward, dq and dk/dv past head dim 128 (through ``flash_fwd``,
    ``flash_bwd_dq`` and ``flash_bwd_dkv``, launching each of
    ``launched`` once, the D-256 kernels by default, and no other form of
    ``WIDE_FORMS``) against the plain versions under ``_flash_rule`` (lse
    within ``lse_tol``; dS too when a per-bh bias asks for it, under the
    bf16 rule, fp32's in fp32), and a second run of each equal bit for
    bit. Returns o, lse, dq, dk, dv."""
    from apex_tpu_torch.ops import flash_attn as FA
    before = {n: getattr(FA, n).launches for n in WIDE_FORMS}
    bias = kw.get("bias")
    rds = bias is not None and bias.shape[0] > 1
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    out = FA.flash_bwd_dq(q, k, v, do, lse, delta, return_ds=rds, **kw)
    dq, ds = out if rds else (out, None)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert {n: getattr(FA, n).launches - before[n] for n in WIDE_FORMS} == \
        {n: int(n in launched) for n in WIDE_FORMS}
    plain = dict(kw)
    plain.pop("bias", None)
    o0, lse0 = FA.reference_attention(q, k, v, bias, return_lse=True,
                                      **plain)
    assert o.dtype == dtype and o.shape == q.shape
    _flash_rule(o, o0, dtype)
    torch.testing.assert_close(lse, lse0, atol=lse_tol, rtol=0)
    want = FA.flash_bwd_plain(q, k, v, do, lse, delta, return_ds=rds, **kw)
    assert dq.dtype == dtype and dq.shape == q.shape
    for a, b0 in zip((dq, dk, dv), want[:3]):
        assert a.dtype == dtype and a.shape == b0.shape
        _flash_rule(a, b0, dtype)
    if rds:
        _flash_rule(ds, want[3], torch.float32 if dtype == torch.float32
                    else torch.bfloat16)
    again = FA.flash_fwd(q, k, v, **kw)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    out2 = FA.flash_bwd_dq(q, k, v, do, lse, delta, return_ds=rds, **kw)
    if rds:
        assert torch.equal(out2[0], dq) and torch.equal(out2[1], ds)
    else:
        assert torch.equal(out2, dq)
    dk2, dv2 = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("case", D256_CASES,
                         ids=["-".join(map(str, c)) for c in D256_CASES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_d256_kernels_match_plain_and_repeat(card, dtype, case):
    bh, sq, sk, d, causal, q_start, k_start = case
    q, k, v, do = _d256_inputs(card, bh, sq, sk, d, dtype, sq + sk + d)
    _d256_against_plain(q, k, v, do, dtype, causal=causal, scale=d ** -0.5,
                        q_start=q_start, k_start=k_start)


@pytest.mark.parametrize("extra", ["kv_bias", "bias", "bias_bh", "dropout",
                                   "all"])
@pytest.mark.parametrize("d", [256, 192, 129])
def test_d256_kernels_with_biases_and_dropout(card, d, extra):
    """A kv_bias masking the last keys, a full bias shared over bh or one
    per bh (dq's dS), dropout 0.1, and all of them at once, causal with
    offsets, bf16 at [3, 261, d] (and Sk 250)."""
    bh, sq, sk = 3, 261, 250
    q, k, v, do = _d256_inputs(card, bh, sq, sk, d, torch.bfloat16, d)
    g = torch.Generator(device=card).manual_seed(d + 1)
    kvb = torch.zeros(bh, sk, device=card)
    kvb[:, -9:] = -1e30
    full = torch.randn(bh, sq, sk, generator=g, device=card)
    kw = dict(causal=True, scale=d ** -0.5, q_start=20, k_start=0)
    if extra in ("kv_bias", "all"):
        kw["kv_bias"] = kvb
    if extra in ("bias", "all"):
        kw["bias"] = full[:1]
    if extra == "bias_bh":
        kw["bias"] = full
    if extra in ("dropout", "all"):
        kw.update(dropout_rate=0.1, dropout_seed=11)
    _d256_against_plain(q, k, v, do, torch.bfloat16, **kw)


def test_d256_rows_that_see_nothing(card):
    """Causal rows before every key (q_start -70): lse = NEG_INF, o and dq
    exactly 0; the rest under the flash rule."""
    from apex_tpu_torch.ops import flash_attn as FA
    q, k, v, do = _d256_inputs(card, 2, 150, 64, 256, torch.bfloat16, 3)
    o, lse, dq, _, _ = _d256_against_plain(q, k, v, do, torch.bfloat16,
                                           causal=True, scale=256 ** -0.5,
                                           q_start=-70)
    assert bool((lse[:, :70] == FA.NEG_INF).all())
    assert not o[:, :70].any() and not dq[:, :70].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_d256_keys_no_query_sees(card, dtype):
    """Causal keys past every query (Sq 100, Sk 300: keys 100-299, whole
    blocks of 64 and a part of one) get dk and dv exactly 0; the rest
    under the flash rule."""
    q, k, v, do = _d256_inputs(card, 2, 100, 300, 256, dtype, 4)
    _, _, _, dk, dv = _d256_against_plain(q, k, v, do, dtype, causal=True,
                                          scale=256 ** -0.5)
    assert not dk[:, 100:].any() and not dv[:, 100:].any()
    assert dk[:, :100].any() and dv[:, :100].any()


def test_d256_kernels_at_more_than_65535_heads(card):
    """BH = 65536 + 7 at D 256, S 16: the heads around and past 65535 give
    the same bits as a launch of their own and hold against the plain
    versions."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, s, d = 65536 + 7, 16, 256
    q, k, v, do = _d256_inputs(card, bh, s, s, d, torch.bfloat16, 9)
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    tail = slice(65536 - 9, bh)
    got = _d256_against_plain(q[tail], k[tail], v[tail], do[tail],
                              torch.bfloat16, **kw)
    for a, b0 in zip((o, lse, dq, dk, dv), got):
        assert torch.equal(a[tail], b0)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 256),
                                     (torch.bfloat16, 320),
                                     (torch.float32, 320)],
                         ids=["f32-256", "bf16-320", "f32-320"])
def test_d256_leaves_fp32_and_wider_heads_to_the_simple_form(card, dtype,
                                                             d):
    """fp32 at D 256 takes its forward, dq and dk/dv in 3xTF32 (the pair
    kernels); bf16 at D 320 takes the D-384 forward, dq and dk/dv, fp32
    there the 3xTF32 forward, dq and dk/dv at D 384; neither the simple
    form nor the 16-bit D-256 kernels launch."""
    from apex_tpu_torch.contrib.multihead_attn import flash_attention
    from apex_tpu_torch.ops import flash_attn as FA
    q, k, v, do = _d256_inputs(card, 2, 100, 100, d, dtype, d)
    fns = (FA.flash_simt_fwd, FA.flash_simt_dq, FA.flash_simt_dkv,
           FA.flash_f32_fwd, FA.flash_f32_dq, FA.flash_f32_dkv,
           FA.flash_d512_fwd, FA.flash_d512_dq, FA.flash_d512_dkv,
           FA.flash_f32_d512_fwd, FA.flash_f32_d512_dq,
           FA.flash_f32_d512_dkv,
           FA.flash_d256_fwd, FA.flash_d256_dq, FA.flash_d256_dkv,
           FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv)
    before = [f.launches for f in fns]
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention(qs, ks, vs, causal=True)
    torch.autograd.grad(o, (qs, ks, vs), do)
    assert [f.launches - n for f, n in zip(fns, before)] == {
        (torch.float32, 256): [0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0],
        (torch.bfloat16, 320): [0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0],
        (torch.float32, 320): [0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1]}[
            (dtype, d)] + [0] * 6


# -- the bf16/fp16 forward and dq at head dims 257-512 (run at D 384, 512) ---

# bh, sq, sk, d, causal, q_start, k_start: blocks of 64 query rows, the
# forward's 32-key tiles and dq's 32 (D 384) or 16 (D 512), ragged tails,
# offsets, widths not a multiple of 8 (257, 300: copied to 264, 304) and
# ones whose last 64-column tile the maps fill wholly with zeros (257,
# 448)
D512_CASES = [
    (2, 300, 300, 320, True, 0, 0), (2, 197, 197, 512, False, 0, 0),
    (2, 1023, 1023, 448, True, 0, 0), (3, 130, 100, 257, True, -50, 0),
    (2, 33, 100, 384, True, 67, 0), (1, 255, 256, 300, False, 0, 0),
    (2, 129, 255, 257, True, 0, 10), (1, 1, 5, 512, False, 0, 0),
    (2, 64, 31, 320, True, 0, 0), (1, 128, 97, 512, False, 5, 3),
    (2, 65, 63, 448, True, 0, 1), (2, 200, 191, 384, True, 9, 0)]


@pytest.mark.parametrize("case", D512_CASES,
                         ids=["-".join(map(str, c)) for c in D512_CASES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_d512_kernels_match_plain_and_repeat(card, dtype, case):
    bh, sq, sk, d, causal, q_start, k_start = case
    q, k, v, do = _d256_inputs(card, bh, sq, sk, d, dtype, sq + sk + d)
    _d256_against_plain(q, k, v, do, dtype, D512, causal=causal,
                        scale=d ** -0.5, q_start=q_start, k_start=k_start)


@pytest.mark.parametrize("extra", ["kv_bias", "bias", "bias_bh", "dropout",
                                   "all"])
@pytest.mark.parametrize("d,dtype", [(320, torch.bfloat16),
                                     (512, torch.bfloat16),
                                     (300, torch.float16),
                                     (448, torch.float16)],
                         ids=["320-bf16", "512-bf16", "300-f16", "448-f16"])
def test_d512_kernels_with_biases_and_dropout(card, d, dtype, extra):
    """A kv_bias masking the last keys, a full bias shared over bh or one
    per bh (dq's dS), dropout 0.1, and all of them at once, causal with
    offsets, at [3, 261, d] (and Sk 250)."""
    bh, sq, sk = 3, 261, 250
    q, k, v, do = _d256_inputs(card, bh, sq, sk, d, dtype, d)
    g = torch.Generator(device=card).manual_seed(d + 1)
    kvb = torch.zeros(bh, sk, device=card)
    kvb[:, -9:] = -1e30
    full = torch.randn(bh, sq, sk, generator=g, device=card)
    kw = dict(causal=True, scale=d ** -0.5, q_start=20, k_start=0)
    if extra in ("kv_bias", "all"):
        kw["kv_bias"] = kvb
    if extra in ("bias", "all"):
        kw["bias"] = full[:1]
    if extra == "bias_bh":
        kw["bias"] = full
    if extra in ("dropout", "all"):
        kw.update(dropout_rate=0.1, dropout_seed=11)
    _d256_against_plain(q, k, v, do, dtype, D512, **kw)


def test_d512_rows_that_see_nothing(card):
    """Causal rows before every key (q_start -70): lse = NEG_INF, o and dq
    exactly 0; the rest under the flash rule."""
    from apex_tpu_torch.ops import flash_attn as FA
    q, k, v, do = _d256_inputs(card, 2, 150, 64, 320, torch.bfloat16, 3)
    o, lse, dq, _, _ = _d256_against_plain(q, k, v, do, torch.bfloat16,
                                           D512, causal=True,
                                           scale=320 ** -0.5, q_start=-70)
    assert bool((lse[:, :70] == FA.NEG_INF).all())
    assert not o[:, :70].any() and not dq[:, :70].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32],
                         ids=["bf16", "f16", "f32"])
def test_d512_keys_no_query_sees(card, dtype):
    """Causal keys past every query at D 320 (Sq 100, Sk 300: keys 100-299,
    whole blocks of 64 (of 32 in fp32) and a part of one) get dk and dv
    exactly 0; the rest under the dtype's flash rule."""
    f32 = dtype == torch.float32
    q, k, v, do = _d256_inputs(card, 2, 100, 300, 320, dtype, 4)
    _, _, _, dk, dv = _d256_against_plain(
        q, k, v, do, dtype, F32X if f32 else D512,
        lse_tol=1e-4 if f32 else 1e-3, causal=True, scale=320 ** -0.5)
    assert not dk[:, 100:].any() and not dv[:, 100:].any()
    assert dk[:, :100].any() and dv[:, :100].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_d512_autograd_chain_matches_the_plain_chain(card, dtype):
    """``flash_attention`` at [16, 1024, 320] causal in bf16 and fp16,
    forward and backward through autograd (the D-384 forward, dq and
    dk/dv, one launch each) against the same chain under the plain
    versions: o, dq, dk and dv under the 16-bit flash rule. dk/dv rests on
    the kernel forward's lse and on delta of its o."""
    from apex_tpu_torch.contrib.multihead_attn import flash_attention
    from apex_tpu_torch.ops import flash_attn as FA
    q, k, v, do = _d256_inputs(card, 16, 1024, 1024, 320, dtype, 33)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def run():
        o = flash_attention(*ts, causal=True)
        return (o, *torch.autograd.grad(o, ts, do))
    fns = [getattr(FA, n) for n in WIDE_FORMS]
    before = [f.launches for f in fns]
    got = run()
    assert {n: f.launches - b for n, f, b in zip(WIDE_FORMS, fns, before)} \
        == {n: int(n in D512) for n in WIDE_FORMS}
    with dispatch.backend("reference"):
        want = run()
    for a, b0 in zip(got, want):
        _flash_rule(a, b0, dtype)


def test_d512_kernels_read_strided_views(card):
    """q, k and v as head slices of a packed [BH, S, 3 · 320] projection
    (row stride 960, no copy) give the bits of their contiguous copies: o,
    lse, dq, dk and dv."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(17)
    qkv = torch.randn(4, 200, 3 * 320, generator=g, device=card).bfloat16()
    q, k, v = qkv[..., :320], qkv[..., 320:640], qkv[..., 640:]
    do = torch.randn(4, 200, 320, generator=g, device=card).bfloat16()
    kw = dict(causal=True, scale=320 ** -0.5)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    oc, lsec = FA.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                            **kw)
    assert torch.equal(o, oc) and torch.equal(lse, lsec)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dq, FA.flash_bwd_dq(q.contiguous(), k.contiguous(),
                                           v.contiguous(), do, lse, delta,
                                           **kw))
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dkc, dvc = FA.flash_bwd_dkv(q.contiguous(), k.contiguous(),
                                v.contiguous(), do, lse, delta, **kw)
    assert torch.equal(dk, dkc) and torch.equal(dv, dvc)


def test_d512_kernels_at_more_than_65535_heads(card):
    """BH = 65536 + 7 at D 320, S 16: the heads around and past 65535 give
    the same bits as a launch of their own and hold against the plain
    versions."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, s, d = 65536 + 7, 16, 320
    q, k, v, do = _d256_inputs(card, bh, s, s, d, torch.bfloat16, 9)
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    tail = slice(65536 - 9, bh)
    got = _d256_against_plain(q[tail], k[tail], v[tail], do[tail],
                              torch.bfloat16, D512, **kw)
    for a, b0 in zip((o, lse, dq, dk, dv), got):
        assert torch.equal(a[tail], b0)


# -- the fp32 dq and dk/dv at head dims 129-256 (3xTF32 pair kernels) ---------

# (sq, sk, d, causal, q_start, k_start): blocks of 64 rows (queries for dq,
# keys for dk/dv, 16 a pair of warps), staged tiles of 16, ragged tails,
# Sq != Sk, causal offsets, rows that see no key, D 200 padded to 256
F32_D256_EDGES = [(1, 1, 256, False, 0, 0), (1, 63, 200, True, 62, 0),
                  (15, 17, 256, True, 0, 0), (16, 16, 200, False, 0, 0),
                  (63, 64, 256, True, 0, 0), (64, 65, 200, False, 0, 0),
                  (65, 127, 256, True, 64, 2), (127, 129, 200, True, 0, 0),
                  (129, 33, 256, False, 0, 0), (200, 77, 256, True, 5, 130),
                  (31, 97, 200, True, 70, 0), (300, 250, 256, True, -40, 0),
                  (1023, 1000, 200, True, 23, 0),
                  (1000, 1023, 256, False, 0, 0)]


@pytest.mark.parametrize("sq,sk,d,causal,q_start,k_start", F32_D256_EDGES)
def test_f32_d256_backward_kernels_at_the_tile_edges(card, sq, sk, d, causal,
                                                     q_start, k_start):
    """fp32 dq and dk/dv at D 200 and 256 by the 3xTF32 pair kernels
    (``flash_bwd_dq``/``flash_bwd_dkv`` launching ``flash_f32_dq``/``_dkv``
    once each, the simple form never) against ``flash_bwd_plain`` under
    the fp32 flash rule, and a second run bit for bit."""
    from apex_tpu_torch.ops import flash_attn as FA
    kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start,
              k_start=k_start)
    args = _f32_case(card, 3, sq, sk, d, sq + sk + d, **kw)
    dq, dk, dv = _f32_backward_holds(FA, args, kw)
    if causal and k_start > q_start:       # rows that see no key
        assert not dq[:, :k_start - q_start].any()
    if causal and k_start + sk > q_start + sq:   # keys no query sees
        last = max(0, q_start + sq - k_start)
        assert not dk[:, last:].any() and not dv[:, last:].any()


# name -> (sq, sk, d, causal, q_start, kv_bias, bias rows, dropout rate)
F32_D256_EXTRAS = {
    "kv_bias": (197, 200, 256, False, 0, True, None, 0.0),
    "bias_shared_ds": (197, 197, 200, False, 0, False, 1, 0.0),
    "bias_bh_ds_causal": (130, 140, 256, True, 10, False, "bh", 0.0),
    "dropout": (257, 257, 256, True, 0, False, None, 0.1),
    "dropout_d200": (100, 130, 200, False, 0, False, None, 0.2),
    "all": (129, 200, 256, True, 71, True, "bh", 0.2),
    "all_d200": (70, 90, 200, True, 20, True, 1, 0.1),
}


@pytest.mark.parametrize("name", list(F32_D256_EXTRAS))
def test_f32_d256_backward_kernels_with_biases_and_dropout(card, name):
    """The pair kernels' EXTRA forms at D 256 and 200: a kv_bias with masked
    keys, a full bias shared or per bh (dq's dS beside dq), dropout, all
    at once; each held as the plain forms."""
    from apex_tpu_torch.ops import flash_attn as FA
    sq, sk, d, causal, q_start, kvb, rows, rate = F32_D256_EXTRAS[name]
    g = torch.Generator(device=card).manual_seed(sq * sk + d)
    bh = 4
    kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start,
              dropout_rate=rate, dropout_seed=-123)
    if kvb:
        kw["kv_bias"] = torch.where(
            torch.rand(bh, sk, generator=g, device=card) < 0.25,
            torch.full((), -1e30, device=card),
            torch.zeros((), device=card))
    if rows is not None:
        bias = torch.randn(1 if rows == 1 else bh, sq, sk, generator=g,
                           device=card)
        bias[..., ::7] = -1e30
        kw["bias"] = bias
    args = _f32_case(card, bh, sq, sk, d, sq - sk + d, **kw)
    _f32_backward_holds(FA, args, kw, return_ds=rows is not None)


def test_f32_d256_backward_kernels_read_strided_and_broadcast_views(card):
    """At D 256: q and dO heads split from packed [BH, S, 2, D] buffers (a
    row stride of 2·D), k and v broadcast over bh (stride 0), all read in
    place: the same bits as from contiguous copies."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(10)
    bh, s, d = 5, 150, 256
    q, do = torch.randn(bh, s, 2, d, generator=g, device=card).unbind(2)
    k, v = (torch.randn(1, s, d, generator=g, device=card).expand(bh, s, d)
            for _ in range(2))
    assert all(FA._readable(t) is t for t in (q, k, v, do))
    kw = dict(causal=True, scale=d ** -0.5)
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    o, lse = FA.reference_attention(qc, kc, vc, return_lse=True, **kw)
    delta = FA.flash_delta(o, doc)
    got = _f32_backward_holds(FA, (q, k, v, do, lse, delta), kw)
    want = (FA.flash_bwd_dq(qc, kc, vc, doc, lse, delta, **kw),
            *FA.flash_bwd_dkv(qc, kc, vc, doc, lse, delta, **kw))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_f32_d256_backward_at_more_than_65535_heads(card):
    """BH = 65536 + 7 at D 256, S 20: the heads around and past 65535 give
    the same bits as a launch of their own and hold against the plain
    version."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, s, d = 65536 + 7, 20, 256
    kw = dict(causal=True, scale=d ** -0.5)
    q, k, v, do, lse, delta = _f32_case(card, bh, s, s, d, 12, **kw)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    tail = slice(65536 - 9, bh)
    got = _f32_backward_holds(FA, tuple(t[tail] for t in (q, k, v, do, lse,
                                                          delta)), kw)
    for a, b0 in zip((dq, dk, dv), got):
        assert torch.equal(a[tail], b0)


@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_d256_shared_bias_gradient_in_bf16_and_fp16(card, dtype, d):
    """A learned [1, Sq, Sk] bias at D 129-256 in bf16 and fp16, causal with
    a kv_bias and dropout: ``flash_bwd_dbias`` (``csrc/flash_dbias.cu``
    on wgmma, one launch) against ``flash_bwd_dbias_plain`` under
    the dtype's flash rule, and two runs bit for bit."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(d + 5)
    bh, sq, sk = 12, 197, 190
    q, do = (torch.randn(bh, sq, d, generator=g, device=card).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=g, device=card).to(dtype)
            for _ in range(2))
    bias = torch.randn(1, sq, sk, generator=g, device=card)
    kvb = torch.zeros(bh, sk, device=card)
    kvb[:, -5:] = -1e30
    kw = dict(causal=True, scale=d ** -0.5, q_start=7, bias=bias,
              kv_bias=kvb, dropout_rate=0.1, dropout_seed=21)
    plain = {n: x for n, x in kw.items() if n != "bias"}
    o, lse = FA.reference_attention(q, k, v, bias, return_lse=True, **plain)
    delta = FA.flash_delta(o, do)
    before = FA.flash_bwd_dbias.launches
    got = FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw)
    assert FA.flash_bwd_dbias.launches == before + 1
    assert got.shape == (1, sq, sk) and got.dtype == torch.float32
    want = FA.flash_bwd_dbias_plain(q, k, v, do, lse, delta, **kw)
    _flash_rule(got, want, dtype)
    assert torch.equal(FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw),
                       got)


# -- the fp32 forward and dq at head dims 257-512 (3xTF32 at D 384, 512) -----

@pytest.mark.parametrize("case", D512_CASES,
                         ids=["-".join(map(str, c)) for c in D512_CASES])
def test_f32_d512_kernels_match_plain_and_repeat(card, case):
    """fp32 at D 257-512 (``D512_CASES``: ragged tails, offsets, widths not
    a multiple of 4 or 8, D 257, 300, 320, 384, 448, 512): the 3xTF32
    forward and dq and the simple dk/dv, each launched once, against the
    plain versions under the fp32 flash rule (lse within 1e-4), a second
    run bit for bit."""
    bh, sq, sk, d, causal, q_start, k_start = case
    q, k, v, do = _d256_inputs(card, bh, sq, sk, d, torch.float32,
                               sq + sk + d)
    _d256_against_plain(q, k, v, do, torch.float32, F32X, lse_tol=1e-4,
                        causal=causal, scale=d ** -0.5, q_start=q_start,
                        k_start=k_start)


@pytest.mark.parametrize("extra", ["kv_bias", "bias", "bias_bh", "dropout",
                                   "all"])
@pytest.mark.parametrize("d", [320, 512, 300])
def test_f32_d512_kernels_with_biases_and_dropout(card, d, extra):
    """A kv_bias masking the last keys, a full bias shared over bh or one
    per bh (dq's dS, under the fp32 rule), dropout 0.1, and all of them at
    once, causal with offsets, fp32 at [3, 261, d] (and Sk 250)."""
    bh, sq, sk = 3, 261, 250
    q, k, v, do = _d256_inputs(card, bh, sq, sk, d, torch.float32, d)
    g = torch.Generator(device=card).manual_seed(d + 1)
    kvb = torch.zeros(bh, sk, device=card)
    kvb[:, -9:] = -1e30
    full = torch.randn(bh, sq, sk, generator=g, device=card)
    kw = dict(causal=True, scale=d ** -0.5, q_start=20, k_start=0)
    if extra in ("kv_bias", "all"):
        kw["kv_bias"] = kvb
    if extra in ("bias", "all"):
        kw["bias"] = full[:1]
    if extra == "bias_bh":
        kw["bias"] = full
    if extra in ("dropout", "all"):
        kw.update(dropout_rate=0.1, dropout_seed=11)
    _d256_against_plain(q, k, v, do, torch.float32, F32X, lse_tol=1e-4,
                        **kw)


@pytest.mark.parametrize("d", [320, 512])
def test_f32_d512_dropout_mask_reads_back_exactly(card, d):
    """q = k = 0 makes every probability 1/64 over 64 keys (four of the
    forward's staged tiles at D 384, eight at 512), v = I puts p·keep/(1
    − rate) at o[i, j]: o[i, j] != 0 exactly where ``dropout_bits`` keeps
    (i, j), at a nonzero bh, q_start and k_start."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, n, rate, seed = 3, 64, 0.1, 0x2468ACE
    q = torch.zeros(bh, n, d, device=card)
    v = torch.eye(n, d, device=card).expand(bh, n, d).contiguous()
    kw = dict(causal=False, scale=0.125, q_start=700, k_start=9,
              dropout_rate=rate, dropout_seed=seed)
    before = FA.flash_f32_d512_fwd.launches
    o, _ = FA.flash_fwd(q, q, v, **kw)
    assert FA.flash_f32_d512_fwd.launches == before + 1
    pos = torch.arange(n, device=card)
    keep = FA.dropout_bits(seed, torch.arange(bh, device=card)[:, None, None],
                           700 + pos[None, :, None],
                           9 + pos[None, None, :]) >= FA.drop_threshold(rate)
    assert torch.equal(o[..., :n] != 0, keep) and not o[..., n:].any()
    assert 0.8 < float(keep.float().mean()) < 1.0


def test_f32_d512_rows_that_see_nothing(card):
    """Causal rows before every key (q_start -70), fp32 at D 320: lse =
    NEG_INF, o and dq exactly 0; the rest under the fp32 rule."""
    from apex_tpu_torch.ops import flash_attn as FA
    q, k, v, do = _d256_inputs(card, 2, 150, 64, 320, torch.float32, 3)
    o, lse, dq, _, _ = _d256_against_plain(q, k, v, do, torch.float32, F32X,
                                           lse_tol=1e-4, causal=True,
                                           scale=320 ** -0.5, q_start=-70)
    assert bool((lse[:, :70] == FA.NEG_INF).all())
    assert not o[:, :70].any() and not dq[:, :70].any()


def test_f32_d512_kernels_read_strided_and_broadcast_views(card):
    """At D 320 fp32: q and dO heads split from packed [BH, S, 2, D]
    buffers (a row stride of 2·D), k and v broadcast over bh (stride 0),
    read in place; q at an element offset off 16 bytes (copied once):
    the same bits as from contiguous copies."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(19)
    bh, s, d = 5, 150, 320
    q, do = torch.randn(bh, s, 2, d, generator=g, device=card).unbind(2)
    k, v = (torch.randn(1, s, d, generator=g, device=card).expand(bh, s, d)
            for _ in range(2))
    ready = FA._f32x_ready("flash_f32_d512_dq", q, k, v, do)
    assert [t.data_ptr() for t in ready] == [t.data_ptr()
                                             for t in (q, k, v, do)]
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse, dq, dk, dv = _d256_against_plain(q, k, v, do, torch.float32,
                                             F32X, lse_tol=1e-4, **kw)
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    oc, lsec = FA.flash_fwd(qc, kc, vc, **kw)
    assert torch.equal(o, oc) and torch.equal(lse, lsec)
    delta = FA.flash_delta(o, do)
    assert torch.equal(FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                       FA.flash_bwd_dq(qc, kc, vc, doc, lse, delta, **kw))
    dkc, dvc = FA.flash_bwd_dkv(qc, kc, vc, doc, lse, delta, **kw)
    assert torch.equal(dk, dkc) and torch.equal(dv, dvc)
    shifted = torch.randn(bh * s * d + 1, generator=g, device=card)[1:]
    shifted = shifted.view(bh, s, d)
    assert FA._f32x_ready("flash_f32_d512_fwd", shifted, k, v)[0] \
        .data_ptr() != shifted.data_ptr()
    got = FA.flash_fwd(shifted, k, v, **kw)
    want = FA.flash_fwd(shifted.clone(), kc, vc, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_f32_d512_kernels_at_more_than_65535_heads(card):
    """BH = 65536 + 7 at D 320, S 16, fp32: the heads around and past 65535
    give the same bits as a launch of their own and hold against the
    plain versions."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, s, d = 65536 + 7, 16, 320
    q, k, v, do = _d256_inputs(card, bh, s, s, d, torch.float32, 9)
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    tail = slice(65536 - 9, bh)
    got = _d256_against_plain(q[tail], k[tail], v[tail], do[tail],
                              torch.float32, F32X, lse_tol=1e-4, **kw)
    for a, b0 in zip((o, lse, dq, dk, dv), got):
        assert torch.equal(a[tail], b0)


def test_f32_d512_autograd_chain_matches_the_plain_chain(card):
    """``flash_attention`` at [16, 1024, 320] fp32 causal, forward and
    backward through autograd (the 3xTF32 forward, dq and dk/dv, one
    launch each) against the same chain under the plain versions: o, dq,
    dk and dv under the fp32 flash rule. The chain's dq
    rests on the kernel forward's o and lse (delta = rowsum(dO·o)), so a
    forward off the plain one at rows one key dominates shows here where
    each kernel alone holds."""
    from apex_tpu_torch.contrib.multihead_attn import flash_attention
    from apex_tpu_torch.ops import flash_attn as FA
    q, k, v, do = _d256_inputs(card, 16, 1024, 1024, 320, torch.float32, 31)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def run():
        o = flash_attention(*ts, causal=True)
        return (o, *torch.autograd.grad(o, ts, do))
    fns = [getattr(FA, n) for n in WIDE_FORMS]
    before = [f.launches for f in fns]
    got = run()
    assert {n: f.launches - b for n, f, b in zip(WIDE_FORMS, fns, before)} \
        == {n: int(n in F32X) for n in WIDE_FORMS}
    with dispatch.backend("reference"):
        want = run()
    for a, b0 in zip(got, want):
        _flash_rule(a, b0, torch.float32)


# -- the shared-bias gradient on the tensor cores at every head dim ----------
# (csrc/flash_dbias.cu: bf16/fp16 on wgmma, fp32 in 3xTF32)

DBIAS_DIMS = (64, 96, 128, 200, 256, 320, 384, 512)
DBIAS_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _dbias_case(card, bh, sq, sk, d, dtype, seed, **kw):
    """Inputs, the plain forward's lse and delta, and the keywords of one
    shared-bias reading (a learned [1, Sq, Sk] bias, some keys masked)."""
    from apex_tpu_torch.ops import flash_attn as FA
    q, k, v, do = _d256_inputs(card, bh, sq, sk, d, dtype, seed)
    g = torch.Generator(device=card).manual_seed(seed + 1)
    bias = torch.randn(1, sq, sk, generator=g, device=card)
    bias[0, :, ::11] = FA.NEG_INF
    kw = dict(scale=d ** -0.5, bias=bias, **kw)
    plain = {n: x for n, x in kw.items() if n != "bias"}
    o, lse = FA.reference_attention(q, k, v, bias, return_lse=True, **plain)
    return (q, k, v, do, lse, FA.flash_delta(o, do)), kw


def _dbias_holds(card, args, kw, dtype):
    """``flash_bwd_dbias`` against ``flash_bwd_dbias_plain`` under the
    dtype's flash rule, one launch of it and none of the simple form or the
    dq wrappers, its output memory dirtied first (a tile left unwritten
    would show), and a second run bit for bit."""
    from apex_tpu_torch.ops import flash_attn as FA
    sq, sk = kw["bias"].shape[1:]
    junk = torch.full((1, sq, sk), float("nan"), device=card)
    del junk                                    # its block, reused dirty
    fns = (FA.flash_bwd_dbias, FA.flash_simt_dbias, FA.flash_bwd_dq,
           FA.flash_simt_dq, FA.flash_f32_dq, FA.flash_d512_dq)
    before = [f.launches for f in fns]
    got = FA.flash_bwd_dbias(*args, **kw)
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 0, 0, 0, 0,
                                                             0]
    assert got.shape == (1, sq, sk) and got.dtype == torch.float32
    want = FA.flash_bwd_dbias_plain(*args, **kw)
    assert bool(torch.isfinite(got).all())
    _flash_rule(got, want, dtype)
    assert torch.equal(FA.flash_bwd_dbias(*args, **kw), got)
    return got


@pytest.mark.parametrize("d", DBIAS_DIMS)
@pytest.mark.parametrize("dtype", DBIAS_DTYPES, ids=["bf16", "f16", "f32"])
def test_dbias_kernels_match_plain_and_repeat(card, dtype, d):
    """Causal at Sq 197 != Sk 150 (ragged tiles of 64) with a kv_bias and
    dropout: the dbias of every (query, key) against the plain version,
    and exactly 0 where the causal mask kills a whole tile of 64 x 64 (the
    kernel skips its loads and writes zeros)."""
    kvb = torch.zeros(12, 150, device=card)
    kvb[:, -6:] = -1e30
    args, kw = _dbias_case(card, 12, 197, 150, d, dtype, d, causal=True,
                           kv_bias=kvb, dropout_rate=0.1, dropout_seed=-3)
    got = _dbias_holds(card, args, kw, dtype)
    # query tile 0 (rows 0-63) sees no key of tiles 1-2, tile 1 none of 2
    assert not got[0, :64, 64:].any() and not got[0, 64:128, 128:].any()


@pytest.mark.parametrize("d", [64, 320])
@pytest.mark.parametrize("dtype", DBIAS_DTYPES, ids=["bf16", "f16", "f32"])
def test_dbias_kernels_without_mask_or_extras(card, dtype, d):
    """No causal mask, kv_bias or dropout at S 197 over 24 heads (runs of
    bh summed in a second pass)."""
    args, kw = _dbias_case(card, 24, 197, 197, d, dtype, 5 + d,
                           causal=False)
    _dbias_holds(card, args, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_dbias_kernels_with_offsets_and_odd_widths(card, dtype):
    """Causal offsets (q_start, k_start), queries past every key and keys
    past every query, head dims that are not a multiple of 16 bytes (40,
    100, 260: the wrapper pads to 8 or 4 elements, the copies fill the
    rest with zeros)."""
    for d, q_start, k_start in ((40, 40, 0), (100, 0, 70), (260, -30, 5)):
        args, kw = _dbias_case(card, 6, 130, 200, d, dtype, d,
                               causal=True, q_start=q_start,
                               k_start=k_start)
        _dbias_holds(card, args, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_dbias_kernels_at_more_than_65535_heads(card, dtype):
    """BH = 65536 + 7 at S 16 (one tile, runs of bh past the grid's 65535
    rows) against the plain version."""
    args, kw = _dbias_case(card, 65536 + 7, 16, 16, 64, dtype, 3,
                           causal=True)
    _dbias_holds(card, args, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_dbias_kernels_read_strided_views(card, dtype):
    """q, k, v and dO as the time-major split hands them ([BH, S, D] views,
    strides (D, B·H·D, 1)): the same bits as from contiguous copies."""
    from apex_tpu_torch.ops import flash_attn as FA
    g = torch.Generator(device=card).manual_seed(8)
    bh, s, d = 6, 150, 320

    def view():
        return torch.randn(s, bh, d, generator=g, device=card).to(
            dtype).transpose(0, 1)
    q, k, v, do = (view() for _ in range(4))
    assert not q.is_contiguous()
    bias = torch.randn(1, s, s, generator=g, device=card)
    kw = dict(causal=True, scale=d ** -0.5, bias=bias)
    o, lse = FA.reference_attention(q, k, v, bias, return_lse=True,
                                    causal=True, scale=d ** -0.5)
    delta = FA.flash_delta(o, do)
    got = FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw)
    want = FA.flash_bwd_dbias(*(t.contiguous() for t in (q, k, v, do)), lse,
                              delta, **kw)
    assert torch.equal(got, want)


def test_dbias_makes_no_per_bh_tensor(card):
    """At [32, 1024, 256] fp32 causal, one call's peak memory over what was
    allocated before it stays below the runs' scratch [runs, Sq, Sk], the
    output [1, Sq, Sk] and 1 MiB: no [BH, Sq, Sk] dS (128 MiB here)."""
    from apex_tpu_torch.ops import flash_attn as FA
    bh, s, d = 32, 1024, 256
    args, kw = _dbias_case(card, bh, s, s, d, torch.float32, 12,
                           causal=True)
    runs = FA.dbias_runs(bh, s, s, torch.cuda.get_device_properties(
        card).multi_processor_count)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    FA.flash_bwd_dbias(*args, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - base
    assert peak <= (runs + 1) * s * s * 4 + 2 ** 20, (peak, runs)
