"""The port's hand kernels on an NVIDIA card (marker ``cuda``).

Each kernel against its plain PyTorch version on the same card tensors,
the wrappers' refusals, and a small engine whose paged greedy streams
must equal its dense ones while every kernel launches. Without a card
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
