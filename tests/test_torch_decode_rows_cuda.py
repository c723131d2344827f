"""The multi-row decode kernel on an NVIDIA card (marker ``cuda``).

Q query rows a slot (speculative scoring) through
``ops.decode_attn.decode_attention_rows`` and
``paged_decode_attention_rows``: each row bit-equal to the 1-query kernel
at that row's length, paged equal to dense bit for bit (a page of 5, no
power of 2), within the decode tolerance of the plain version (fp32 1e-5,
bf16 and fp16 1e-2: one rounding of the output), two runs bit-equal, and
the launches counted on the multi-row wrappers. Q 1-8, row lengths 0, 1,
63, 64, 65 and the arena's end (and a slot of random, unordered lengths),
head dims 64 and 128, fp32, bf16 and fp16. Then a small LM's speculative
engine, dense and paged: the greedy streams of the plain engine, the
multi-row kernel launched in every step. Without a card every test here
skips. On a machine with one::

    python -m pytest --noconftest -m cuda \
        tests/test_torch_decode_rows_cuda.py -q
"""

import pytest
import torch

from apex_tpu_torch.ops import decode_attn as DA

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
L, PAGE = 256, 5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lengths(q_rows: int, g) -> torch.Tensor:
    """Slots whose rows run base, base + 1, ... (capped at L): the edges
    0, 1, 63, 64, 65, a slot ending at the arena's end, and one of random
    unordered lengths."""
    bases = [0, 1, 62, 63, 64, 65, L - q_rows + 1]
    rows = [[min(b + j, L) for j in range(q_rows)] for b in bases]
    rows.append(torch.randint(0, L + 1, (q_rows,), generator=g).tolist())
    return torch.tensor(rows, dtype=torch.int32)


def _paged(k, v, page):
    """The dense k, v [S, H, L, hd] behind a shuffled page table; the null
    page 0 holds garbage."""
    s, h, length, hd = k.shape
    n = -(-length // page)
    g = torch.Generator().manual_seed(n)
    phys = (torch.randperm(s * n, generator=g) + 1).to(torch.int32)
    table = phys.reshape(s, n).to(k.device)
    pad = n * page - length
    pools = []
    for t, fill in ((k, 30.0), (v, -30.0)):
        tp = torch.nn.functional.pad(t, (0, 0, 0, pad))
        pool = torch.full((1 + s * n, h, page, hd), fill, device=k.device,
                          dtype=k.dtype)
        pool[table.reshape(-1).long()] = (
            tp.reshape(s, h, n, page, hd).transpose(1, 2)
            .reshape(-1, h, page, hd))
        pools.append(pool)
    return pools[0], pools[1], table


@pytest.mark.parametrize("q_rows", list(range(1, 9)))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_rows_bit_equal_one_query_and_paged_equal_dense(card, dtype, hd,
                                                         q_rows):
    g = torch.Generator().manual_seed(q_rows * 1000 + hd)
    lengths = _lengths(q_rows, g).to(card)
    s, h = lengths.shape[0], 2
    q = torch.randn(s, q_rows, h, hd, generator=g).to(card, dtype)
    k = torch.randn(s, h, L, hd, generator=g).to(card, dtype)
    v = torch.randn(s, h, L, hd, generator=g).to(card, dtype)
    fns = (DA.decode_attention_rows, DA.paged_decode_attention_rows,
           DA.decode_attention, DA.decode_merge)
    before = [f.launches for f in fns]
    got = DA.decode_attention(q, k, v, lengths)   # hands 4-D q to _rows
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 0, 0, 1]
    assert got.shape == q.shape and got.dtype == dtype
    want = DA.decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.equal(DA.decode_attention_rows(q, k, v, lengths), got)
    for j in range(q_rows):
        one = DA.decode_attention(q[:, j].contiguous(), k, v,
                                  lengths[:, j].contiguous())
        assert torch.equal(got[:, j], one), f"row {j}"
    assert not got[0, 0].any()                    # length 0 gives zeros
    kp, vp, table = _paged(k, v, PAGE)
    got_p = DA.paged_decode_attention_rows(q, kp, vp, lengths,
                                           page_table=table)
    assert torch.equal(got_p, got)


def test_rows_refuse_what_the_kernel_does_not_take(card):
    q = torch.zeros(2, 9, 2, 128, device=card)
    kv = torch.zeros(2, 2, 64, 128, device=card)
    lengths = torch.ones(2, 9, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="query rows"):
        DA.decode_attention_rows(q, kv, kv, lengths)
    with pytest.raises(ValueError, match="lengths"):
        DA.decode_attention_rows(q[:, :4].contiguous(), kv, kv, lengths)
    with pytest.raises(ValueError, match="head_dim"):
        DA.decode_attention_rows(torch.zeros(2, 4, 2, 96, device=card),
                                 torch.zeros(2, 2, 64, 96, device=card),
                                 torch.zeros(2, 2, 64, 96, device=card),
                                 lengths[:, :4].contiguous())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_engine_launches_the_rows_kernel(card, paged):
    """A small LM at fp32 (the parity-gate dtype) served with spec_k 3 and
    a 1-layer draft: the plain engine's greedy streams, one multi-row
    launch per target layer a step and one per draft layer for the
    catch-up row."""
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                      draft_from_prefix, poisson_requests)
    m = TransformerLM(vocab_size=512, max_seq_len=128, embed_dim=256,
                      num_heads=2, num_layers=2)
    p = m.init(0)
    reqs = poisson_requests(8, rate=0.0, prompt_dist="uniform:3,60",
                            new_dist="uniform:2,40", vocab_size=512,
                            seed=2, max_len=128, prefill_chunk=8)
    kw = dict(slots=3, max_len=128, prefill_chunk=8)
    if paged:
        kw.update(paged=True, page_size=8, kv_pages=48)
    base, _ = ContinuousBatchingEngine(m, p, **kw).run(reqs)
    rows = (DA.paged_decode_attention_rows if paged
            else DA.decode_attention_rows)
    before = rows.launches
    eng = ContinuousBatchingEngine(m, p, draft=draft_from_prefix(m, p, 1),
                                   spec_k=3, **kw)
    got, stats = eng.run(reqs)
    assert [r.tokens for r in got] == [r.tokens for r in base]
    assert rows.launches - before == (m.num_layers + 1) * \
        stats["decode_steps"]
