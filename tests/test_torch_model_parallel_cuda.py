"""Sequence, expert and pipeline parallelism's pieces on an NVIDIA card
(marker ``cuda``).

The flash kernels (forward, dq, dk/dv) on the shards the ring hands
them — a causal shard wholly in a row's future (every row sees nothing:
lse ``NEG_INF``, o 0) and the diagonal one — with the lse cotangent that
``merge_partials`` gives, against the plain versions under the flash
rule; ``MoEMLP.decode`` captured in a CUDA graph equal to eager; and the
collectives' gloo-on-CUDA forms (host-staged send/recv and all-to-all)
over two ranks on the one card equal to the CPU group's values and
grads bit for bit (a local ``torch.sum`` before one sum aside). Without a card every test here skips. On a machine
with one::

    python -m pytest --noconftest -m cuda tests/test_torch_model_parallel_cuda.py -q
"""

import numpy as np
import pytest
import torch

import _torch_dist as D

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flash_close(got, want):
    """The flash rule: 2 bf16 ulps + 2^-6 of the row's RMS over D (at
    least 2^-6 of the tensor's)."""
    a, b = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(a), torch.frexp(
        torch.maximum(a.abs(), b.abs()))[1] - 8)
    rms = torch.clamp(b.pow(2).mean(-1, keepdim=True).sqrt(),
                      min=2.0 ** -6 * float(b.pow(2).mean().sqrt()))
    assert bool(((a - b).abs() <= 2 * ulp + 2.0 ** -6 * rms).all())


@pytest.mark.parametrize("d", [64, 128])
def test_flash_on_a_masked_shard_with_the_merges_dlse(card, d):
    """Rank 1 of 3 in the ring: its own shard (the diagonal), the shard
    before it and the one after it (wholly in its future), each through
    the forward kernel, merged by ``merge_partials``; the loss reads the
    merged o and lse, so each partial's backward gets a dO and an lse
    cotangent from the merge. Each partial's forward, dq and dk/dv against
    the plain versions on the same inputs and cotangents."""
    from apex_tpu_torch.ops import flash_attn as FA
    from apex_tpu_torch.parallel.ring_attention import merge_partials
    bh, s = 16, 256
    g = torch.Generator(device=card).manual_seed(d)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=card).to(
            torch.bfloat16)

    q, do = rnd(bh, s, d), rnd(bh, s, d)
    kvs = [(rnd(bh, s, d), rnd(bh, s, d)) for _ in range(3)]
    dl = torch.randn(bh, s, generator=g, device=card)
    kws = {src: dict(causal=True, scale=d ** -0.5, q_start=s,
                     k_start=src * s) for src in range(3)}
    outs = {src: FA.flash_fwd(q, *kvs[src], **kws[src]) for src in range(3)}
    for src in range(3):
        o0, lse0 = FA._fwd_plain(q, *kvs[src], kv_bias=None, bias=None,
                                 dropout_rate=0.0, dropout_seed=0,
                                 **kws[src])
        _flash_close(outs[src][0], o0)
        live = lse0 > FA.NEG_INF * 0.5
        assert float(torch.where(live, (outs[src][1] - lse0).abs(),
                                 0.0).max()) <= 1e-3
        assert torch.equal(outs[src][1][~live], lse0[~live])
    o2, lse2 = outs[2]
    assert bool((lse2 == FA.NEG_INF).all()) and not o2.any()
    # the merge's cotangents for each partial, in the ring's order
    leaves = {src: (outs[src][0].float().requires_grad_(True),
                    outs[src][1].clone().requires_grad_(True))
              for src in range(3)}
    o = torch.zeros(bh, s, d, device=card)
    lse = torch.full((bh, s), FA.NEG_INF, device=card)
    for src in (1, 0, 2):
        o, lse = merge_partials(o, lse, *leaves[src])
    loss = (o * do.float()).sum() + (lse * dl).sum()
    cots = torch.autograd.grad(loss, [t for src in range(3)
                                      for t in leaves[src]])
    for src in range(3):
        do_t, dlse_t = cots[2 * src].to(torch.bfloat16), cots[2 * src + 1]
        o_t, lse_t = outs[src]
        if src != 2:
            assert dlse_t.abs().sum() > 0        # the merge gave one
        delta = FA.flash_delta(o_t, do_t, dlse_t)
        args = (q, *kvs[src], do_t, lse_t, delta)
        dq = FA.flash_bwd_dq(*args, **kws[src])
        dk, dv = FA.flash_bwd_dkv(*args, **kws[src])
        want = FA.flash_bwd_plain(*args, **kws[src])
        for a, b in zip((dq, dk, dv), want):
            _flash_close(a, b)
        if src == 2:       # the shard after the rows: no gradient at all
            assert not dq.any() and not dk.any() and not dv.any()


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_decode_captured_equals_eager(card, top_k):
    from apex_tpu_torch.contrib.moe import MoEMLP
    moe = MoEMLP(hidden=1024, ffn=4096, num_experts=4, top_k=top_k)
    p = moe.init(0, dtype=torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(top_k)
    x = torch.randn(32, 1024, generator=g, device=card).to(torch.bfloat16)
    eager = moe.decode(p, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.decode(p, x)                     # warm the libraries
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.decode(p, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2 = torch.randn(32, 1024, generator=g, device=card).to(torch.bfloat16)
    x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, moe.decode(p, x2))


def test_gloo_cuda_collective_forms_equal_the_cpu_group(card, tmp_path):
    rs = np.random.RandomState(0)
    x = rs.randn(4, 8).astype(np.float32)
    x[2, 3] = x[0, 3] = 7.0
    kw = dict(x=x, y=rs.randn(4, 8).astype(np.float32),
              c=rs.randn(2, 8).astype(np.float32))
    on_card = D.run_ranks(D.collective_grad_ops, 2, tmp_path / "cuda",
                          device="cuda", backend="gloo",
                          mesh_axes={"seq": 2}, tensors="cuda", **kw)
    on_cpu = D.run_ranks(D.collective_grad_ops, 2, tmp_path / "cpu",
                         mesh_axes={"seq": 2}, **kw)
    for a, b in zip(on_card, on_cpu):
        assert dict(a["rules"].tolist())["ppermute"] == "host_send_recv"
        assert dict(a["rules"].tolist())["all_to_all"] == "host_all_to_all"
        for key in a:
            if not key.endswith("_seq"):
                continue
            if key == "pvary_seq":   # torch.sum on the card adds in its
                np.testing.assert_allclose(a[key], b[key], rtol=1e-6,
                                           err_msg=key)   # own order
            else:                    # moved bytes, or sums of two terms
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
