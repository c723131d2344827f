"""The serving engine's programs as CUDA graphs on an NVIDIA card (marker
``cuda``).

A small LM (2 layers, width 256, 2 heads of 128: the decode kernel's head
dim) served dense, paged and speculatively, fp32: the captured run's
streams equal the same requests' under ``programs.eager()`` token for
token, a run after ``warmup()`` captures nothing, the wrappers' launch
counts under replay equal the eager run's, and a program whose body
synchronizes raises at capture instead of running eagerly. Without a card
every test here skips. On a machine with one::

    python -m pytest --noconftest -m cuda \
        tests/test_torch_serve_graphs_cuda.py -q
"""

import pytest
import torch

from apex_tpu_torch.models import TransformerLM
from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                  draft_from_prefix, poisson_requests)
from apex_tpu_torch.serve import programs
from apex_tpu_torch.serve.programs import DeviceProgram, counted_wrappers

pytestmark = pytest.mark.cuda

V = 512
ENGINE = dict(slots=4, max_len=128, prefill_chunk=16)
KINDS = {"dense": {}, "paged": dict(paged=True, page_size=16, kv_pages=20),
         "spec": "spec", "spec_paged": "spec_paged",
         "serial": dict(fused=False)}


@pytest.fixture(scope="module")
def lm():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TransformerLM(vocab_size=V, max_seq_len=128, embed_dim=256,
                          num_heads=2, num_layers=2)
    return model, model.init(torch.Generator().manual_seed(0))


def _engine(lm, kind):
    model, params = lm
    kw = KINDS[kind]
    if isinstance(kw, str):
        kw = dict(spec_k=3, draft=draft_from_prefix(model, params, 1))
        if kind == "spec_paged":
            kw.update(paged=True, page_size=16, kv_pages=20)
    return ContinuousBatchingEngine(model, params, **ENGINE, **kw)


def _requests():
    return poisson_requests(12, rate=0.0, prompt_dist="uniform:4,40",
                            new_dist="uniform:2,24", vocab_size=V, seed=0,
                            max_len=128, prefill_chunk=16)


def _counts():
    return {fn.__name__: fn.launches for fn in counted_wrappers()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_graph_streams_equal_eager_and_warmup_freezes_captures(lm, kind):
    eng = _engine(lm, kind)
    eng.warmup()
    captured = {n: p.captures for n, p in eng.programs.items()}
    assert all(n == 1 for n in captured.values()), captured
    reqs = _requests()
    before = _counts()
    got, stats = eng.run(reqs)
    torch.cuda.synchronize()
    graph_counts = {k: n - before[k] for k, n in _counts().items()}
    assert {n: p.captures for n, p in eng.programs.items()} == captured
    replayed = {n: p.launches for n, p in eng.programs.items()}
    with programs.eager():
        before = _counts()
        want, estats = eng.run(reqs)
        torch.cuda.synchronize()
        eager_counts = {k: n - before[k] for k, n in _counts().items()}
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert {n: p.captures for n, p in eng.programs.items()} == captured
    # a replay launches what the eager body launches, program by program;
    # at rate 0 the schedules are the same, so the runs' counts are too
    assert {n: p.eager_launches for n, p in eng.programs.items()} \
        == replayed
    assert stats["decode_steps"] == estats["decode_steps"]
    assert graph_counts == eager_counts
    assert graph_counts["ln_fwd"] > 0
    if kind.startswith("spec"):
        assert stats["spec_accept_hist"] == estats["spec_accept_hist"]


def test_a_run_without_warmup_captures_at_first_use(lm):
    eng = _engine(lm, "dense")
    reqs = _requests()
    a, _ = eng.run(reqs)
    assert all(p.captures == 1 for p in eng.programs.values())
    b, _ = eng.run(reqs)
    assert all(p.captures == 1 for p in eng.programs.values())
    assert [r.tokens for r in a] == [r.tokens for r in b]


def test_a_body_that_synchronizes_raises_at_capture(lm):
    dev = torch.device("cuda")
    x = torch.ones(4, device=dev)

    def body():
        y = x * 2
        if y.sum().item() > 0:          # a host read: a sync
            y = y + 1
        return y

    prog = DeviceProgram("sync", body, device=dev)
    with pytest.raises(RuntimeError):
        prog()
    assert prog.captures == 0
    torch.cuda.synchronize()
    # the card still serves after the failed capture
    assert torch.equal(x * 2, torch.full((4,), 2.0, device=dev))
