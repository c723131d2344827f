#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
nonzero, and only a run where every phase passed prints the last line,
``{"ok": true, "device": {...}}``. Phases 0-5 are the serving slice,
phases 6-8 the ResNet training slice, phases 9-10 the LM training slice,
phases 11-13 the ImageNet example's slice, phases 14-16 the Seq2Seq
Transformer's, phases 17-19 gradient accumulation and the fp16_utils path
on the LM:

0. device — needs CUDA; prints the card's ``nvidia-smi`` name and power
   limit (also as a raw line of its own) and the torch / CUDA versions.
1. build — compiles the hand kernels from ``apex_tpu_torch/ops/cuda/csrc``
   with ``nvcc`` for ``sm_90a`` (all sources at once) and loads them.
2. kernels — each kernel against its plain PyTorch version on the card,
   at its path's shapes: max abs error against the stated tolerance, the
   kernel's time, the plain version's, one PyTorch library call's where
   one computes the same function, the least time the card could take
   (the bound), and the host time of one wrapper call (``host_us``; the
   eager steps are host-bound). Serving kernels in bf16 and f32; the
   training kernels (``scale``, ``lamb_phase1``, ``lamb_phase2``) over a
   flat buffer of RN50's size T = 25,558,016, fp32 (and bf16 for
   ``scale``), with the overflow flag for an inf at the first, a middle
   and the last element, and two LAMB runs compared bit for bit; the BN
   kernels (``bn_moments``, ``bn_backward_fused_reduce``,
   ``bn_backward_dx``) at every distinct ``[N·H·W, C]`` bf16 shape of the
   RN50 step's 53 BNs, their times also summed over the step; the LM
   step's kernels at its shapes: ``adam`` over the LM's flat fp32 master
   store (T = 138,520,576; bit-equal), ``ln_bwd`` over [32760, 1024] bf16
   rows (dx within one bf16 ulp, the column sums within 1e-5 of each
   column's Σ|terms|, two runs bit-equal), and the flash kernels
   (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) over [128, 4095,
   64] bf16, causal (held against the plain versions on the first 8
   heads, element by element: o, dq, dk and dv within 2 bf16 ulps plus
   2^-6 of the row's RMS over D, lse within 1e-3; and the rule must
   refuse the plain result with its later half 5% off); the ImageNet
   step's optimizer kernels over RN50's flat fp32 buffer: ``rowsumsq``
   (within 1e-5 relative of the plain version; beside it the whole
   per-tensor L2 norm and ``torch._foreach_norm`` over the 161 tensors),
   ``rowmaxabs`` (exact), ``sgd`` at main_amp's flags (bit-equal; every
   flag combination bit-equal at a small size) and ``novograd``
   (bit-equal; its whole step at L2 and L-inf norms); the translation
   step's kernels: ``xent_fwd`` and ``xent_bwd`` over its fp32 logits
   [16512, 37000] at label smoothing 0.1 (loss and lse within 1e-5
   relative, dx bit-equal, two runs bit-equal;
   ``F.cross_entropy`` and its backward beside them) and the three flash
   kernels with the source's key-padding ``kv_bias`` at the encoder's
   [1024, 128, 64] and the cross-attention's (Sq 129, Sk 128) shapes,
   bf16, every head under the flash rule, masked keys getting exactly no
   gradient (SDPA with the additive mask broadcast from [B, 1, 1, Sk]
   beside them); the accumulation and fp16_utils kernels over the LM's
   flat fp32 master store: ``axpby`` as ``unscale_with_stashed`` calls it
   (bit-equal in all three flag modes; an inf or NaN at the first, a
   middle and the last element of x and then of y flagged exactly when
   the mode checks that input; ``torch.add`` with alpha beside it),
   ``l2norm`` (within 1e-5 relative, two runs bit-equal;
   ``linalg.vector_norm`` beside it) and ``adagrad`` (bit-equal in both
   weight-decay modes at wd 1e-2; ``torch.optim.Adagrad`` fused or
   foreach beside it); and impl="auto"'s crossover: the flash path and
   the plain composed attention at [128, S, 64] bf16 for S 128-4096,
   forward and forward + backward, causal and not (SDPA beside them), the
   kernels required to win at every S from ``DEFAULT_FLASH_MIN_S``.
3. dense — the serve_bench model at full width (8 layers, 1024 wide,
   8 heads, vocab 32768, bf16, random weights from ``torch.Generator``
   seed 0) behind ``ContinuousBatchingEngine(slots=8, max_len=1024,
   prefill_chunk=32)`` serving serve_bench's default traffic (32 Poisson
   requests at 8/s, prompts uniform 16-96, outputs uniform 8-48, seed 0).
   Kernel launch counts are zeroed just before and read just after.
4. paged — the same requests on the paged arena (page 32, half the pages
   of the dense reservation); token streams must equal phase 3's.
5. crosscheck — a 2-layer f32 model at the same widths: prefill hidden
   states and first decode-step logits (dense and paged) with the kernels
   against ``dispatch.backend("reference")`` on the card, atol 1e-4.
6. train — the RN50 AMP O2 FusedLAMB step of ``bench.py`` at full width
   (ResNet-50, 1000 classes, random weights from ``torch.Generator``
   seed 0) at ``examples/imagenet/main_amp.py``'s ImageNet shape, batch
   256 at 224×224, bf16, static loss scale 1.0, ``FusedLAMB(lr=1e-3)``,
   the same numpy batch every step (``bench.py:1269-1271``): 3 warm-up
   steps, then 10 timed steps (CUDA events per step, one synchronize
   around the window): img/s, step ms p50/p95, MFU against the H100's
   989 TFLOP/s bf16 dense peak, peak memory, first and last loss (finite
   and falling), one launch of ``scale`` and of each LAMB phase per step
   and one of each BN kernel per BN per step (53). Then two steps under
   ``torch.profiler``: device time by kernel family and the device's idle
   share.
7. overflow — the CI-size ResNet (``bench.py:1248``) under fp16 O2 with a
   dynamic scale: an inf written into one flat grad element before the
   unscale skips the step (masters, slots and step bitwise unchanged) and
   halves the scale 65536 -> 32768; a clean step after it advances.
8. train_crosscheck — the CI-size ResNet, three steps with the kernels
   against ``dispatch.backend("reference")`` with ``cudnn.deterministic``:
   in f32 O0 the masters within atol 5e-5 and the update within 1e-3 of
   its L2 norm; in bf16 O2 within 1.5 times bf16's own effect on them.
9. lm_train — ``tools/lm_bench.py``'s step at its defaults on one card
   (TransformerLM: vocab 32768, 8 layers, 1024 wide, 16 heads of 64,
   attention "fast", fused head in vocab chunks of 8192; random weights
   from ``torch.Generator`` seed 0; batch 8 × 4096 tokens, one numpy
   batch reused every step; O2 bf16 over fp32 flat masters,
   ``FusedAdam(lr=1e-4)``): 3 warm-up and 10 timed steps: tok/s
   (lm_bench's count, batch × 4096 a step), step ms p50/p95, MFU with
   lm_bench's FLOP model (6·P·tokens + 6·L·d·S²·B) against 989 TFLOP/s,
   peak memory, first and last loss (finite and falling), each kernel's
   launches per step (8 of each flash kernel, 17 of each LayerNorm
   kernel, one Adam); then two steps under ``torch.profiler``.
10. lm_crosscheck — a small LM (2 layers, embed 128, 2 heads of 64,
    vocab 512, S 257, batch 2), three O2 steps with the kernels against
    ``dispatch.backend("reference")`` (``adam_crosscheck``): step 1's
    flat gradient within 1.5 times bf16's own effect on it in mean and
    max, the masters after 3 steps so in mean (those with a
    rounding-level gradient left out: Adam moves them by about lr in
    every run); two kernel runs equal bit for bit.
11. imagenet_train — ``examples/imagenet/main_amp.py``'s step at its
    defaults on one card, at phase 6's full width and batch (ResNet-50,
    batch 256 at 224×224, so img/s compares with the LAMB step; main_amp's
    batch 64 is a CPU-smoke default): O2 bf16 (static scale 1.0),
    ``FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)``, one uint8 NHWC
    batch from ``np.random.RandomState(0)`` center-cropped from a 232×232
    pool (main_amp.py:367-370) and normalized inside the step: 3 warm-up
    and 10 timed steps, as phase 6 reads them; one ``sgd`` and one
    ``scale`` launch a step and one of each BN kernel per BN; losses
    finite, the first three falling and none above 4 times the first
    (main_amp's lr 0.1 has no warm-up, so on one repeated batch the step
    overshoots after a few steps); then two profiled steps, one
    ``evaluate`` (top-1, top-5), and the witness: the same 13 steps from
    the same init under the plain versions, whose first 4 losses must be
    within 1e-2 relative of the kernel path's and whose last must be 1.25
    times its least (the overshoot is the step's, not the kernels').
12. imagenet_larc, imagenet_novograd — the same step under
    ``LARC(FusedSGD)`` (two ``rowsumsq`` launches a step) and under
    ``FusedNovoGrad(lr=1e-2)`` with L2 norms (one ``rowsumsq``) and
    L-inf norms (one ``rowmaxabs``), one ``novograd`` a step: 3 warm-up
    and 5 timed steps each; losses finite and the last below the
    first.
13. imagenet_crosscheck — the CI-size ResNet on a uint8 batch, three
    steps with the kernels against ``dispatch.backend("reference")``
    for FusedSGD, LARC and FusedNovoGrad (L2 and L-inf), at O0 and O2,
    with phase 8's bars (O2 losses within 5e-3 or 1.5 times bf16's own
    effect on them, whichever is larger: at lr 0.1 a rounding moves the
    next loss further than LAMB's lr 1e-3 does); two kernel runs equal
    bit for bit, none launched in the plain runs.
14. seq2seq_train — ``examples/seq2seq/train_translation.py``'s step at
    Transformer-base width on one card (``Seq2SeqTransformer``: 6 + 6
    layers, 512 wide, 8 heads of 64, FFN 2048, shared vocabulary 37000,
    attention "fast", dropout 0; random weights from ``torch.Generator``
    seed 0): its make_batch at batch 128 × 128 (sources 64-128 tokens,
    padded; ``RandomState(0)``), O2 bf16 over fp32 flat masters through
    ``LMTrainer``, label smoothing 0.1, ``FusedAdam(5e-4, (0.9, 0.98),
    1e-9)``: 3 warm-up and 10 timed steps: target tokens a second (the
    non-pad targets, fairseq's wps) and all token slots a second, step ms
    p50/p95, MFU from an analytic FLOP count (``s2s_flops``) against 989
    TFLOP/s, peak memory, each kernel's launches a step (one of each xent
    kernel, 18 of each flash kernel, 32 of each LayerNorm kernel, one
    Adam), two profiled steps; losses finite, the first near ln 37000,
    the first three falling; the plain witness (3 steps from the same
    init under the plain versions, no kernel launched, losses within 1e-4
    relative of the kernel path's).
15. seq2seq_decode — ``greedy_decode`` of 8 held-out sources
    (``RandomState(1234)``) to 130 tokens with the trained masters in
    bf16: decoded tokens a second; BOS first and only PAD after EOS; the
    first step's logits within atol 1e-2 of the plain versions' on the
    same encoder memory, and through the whole path (the encoder's flash
    kernels too) within 2 bf16 ulps of the largest logit; the plain
    path's greedy streams decoded beside them and their agreement
    reported.
16. seq2seq_crosscheck — a small Seq2Seq Transformer (2 + 2 layers,
    embed 256, 4 heads of 64, vocab 1000, source length 64, batch 8,
    ragged), phase 10's ``adam_crosscheck`` with the translation step's
    Adam and label smoothing.
17. lm_accum — ``examples/lm/train_ring.py``'s accumulation
    (``--grad-accum 2 --loss-scale dynamic``) on phase 9's model and batch
    through ``LMTrainer(microbatches=2, loss_scale="dynamic")``: step 1's
    accumulated flat grad within 1.5 times bf16's own effect (the
    one-batch grad against the plain fp32 one) of phase 9's one-batch
    grad from the same masters, in mean and max; 3 warm-up and 10 timed
    steps as phase 9 reads them (tok/s, step ms, MFU with phase 9's FLOP
    model, peak memory, below phase 9's), 2 ``axpby`` and 1 Adam launches
    a step and each model kernel twice phase 9's; losses finite, the
    first three falling; an inf in microbatch 2 alone leaves masters,
    slots and step bit for bit, halves the scale, counts one overflow.
18. fp16opt_adagrad — the legacy path on the same model and batch:
    ``FP16_Optimizer(FusedAdagrad(lr=1e-4, model_dtype=bf16),
    dynamic_loss_scale=True)``, each step the grads of the scaled loss
    with respect to the bf16 param tree, ``clip_master_grads(1.0)`` and
    ``step``: 3 warm-up and 5 timed steps (tok/s, step ms, each step's
    norm and clip coefficient, the norm within 1e-5 of the plain
    version's on the same grads); 1 ``l2norm``, 1 ``adagrad`` and 1 +
    leaves ``scale`` launches a step; losses finite and falling; an inf
    in one leaf's grad skips the step and ``last_culprits`` names it.
19. fp16opt_crosscheck — phase 10's small LM at batch 4 under
    ``crosscheck`` (phase 10's bars): ``LMTrainer(microbatches=2,
    loss_scale="dynamic")``, and ``FP16_Optimizer(FusedAdagrad)`` with
    clipping in both weight-decay modes.
20. the ``{"kernels": [...]}`` line (23 kernels), then the ``ok`` line.

Times are CUDA-event medians of single calls with the L2 cache flushed
before each and the stream held busy, so host launch time is not counted.
Bounds use the H100 SXM's published 3.35 TB/s and 67 TFLOP/s (fp32,
outside the tensor cores), and 989 TFLOP/s bf16 dense for the flash
kernels' products; MFU its 989 TFLOP/s bf16 dense.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
BF16_DENSE_OPS_S = 989e12

TOL = {"float32": (1e-5, 1e-5),        # atol, rtol: order of fp32 sums
       "bfloat16": (1e-2, 1e-2)}       # one bf16 rounding of the output


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_table(log: str) -> dict:
    """Registers a thread and spill bytes of each kernel of the build, by
    its mangled name, from ptxas's report."""
    table, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            name = m.group(1)
        elif name and (regs or spill):
            table.setdefault(name, {})[
                "registers" if regs else "spill_bytes"] = int(
                    (regs or spill).group(1))
    return table


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# -- timing --------------------------------------------------------------

class Timer:
    """Median GPU time of one call: an L2-sized buffer is cleared before
    each call (the serving path finds K/V cold: seven other layers run in
    between), and a sleep kernel keeps the stream busy while the host
    enqueues the timed call."""

    def __init__(self, torch, reps: int = 25):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(256 << 20, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def host_us(torch, fn, n: int = 500) -> float:
    """Host time of one call (enqueue only), microseconds: the cost a
    host-bound eager loop pays per call."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def max_err(got, want, dtype_name: str):
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_S):
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``ops`` operations at ``ops_per_s`` (fp32 outside the tensor cores
    unless the work is bf16 tensor-core products), and which one binds."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -- phase 2: each kernel against its plain version -------------------------

def kernel_phase(torch, timer):
    import torch.nn.functional as F

    from apex_tpu_torch.ops import decode_attn as DA
    from apex_tpu_torch.ops import layer_norm as LN

    gen = torch.Generator(device="cuda").manual_seed(1)
    S, H, HD, L, PAGE = 8, 8, 128, 1024, 32
    max_pages = L // PAGE
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        es = torch.tensor([], dtype=dt).element_size()
        lengths = torch.tensor([1, 1024, 17, 300, 512, 77, 999, 640],
                               dtype=torch.int32, device="cuda")
        q = torch.randn(S, H, HD, generator=gen, device="cuda").to(dt)
        k = torch.randn(S, H, L, HD, generator=gen, device="cuda").to(dt)
        v = torch.randn(S, H, L, HD, generator=gen, device="cuda").to(dt)
        lens = lengths.tolist()
        kv_bytes = sum(2 * n * H * HD * es for n in lens)
        io_bytes = 2 * S * H * HD * es + 4 * S
        ops = sum(n * H * (4 * HD + 5) for n in lens)

        # dense
        got = DA.decode_attention(q, k, v, lengths)
        want = DA.decode_attention_plain(q, k, v, lengths)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, name)
        check(ok, f"decode_attention {name}: max abs err {err}")
        mask = (torch.arange(L, device="cuda")[None, None, None, :]
                < lengths[:, None, None, None])
        b_ms, b_by = bound(kv_bytes + io_bytes, ops)
        row = dict(
            kernel="decode_attention", dtype=name, shape=[S, H, L, HD],
            lengths=lens, max_abs_err=err, tol=TOL[name],
            ms=timer(lambda: DA.decode_attention(q, k, v, lengths)),
            plain_ms=timer(lambda: DA.decode_attention_plain(q, k, v,
                                                             lengths)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], k, v, attn_mask=mask)),
            bound_ms=b_ms, bound_by=b_by,
            host_us=host_us(torch, lambda: DA.decode_attention(
                q, k, v, lengths)),
            library_host_us=host_us(
                torch, lambda: F.scaled_dot_product_attention(
                    q[:, :, None, :], k, v, attn_mask=mask)))
        emit({"phase": "kernels", **row})
        rows[("decode_attention", name)] = row

        # paged: the same logical K/V behind a shuffled page table; the
        # unmapped entries point at the null page 0, which holds garbage
        n_phys = 1 + S * max_pages
        perm = torch.randperm(n_phys - 1, generator=gen,
                              device="cuda").to(torch.int32) + 1
        table = torch.zeros(S, max_pages, dtype=torch.int32, device="cuda")
        kp = torch.full((n_phys, H, PAGE, HD), 30.0, device="cuda").to(dt)
        vp = torch.full((n_phys, H, PAGE, HD), -30.0, device="cuda").to(dt)
        nxt = 0
        for s, n in enumerate(lens):
            for lp in range(-(-n // PAGE)):
                phys = int(perm[nxt])
                nxt += 1
                table[s, lp] = phys
                kp[phys] = k[s, :, lp * PAGE:(lp + 1) * PAGE]
                vp[phys] = v[s, :, lp * PAGE:(lp + 1) * PAGE]
        pages_read = sum(-(-n // PAGE) for n in lens)
        got_p = DA.paged_decode_attention(q, kp, vp, lengths,
                                          page_table=table)
        want_p = DA.paged_decode_attention_plain(q, kp, vp, lengths,
                                                 page_table=table)
        torch.cuda.synchronize()
        err, ok = max_err(got_p, want_p, name)
        check(ok, f"paged_decode_attention {name}: max abs err {err}")
        # one kernel body for both arenas: paged == dense, bit for bit
        check(torch.equal(got_p, got),
              f"paged_decode_attention {name} differs from the dense "
              f"kernel on the same bytes")
        b_ms, b_by = bound(kv_bytes + io_bytes + 4 * pages_read, ops)
        row = dict(
            kernel="paged_decode_attention", dtype=name,
            shape=[n_phys, H, PAGE, HD], lengths=lens, max_abs_err=err,
            tol=TOL[name],
            ms=timer(lambda: DA.paged_decode_attention(
                q, kp, vp, lengths, page_table=table)),
            plain_ms=timer(lambda: DA.paged_decode_attention_plain(
                q, kp, vp, lengths, page_table=table)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            host_us=host_us(torch, lambda: DA.paged_decode_attention(
                q, kp, vp, lengths, page_table=table)))
        emit({"phase": "kernels", **row})
        rows[("paged_decode_attention", name)] = row

        # LayerNorm: the decode step's rows (S) and a prefill chunk's
        # (S * 32), F = 1024, gamma/beta in the model's dtype
        for n_rows in (8, 256):
            f = 1024
            x = (torch.randn(n_rows, f, generator=gen, device="cuda") * 3
                 + 0.5).to(dt)
            w = (torch.randn(f, generator=gen, device="cuda") + 1).to(dt)
            b = torch.randn(f, generator=gen, device="cuda").to(dt)
            y, mean, inv = LN.ln_fwd(x, w, b, 1e-5)
            y0, mean0, inv0 = LN.ln_fwd_plain(x, w, b, 1e-5)
            torch.cuda.synchronize()
            err, ok = max_err(y, y0, name)
            check(ok, f"ln_fwd {name} rows={n_rows}: y max abs err {err}")
            for t, t0, what in ((mean, mean0, "mean"), (inv, inv0, "inv")):
                e, ok = max_err(t, t0, "float32")
                check(ok, f"ln_fwd {name} rows={n_rows}: {what} err {e}")
            b_ms, b_by = bound(n_rows * f * 2 * es + 2 * f * es
                               + 8 * n_rows, 8 * n_rows * f)
            row = dict(
                kernel="ln_fwd", dtype=name, shape=[n_rows, f],
                max_abs_err=err, tol=TOL[name],
                ms=timer(lambda: LN.ln_fwd(x, w, b, 1e-5)),
                plain_ms=timer(lambda: LN.ln_fwd_plain(x, w, b, 1e-5)),
                library_ms=timer(lambda: F.layer_norm(x, (f,), w, b,
                                                      1e-5)),
                bound_ms=b_ms, bound_by=b_by,
                host_us=host_us(torch, lambda: LN.ln_fwd(x, w, b, 1e-5)),
                library_host_us=host_us(
                    torch, lambda: F.layer_norm(x, (f,), w, b, 1e-5)))
            emit({"phase": "kernels", **row})
            rows[("ln_fwd", name, n_rows)] = row
    return rows


# -- phase 2, training kernels: scale and the two LAMB phases -----------------

def train_kernel_phase(torch, timer, table):
    """The training kernels over a flat buffer laid out by ``table`` (the
    RN50 master store), fp32 (and bf16 for scale)."""
    from apex_tpu_torch.ops import multi_tensor as MT

    gen = torch.Generator(device="cuda").manual_seed(4)
    T, R, S = table.total, table.total // 128, table.num_segments
    valid = table.valid_mask("cuda")
    rows = {}

    def randn(scale=1.0):
        return torch.randn(T, generator=gen, device="cuda") * scale * valid

    # scale: the unscale of a flat fp32 (and bf16) grad
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        es = torch.tensor([], dtype=dt).element_size()
        x = randn().to(dt)
        s = torch.full((), 0.3, device="cuda")
        got, inf = MT.scale(x, s)
        want, inf0 = MT.scale_plain(x, s)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, name)
        check(ok and not bool(inf) and not bool(inf0),
              f"scale {name}: max abs err {err}, flags {bool(inf)}, "
              f"{bool(inf0)}")
        flags = {}
        for where, pos in (("first", 0), ("middle", T // 2),
                           ("last", T - 1)):
            y = x.clone()
            y[pos] = float("inf")
            flags[where] = bool(MT.scale(y, s)[1])
        check(all(flags.values()), f"scale {name}: inf not flagged {flags}")
        lib = x.clone()
        found = torch.zeros(1, device="cuda")
        b_ms, b_by = bound(2 * T * es + 8, 2 * T)
        row = dict(
            kernel="scale", dtype=name, shape=[T], max_abs_err=err, tol=0.0,
            bitwise=bool(torch.equal(got, want)), inf_flags=flags,
            ms=timer(lambda: MT.scale(x, s)),
            plain_ms=timer(lambda: MT.scale_plain(x, s)),
            # the library call takes fp32, fp16 and fp64 only
            library_ms=timer(
                lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                    [lib], found, s)) if dt == torch.float32 else None,
            bound_ms=b_ms, bound_by=b_by,
            host_us=host_us(torch, lambda: MT.scale(x, s)))
        check(err == 0.0, f"scale {name}: not exact ({err})")
        emit({"phase": "kernels", **row})
        rows[("scale", name)] = row

    # LAMB at FusedLAMB's defaults, step 3, decoupled weight decay
    g, p, m = randn(), randn(0.05), randn(0.01)
    v = randn(0.001).abs()
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    gnorm = torch.linalg.vector_norm(g)
    sc = MT.lamb_scalars(beta1=0.9, beta2=0.999, eps=1e-6, step=step,
                         bias_correction=True, weight_decay=0.01,
                         grad_averaging=True, global_grad_norm=gnorm,
                         max_grad_norm=1.0, device="cuda")
    got = MT.lamb_phase1(g, p, m, v, sc, 1)
    want = MT.lamb_phase1_plain(g, p, m, v, sc, 1)
    torch.cuda.synchronize()
    errs = {}
    for what, a, b in zip(("u", "m", "v", "prow", "urow"), got, want):
        errs[what], ok = max_err(a, b, "float32")
        check(ok, f"lamb_phase1 {what}: max abs err {errs[what]}")
    b_ms, b_by = bound(28 * T + 8 * R + 36, 20 * T)
    row = dict(
        kernel="lamb_phase1", dtype="float32", shape=[T], max_abs_err=max(
            errs.values()), errs=errs, tol=TOL["float32"],
        bitwise_umv=all(bool(torch.equal(a, b))
                        for a, b in zip(got[:3], want[:3])),
        ms=timer(lambda: MT.lamb_phase1(g, p, m, v, sc, 1)),
        plain_ms=timer(lambda: MT.lamb_phase1_plain(g, p, m, v, sc, 1)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        host_us=host_us(torch, lambda: MT.lamb_phase1(g, p, m, v, sc, 1)))
    emit({"phase": "kernels", **row})
    rows[("lamb_phase1", "float32")] = row

    u = got[0]
    ratio = torch.rand(S, generator=gen, device="cuda") * 1e-3
    row_seg = table.row_segment_ids("cuda")
    got2 = MT.lamb_phase2(p, u, ratio, row_seg)
    want2 = MT.lamb_phase2_plain(p, u, ratio, row_seg)
    torch.cuda.synchronize()
    err, ok = max_err(got2, want2, "float32")
    check(ok, f"lamb_phase2: max abs err {err}")
    row_ratio = ratio[row_seg.long()][:, None]
    p2, u2 = p.view(R, 128), u.view(R, 128)
    b_ms, b_by = bound(12 * T + 4 * R + 4 * S, 2 * T)
    row = dict(
        kernel="lamb_phase2", dtype="float32", shape=[T], max_abs_err=err,
        tol=TOL["float32"], bitwise=bool(torch.equal(got2, want2)),
        ms=timer(lambda: MT.lamb_phase2(p, u, ratio, row_seg)),
        plain_ms=timer(lambda: MT.lamb_phase2_plain(p, u, ratio, row_seg)),
        library_ms=timer(lambda: torch.addcmul(p2, row_ratio, u2,
                                               value=-1)),
        bound_ms=b_ms, bound_by=b_by,
        host_us=host_us(torch, lambda: MT.lamb_phase2(p, u, ratio,
                                                      row_seg)))
    emit({"phase": "kernels", **row})
    rows[("lamb_phase2", "float32")] = row

    # the whole two-phase step twice on the same inputs: bit for bit
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, step=step,
              weight_decay=0.01, mode=1, global_grad_norm=gnorm,
              max_grad_norm=1.0)
    a = MT.lamb_step(g, p, m, v, table, **kw)
    b = MT.lamb_step(g, p, m, v, table, **kw)
    same = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
    emit({"phase": "kernels", "kernel": "lamb_step", "repeat_equal": same})
    check(same, "lamb_step: two runs on the same inputs differ")
    return rows


# -- phase 2, BatchNorm kernels: the welford passes at RN50's BN shapes -------

def rn50_bn_calls(model, batch: int, image: int) -> dict:
    """The training step's BN calls as ``{(rows, C, relu, z): count}``,
    walked like the model's ``apply`` (53 for ResNet-50)."""
    def up(n, s):
        return -(-n // s)

    calls = {}

    def add(h, c, relu, z):
        key = (batch * h * h, c, relu, z)
        calls[key] = calls.get(key, 0) + 1

    h = up(image, 2)
    add(h, model.width, True, False)                 # the stem
    h = up(h, 2)                                     # max pool
    cin = model.width
    for s, nblocks in enumerate(model.block_sizes):
        cmid = model.width * (2 ** s)
        cout = cmid * model.expansion
        for b in range(nblocks):
            stride = 2 if (s > 0 and b == 0) else 1
            hout = up(h, stride)
            if b == 0 and (stride != 1 or cin != cout):
                add(hout, cout, False, False)        # the projection
            add(h, cmid, True, False)                # bn1, before the stride
            add(hout, cmid, True, False)
            add(hout, cout, True, True)              # residual and relu
            cin, h = cout, hout
    return calls


def welford_kernel_phase(torch, timer, calls) -> dict:
    """Each welford pass against its plain version at every distinct BN
    shape of the RN50 step (bf16 rows), and one PyTorch library call that
    computes the same per-channel function (without the relu mask); the
    kernels line takes each time summed over the step's 53 BNs."""
    from apex_tpu_torch.ops import welford as WF

    gen = torch.Generator(device="cuda").manual_seed(6)
    es = 2
    totals = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      bound_bytes=0.0, bound_ops=0.0, max_abs_err=0.0,
                      calls=0) for k in ("bn_moments",
                                         "bn_backward_fused_reduce",
                                         "bn_backward_dx")}

    def close_sums(got, want, terms, what):
        bound_ = 1e-5 * terms.abs().sum(0) + 1e-6
        err = (got - want).abs()
        check(bool((err <= bound_).all()),
              f"{what}: sums off by {float((err / bound_).max())} of the "
              f"1e-5·Σ|terms| bound")
        return float(err.max())

    for (rows, c, relu, has_z), n in sorted(calls.items()):
        x = (torch.randn(rows, c, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        dy = torch.randn(rows, c, generator=gen, device="cuda").to(
            torch.bfloat16)
        out = torch.relu(torch.randn(rows, c, generator=gen,
                                     device="cuda")).to(torch.bfloat16) \
            if relu else None
        s0, sq0 = WF.bn_moments_plain(x)
        mean = s0 / rows
        invvar = torch.rsqrt(sq0 / rows - mean * mean + 1e-5)
        weight = torch.rand(c, generator=gen, device="cuda") + 0.5
        count = torch.full((1,), rows, dtype=torch.int32, device="cuda")
        shape = dict(rows=rows, C=c, relu=relu, z=has_z, per_step=n)

        # moments
        s, sq = WF.bn_moments(x)
        xf = x.float()
        err = max(close_sums(s, s0, xf, f"bn_moments {shape}"),
                  close_sums(sq, sq0, xf * xf, f"bn_moments {shape}"))
        del xf
        rec = dict(kernel="bn_moments", max_abs_err=err,
                   repeat_equal=bool(torch.equal(WF.bn_moments(x)[1], sq)),
                   ms=timer(lambda: WF.bn_moments(x)),
                   plain_ms=timer(lambda: WF.bn_moments_plain(x)),
                   library_ms=timer(lambda: torch.batch_norm_stats(x, 1e-5)),
                   bytes=rows * c * es + 8 * c, ops=3 * rows * c)
        check(rec["repeat_equal"], f"bn_moments {shape}: runs differ")
        recs = [rec]

        # backward reduce
        sd, sx = WF.bn_backward_fused_reduce(dy, x, mean, invvar, out)
        sd0, sx0 = WF.bn_backward_fused_reduce_plain(dy, x, mean, invvar,
                                                     out)
        dyf = WF._masked_dy(dy, out)
        err = max(close_sums(sd, sd0, dyf, f"bn_backward_fused_reduce "
                                           f"{shape}"),
                  close_sums(sx, sx0, dyf * ((x.float() - mean) * invvar),
                             f"bn_backward_fused_reduce {shape}"))
        del dyf
        streams = 3 if relu else 2
        recs.append(dict(
            kernel="bn_backward_fused_reduce", max_abs_err=err,
            ms=timer(lambda: WF.bn_backward_fused_reduce(dy, x, mean,
                                                         invvar, out)),
            plain_ms=timer(lambda: WF.bn_backward_fused_reduce_plain(
                dy, x, mean, invvar, out)),
            library_ms=timer(lambda: torch.batch_norm_backward_reduce(
                dy, x, mean, invvar, weight, True, True, True)),
            bytes=streams * rows * c * es + 16 * c,
            ops=(7 if relu else 6) * rows * c))

        # backward dx (and dz where the BN carries the residual)
        args = (dy, x, mean, invvar, invvar * weight, sd0 / rows,
                sx0 / rows, out)
        dx, dz = WF.bn_backward_dx(*args, emit_dz=has_z)
        dx0, dz0 = WF.bn_backward_dx_plain(*args, emit_dz=has_z)
        err = float((dx.float() - dx0.float()).abs().max())
        same = bool(torch.equal(dx, dx0)) and (
            not has_z or bool(torch.equal(dz, dz0)))
        check(same, f"bn_backward_dx {shape}: not bit-equal to the plain "
                    f"version (max abs err {err})")
        recs.append(dict(
            kernel="bn_backward_dx", max_abs_err=err, bitwise=same,
            ms=timer(lambda: WF.bn_backward_dx(*args, emit_dz=has_z)),
            plain_ms=timer(lambda: WF.bn_backward_dx_plain(
                *args, emit_dz=has_z)),
            library_ms=timer(lambda: torch.batch_norm_backward_elemt(
                dy, x, mean, invvar, weight, sd0, sx0, count)),
            bytes=(streams + 1 + has_z) * rows * c * es + 20 * c,
            ops=(9 if relu else 8) * rows * c))

        for r in recs:
            b_ms, b_by = bound(r["bytes"], r["ops"])
            r.update(bound_ms=b_ms, bound_by=b_by)
            emit({"phase": "kernels", **r, **shape})
            t = totals[r["kernel"]]
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                t[k] += n * r[k]
            t["bound_bytes"] += n * r["bytes"]
            t["bound_ops"] += n * r["ops"]
            t["max_abs_err"] = max(t["max_abs_err"], r["max_abs_err"])
            t["calls"] += n
        del x, dy, out, dx, dz, dx0, dz0
    out = {}
    for k, t in totals.items():
        b_ms, b_by = bound(t["bound_bytes"], t["bound_ops"])
        row = dict(kernel=k, dtype="bfloat16", per="step of 53 BNs",
                   **{f: t[f] for f in ("ms", "plain_ms", "library_ms",
                                        "max_abs_err", "calls")},
                   bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "kernels", **row})
        out[(k, "bfloat16")] = row
    return out


# -- phase 2, the LM training kernels: Adam, LayerNorm backward, flash --------

LM_SHAPE = dict(batch=8, seq=4096, embed=1024, heads=16, layers=8,
                vocab=32768)
# launches of each kernel in one LM training step: one flash forward, dq
# and dk/dv per layer; two LayerNorms per layer and the final one; Adam
LM_PER_STEP = {"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8,
               "ln_fwd": 17, "ln_bwd": 17, "adam": 1}
FLASH_CHECK_HEADS = 8     # heads held against the plain version


def bf16_ulp(torch, t):
    """The spacing of bf16 values at each element's magnitude."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


# flash outputs: each element within FLASH_ULPS bf16 ulps of itself plus
# FLASH_RMS of its row's RMS over D (a query row of o and dq, a key row of
# dk and dv), a row's RMS taken as at least FLASH_FLOOR of the tensor's
# (rows whose exact value is 0, as dq's first causal row, are rounding
# noise). The kernels round P and dS to bf16 before their second products:
# that error is a share of the row, not of the tensor's largest value.
FLASH_ULPS, FLASH_RMS, FLASH_FLOOR = 2.0, 2.0 ** -6, 2.0 ** -6


def flash_err(torch, got, want) -> dict:
    """``used``: the largest |got - want| over its limit (the check passes
    at <= 1); ``ulps`` and ``rms``: the largest error in bf16 ulps and as a
    share of its row's RMS."""
    a, b = got.float(), want.float()
    err = (a - b).abs()
    ulp = torch.maximum(bf16_ulp(torch, a), bf16_ulp(torch, b))
    rms = torch.clamp(b.pow(2).mean(-1, keepdim=True).sqrt(),
                      min=FLASH_FLOOR * float(b.pow(2).mean().sqrt()))
    lim = FLASH_ULPS * ulp + FLASH_RMS * rms
    return {"max_abs_err": float(err.max()),
            "ulps": float((err / ulp).max()), "rms": float((err / rms).max()),
            "used": float((err / lim).max())}


def lm_kernel_phase(torch, timer, total: int) -> dict:
    """The LM step's new kernels at its shapes: Adam over the flat fp32
    master store (``total`` elements), the LayerNorm backward over
    [B·(S-1), E] bf16 rows, the flash kernels over [B·H, S-1, D] bf16,
    causal. Each against its plain version on the same inputs (the flash
    ones on the first heads, where the plain version's fp32 scores fit),
    with its time, the plain version's over the whole input, one PyTorch
    library call's and the bound."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attn as FA
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops import multi_tensor as MT

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}

    # Adam: lm_bench's FusedAdam(lr=1e-4), AdamW mode, weight decay 0,
    # at step 3; fp32 grad, masters and slots
    T = total
    g = torch.randn(T, generator=gen, device="cuda") * 1e-2
    p = torch.randn(T, generator=gen, device="cuda") * 0.02
    m = torch.randn(T, generator=gen, device="cuda") * 1e-3
    v = torch.rand(T, generator=gen, device="cuda") * 1e-6
    sc = MT.adam_scalars(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                         step=torch.tensor(3, device="cuda"),
                         bias_correction=True, weight_decay=0.0,
                         device="cuda")
    got = MT.adam(g, p, m, v, sc, MT.MODE_DECOUPLED)
    want = MT.adam_plain(g, p, m, v, sc, MT.MODE_DECOUPLED)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(same, f"adam: not bit-equal to the plain version ({err})")
    del got, want
    lib_p = p.clone().requires_grad_(True)
    lib_p.grad = g.clone()
    lib = torch.optim.AdamW([lib_p], lr=1e-4, weight_decay=0.0, fused=True)
    lib.step()                      # creates its state
    b_ms, b_by = bound(28 * T + 36, 16 * T)
    row = dict(kernel="adam", dtype="float32", shape=[T], max_abs_err=err,
               tol=0.0, bitwise=same, per_step=LM_PER_STEP["adam"],
               ms=timer(lambda: MT.adam(g, p, m, v, sc, MT.MODE_DECOUPLED)),
               plain_ms=timer(lambda: MT.adam_plain(g, p, m, v, sc,
                                                    MT.MODE_DECOUPLED)),
               library_ms=timer(lib.step), bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.adam(
                   g, p, m, v, sc, MT.MODE_DECOUPLED)))
    emit({"phase": "kernels", **row})
    rows[("adam", "float32")] = row
    del g, p, m, v, lib, lib_p

    # LayerNorm backward over the step's rows, bf16 with bf16 gamma (the
    # O2 model's params), from the forward kernel's statistics
    n_rows = LM_SHAPE["batch"] * (LM_SHAPE["seq"] - 1)
    f = LM_SHAPE["embed"]
    x = (torch.randn(n_rows, f, generator=gen, device="cuda") * 2
         + 0.5).to(torch.bfloat16)
    dy = torch.randn(n_rows, f, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn(f, generator=gen, device="cuda") + 1).to(torch.bfloat16)
    b = torch.randn(f, generator=gen, device="cuda").to(torch.bfloat16)
    _, mean, inv = LN.ln_fwd(x, w, b, 1e-5)
    dx, gw, gb = LN.ln_bwd(dy, x, w, mean, inv)
    dx0, gw0, gb0 = LN.ln_bwd_plain(dy, x, w, mean, inv)
    torch.cuda.synchronize()
    # dx within one bf16 ulp of its value plus 1e-5 of its terms'
    # magnitude inv·(|dxhat| + |mean(dxhat)| + |xhat·mean(dxhat·xhat)|):
    # the two row means sum in another order, and where the terms cancel
    # that difference is many ulps of a small result. The column sums
    # within 1e-5 of each column's sum of |terms|.
    xhat = (x.float() - mean[:, None]) * inv[:, None]
    dxh = dy.float() * w.float()
    m1 = dxh.mean(1, keepdim=True)
    m2 = (dxh * xhat).mean(1, keepdim=True)
    scale = inv[:, None] * (dxh.abs() + m1.abs() + (xhat * m2).abs())
    lim = torch.maximum(bf16_ulp(torch, dx), bf16_ulp(torch, dx0)) \
        + 1e-5 * scale
    dx_err = (dx.float() - dx0.float()).abs()
    check(bool((dx_err <= lim).all()),
          f"ln_bwd: dx off by {float((dx_err / lim).max())} of its bound")
    ulps = float((dx_err / torch.maximum(bf16_ulp(torch, dx),
                                         bf16_ulp(torch, dx0))).max())
    del dxh, m1, m2, scale, lim
    sums_err = 0.0
    for got_s, want_s, terms in ((gw, gw0, dy.float() * xhat),
                                 (gb, gb0, dy.float())):
        lim = 1e-5 * terms.abs().sum(0) + 1e-6
        e = (got_s - want_s).abs()
        check(bool((e <= lim).all()),
              f"ln_bwd: column sums off by {float((e / lim).max())} of "
              f"1e-5·Σ|terms|")
        sums_err = max(sums_err, float(e.max()))
    del xhat
    again = LN.ln_bwd(dy, x, w, mean, inv)
    repeat = all(bool(torch.equal(a, c)) for a, c in zip((dx, gw, gb),
                                                        again))
    check(repeat, "ln_bwd: two runs on the same inputs differ")
    del again
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [f], w, b, 1e-5)
    es = 2
    b_ms, b_by = bound(3 * n_rows * f * es + 8 * n_rows + f * es + 8 * f,
                       11 * n_rows * f)
    row = dict(kernel="ln_bwd", dtype="bfloat16", shape=[n_rows, f],
               max_abs_err=float(dx_err.max()), max_ulps=ulps,
               sums_max_abs_err=sums_err,
               tol="dx: 1 bf16 ulp + 1e-5 of its terms; sums: 1e-5·Σ|terms|",
               repeat_equal=repeat,
               per_step=LM_PER_STEP["ln_bwd"],
               ms=timer(lambda: LN.ln_bwd(dy, x, w, mean, inv)),
               plain_ms=timer(lambda: LN.ln_bwd_plain(dy, x, w, mean, inv)),
               library_ms=timer(
                   lambda: torch.ops.aten.native_layer_norm_backward(
                       dy, x, [f], lmean, lrstd, w, b, [True, True, True])),
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: LN.ln_bwd(dy, x, w, mean,
                                                        inv)))
    emit({"phase": "kernels", **row})
    rows[("ln_bwd", "bfloat16")] = row
    del x, dy, dx, dx0, dx_err, lmean, lrstd

    # flash attention: [B·H, S-1, D] bf16, causal, the model's scale
    B, H = LM_SHAPE["batch"], LM_SHAPE["heads"]
    S, D = LM_SHAPE["seq"] - 1, LM_SHAPE["embed"] // LM_SHAPE["heads"]
    BH, n = B * H, FLASH_CHECK_HEADS
    kw = dict(causal=True, scale=D ** -0.5)

    def rnd():
        return torch.randn(BH, S, D, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.flash_delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    o0, lse0 = FA.reference_attention(q[:n], k[:n], v[:n], return_lse=True,
                                      **kw)
    dq0, dk0, dv0 = FA.flash_bwd_plain(q[:n], k[:n], v[:n], do[:n], lse[:n],
                                       delta[:n], **kw)
    torch.cuda.synchronize()

    errs = {what: flash_err(torch, a[:n], b0) for what, a, b0 in
            (("o", o, o0), ("dq", dq, dq0), ("dk", dk, dk0), ("dv", dv, dv0))}
    lse_err = float((lse[:n] - lse0).abs().max())
    emit({"phase": "flash_tol", "ulps": FLASH_ULPS, "rms": FLASH_RMS,
          "floor": FLASH_FLOOR, "lse_err": lse_err, **errs})
    check(lse_err <= 1e-3, f"flash lse: max abs err {lse_err} > 1e-3")
    for what, e in errs.items():
        check(e["used"] <= 1.0, f"flash {what}: {e}")
    # the other side: the rule refuses the plain result with its later
    # half 5% off
    late = torch.arange(S, device="cuda")[None, :, None] >= S // 2
    for what, b0 in (("o", o0), ("dq", dq0), ("dk", dk0), ("dv", dv0)):
        off = torch.where(late, b0.float() * 1.05, b0.float())
        check(flash_err(torch, off, b0)["used"] > 1.0,
              f"flash {what}: the limit passes a result 5% off")
    rep = bool(torch.equal(FA.flash_bwd_dkv(q, k, v, do, lse, delta,
                                            **kw)[0], dk))
    check(rep, "flash_bwd_dkv: two runs on the same inputs differ")
    del o0, lse0, dq0, dk0, dv0, late, off
    group = 16

    def plain_fwd():
        # the plain version head group by head group: its fp32 scores for
        # all 128 heads at once would take tens of GB
        for i in range(0, BH, group):
            FA.reference_attention(q[i:i + group], k[i:i + group],
                                   v[i:i + group], return_lse=True, **kw)

    def plain_bwd():
        FA.flash_bwd_plain(q, k, v, do, lse, delta, **kw)

    q4, k4, v4, do4 = (t.view(B, H, S, D) for t in (q, k, v, do))
    ql, kl, vl = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd = timer(lambda: torch.autograd.grad(lo, (ql, kl, vl), do4,
                                                retain_graph=True))
    pairs = BH * S * (S + 1) // 2            # causal (query, key) pairs
    sz = BH * S * D * 2
    common = dict(dtype="bfloat16", shape=[BH, S, D], causal=True,
                  per_step=LM_PER_STEP["flash_fwd"], checked_heads=n)
    b_ms, b_by = bound(4 * sz + 4 * BH * S, 4 * D * pairs, BF16_DENSE_OPS_S)
    tol = (f"{FLASH_ULPS:g} bf16 ulps + {FLASH_RMS:g} of the row's RMS "
           f"(at least {FLASH_FLOOR:g} of the tensor's); lse 1e-3")
    fwd = dict(kernel="flash_fwd", **common,
               max_abs_err=errs["o"]["max_abs_err"],
               tol_used=errs["o"]["used"], tol=tol, lse_err=lse_err,
               ms=timer(lambda: FA.flash_fwd(q, k, v, **kw)),
               plain_ms=timer(plain_fwd),
               library_ms=timer(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, is_causal=True)),
               bound_ms=b_ms, bound_by=b_by)
    plain_bwd_ms = timer(plain_bwd)
    b_ms, b_by = bound(5 * sz + 8 * BH * S, 6 * D * pairs, BF16_DENSE_OPS_S)
    dqr = dict(kernel="flash_bwd_dq", **common,
               max_abs_err=errs["dq"]["max_abs_err"],
               tol_used=errs["dq"]["used"], tol=tol,
               ms=timer(lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta,
                                                **kw)),
               plain_ms=plain_bwd_ms, library_ms=lib_bwd,
               library_covers="dq, dk and dv (one SDPA backward)",
               bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound(6 * sz + 8 * BH * S, 8 * D * pairs, BF16_DENSE_OPS_S)
    dkvr = dict(kernel="flash_bwd_dkv", **common,
                max_abs_err=max(errs["dk"]["max_abs_err"],
                                errs["dv"]["max_abs_err"]),
                tol_used=max(errs["dk"]["used"], errs["dv"]["used"]),
                tol=tol, repeat_equal=rep,
                ms=timer(lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  **kw)),
                plain_ms=plain_bwd_ms, library_ms=lib_bwd,
                library_covers="dq, dk and dv (one SDPA backward)",
                bound_ms=b_ms, bound_by=b_by)
    dqr["plain_covers"] = dkvr["plain_covers"] = \
        "dq, dk and dv (one flash_bwd_plain)"
    for r in (fwd, dqr, dkvr):
        emit({"phase": "kernels", **r})
        rows[(r["kernel"], "bfloat16")] = r
    return rows


# -- phase 2, the ImageNet step's optimizer kernels ---------------------------

# main_amp.py:53-62's FusedSGD: lr 0.1, momentum 0.9, weight decay 1e-4,
# no dampening or nesterov
MAIN_AMP_SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)


def optimizer_kernel_phase(torch, timer, table) -> dict:
    """The per-row norm, SGD and NovoGrad kernels over a flat fp32 buffer
    laid out by ``table`` (the RN50 master store), each against its plain
    version, with its time, the plain version's, one library call's where
    PyTorch has one, and the bound."""
    from apex_tpu_torch.ops import dispatch
    from apex_tpu_torch.ops import kernels as K
    from apex_tpu_torch.ops import multi_tensor as MT

    gen = torch.Generator(device="cuda").manual_seed(8)
    T, R, S = table.total, table.total // 128, table.num_segments
    valid = table.valid_mask("cuda")
    rows = {}

    def randn(scale=1.0):
        return torch.randn(T, generator=gen, device="cuda") * scale * valid

    g, p, m = randn(1e-2), randn(0.05), randn(1e-3)
    views = [g[o:o + n] for o, n in zip(table.offsets, table.sizes)]

    # rowsumsq: the row pass of LARC's and NovoGrad's per-tensor L2 norms
    got, want = MT.rowsumsq(g), MT.rowsumsq_plain(g)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    check(bool(((got - want).abs() <= 1e-5 * want.abs()).all()),
          f"rowsumsq: off by {rel} relative (limit 1e-5)")
    b_ms, b_by = bound(4 * T + 4 * R, 2 * T)
    row = dict(kernel="rowsumsq", dtype="float32", shape=[T],
               max_abs_err=float((got - want).abs().max()), max_rel_err=rel,
               tol="1e-5 relative",
               ms=timer(lambda: MT.rowsumsq(g)),
               plain_ms=timer(lambda: MT.rowsumsq_plain(g)),
               library_ms=timer(lambda: torch.linalg.vector_norm(
                   g.view(-1, 128), dim=1)),
               library_call="linalg.vector_norm over the (rows, 128) view",
               per_segment_ms=timer(lambda: K.l2norm_per_segment(
                   g, table, aligned_segments=True)),
               library_foreach_norm_ms=timer(lambda: torch._foreach_norm(
                   views)),
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.rowsumsq(g)))
    emit({"phase": "kernels", **row})
    rows[("rowsumsq", "float32")] = row

    # rowmaxabs: the row pass of NovoGrad's L-inf norms; exact
    got, want = MT.rowmaxabs(g), MT.rowmaxabs_plain(g)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "rowmaxabs: not equal to the plain "
                                  "version")
    b_ms, b_by = bound(4 * T + 4 * R, 2 * T)
    row = dict(kernel="rowmaxabs", dtype="float32", shape=[T],
               max_abs_err=0.0, tol=0.0, bitwise=True,
               ms=timer(lambda: MT.rowmaxabs(g)),
               plain_ms=timer(lambda: MT.rowmaxabs_plain(g)),
               library_ms=timer(lambda: g.view(-1, 128).abs().amax(1)),
               library_call="abs().amax(1) over the (rows, 128) view",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.rowmaxabs(g)))
    emit({"phase": "kernels", **row})
    rows[("rowmaxabs", "float32")] = row

    # sgd: every flag combination at a small size, then main_amp's at RN50
    small = {}
    n = 128 * 1037
    for flags in range(16):
        for first in (False, True):
            sc = MT.sgd_scalars(wd=1e-4, lr=0.1, momentum=0.9,
                                dampening=0.1, first_run=torch.tensor(
                                    first, device="cuda"), device="cuda")
            a = MT.sgd(g[:n], p[:n], m[:n], sc, flags)
            b = MT.sgd_plain(g[:n], p[:n], m[:n], sc, flags)
            small[f"{flags}/{int(first)}"] = all(
                bool(torch.equal(x, y)) for x, y in zip(a, b))
    check(all(small.values()), f"sgd: flag combinations not bit-equal "
                               f"{small}")
    flags = MT._sgd_flags(wd=MAIN_AMP_SGD["weight_decay"],
                          momentum=MAIN_AMP_SGD["momentum"], nesterov=False,
                          wd_after_momentum=False)
    sc = MT.sgd_scalars(wd=MAIN_AMP_SGD["weight_decay"],
                        lr=MAIN_AMP_SGD["lr"],
                        momentum=MAIN_AMP_SGD["momentum"], dampening=0.0,
                        first_run=torch.tensor(False, device="cuda"),
                        device="cuda")
    got, want = MT.sgd(g, p, m, sc, flags), MT.sgd_plain(g, p, m, sc, flags)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(same, f"sgd: not bit-equal to the plain version ({err})")
    del got, want
    lib_p = p.clone().requires_grad_(True)
    lib_p.grad = g.clone()
    lib = torch.optim.SGD([lib_p], fused=True, **MAIN_AMP_SGD)
    lib.step()                      # creates its momentum buffer
    b_ms, b_by = bound(20 * T + 24, 8 * T)
    row = dict(kernel="sgd", dtype="float32", shape=[T], max_abs_err=err,
               tol=0.0, bitwise=same, flags=flags, small_flags_bitwise=small,
               ms=timer(lambda: MT.sgd(g, p, m, sc, flags)),
               plain_ms=timer(lambda: MT.sgd_plain(g, p, m, sc, flags)),
               library_ms=timer(lib.step),
               library_call="optim.SGD(fused=True).step",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.sgd(g, p, m, sc, flags)))
    emit({"phase": "kernels", **row})
    rows[("sgd", "float32")] = row
    del lib, lib_p

    # novograd: the elementwise kernel at FusedNovoGrad's defaults (mode 1)
    # from a step-3 denominator; then the whole step at L2 and L-inf
    v = torch.rand(S, generator=gen, device="cuda") * 1e-2 + 1e-3
    row_seg = table.row_segment_ids("cuda")
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    bc1 = 1.0 - torch.pow(torch.tensor(0.95, device="cuda"), step.float())
    nsc = MT.novograd_scalars(lr=1e-2, beta1=0.95, weight_decay=0.0,
                              grad_averaging=True, bc1=bc1, device="cuda")
    mode = MT.MODE_DECOUPLED
    got = MT.novograd(g, p, m, v, row_seg, nsc, mode)
    want = MT.novograd_plain(g, p, m, v, row_seg, nsc, mode)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(same, f"novograd: not bit-equal to the plain version ({err})")
    steps = {}
    kw = dict(lr=1e-2, beta1=0.95, beta2=0.98, eps=1e-8, step=step,
              mode=mode)
    for nt, name in ((MT.NORM_L2, "l2"), (MT.NORM_LINF, "linf")):
        a = MT.novograd_step(g, p, m, v, table, norm_type=nt, **kw)
        with dispatch.backend("reference"):
            b = MT.novograd_step(g, p, m, v, table, norm_type=nt, **kw)
        e = max(float(((x - y).abs() / y.abs().clamp_min(1e-30)).max())
                for x, y in zip(a[2:], b[2:]))
        exact = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
        # L-inf norms are exact, so the whole step is; L2 norms add in
        # another order, so the blended norms within 1e-5 relative
        check(exact if nt == MT.NORM_LINF else e <= 1e-5,
              f"novograd_step {name}: norms off by {e}, exact {exact}")
        steps[name] = dict(bitwise=exact, norms_max_rel_err=e,
                           ms=timer(lambda: MT.novograd_step(
                               g, p, m, v, table, norm_type=nt, **kw)))
    b_ms, b_by = bound(20 * T + 4 * R + 4 * S + 20, 9 * T)
    row = dict(kernel="novograd", dtype="float32", shape=[T],
               max_abs_err=err, tol=0.0, bitwise=same, mode=mode,
               ms=timer(lambda: MT.novograd(g, p, m, v, row_seg, nsc, mode)),
               plain_ms=timer(lambda: MT.novograd_plain(g, p, m, v, row_seg,
                                                        nsc, mode)),
               library_ms=None, library_call="none (PyTorch has no NovoGrad)",
               bound_ms=b_ms, bound_by=b_by, whole_step=steps,
               host_us=host_us(torch, lambda: MT.novograd(
                   g, p, m, v, row_seg, nsc, mode)))
    emit({"phase": "kernels", **row})
    rows[("novograd", "float32")] = row
    return rows


# -- phase 2, gradient accumulation and fp16_utils: axpby, l2norm, Adagrad ---

# FusedAdagrad at lm_bench's lr, with the weight decay both modes are held at
ADAGRAD = dict(lr=1e-4, eps=1e-10, weight_decay=1e-2)


def accum_kernel_phase(torch, timer, total: int) -> dict:
    """The kernels of the accumulation and fp16_utils phases over the LM's
    flat fp32 master store (``total`` elements): ``axpby`` as
    ``unscale_with_stashed`` calls it (a = 1/65536 on the device, b = 1),
    in all three flag modes with an inf or NaN at the first, a middle and
    the last element of x and then of y; ``l2norm`` (within 1e-5 relative
    of the plain version, two runs bit-equal); ``adagrad`` in both weight
    decay modes (bit-equal). Each with its time, the plain version's, one
    PyTorch call's and the bound."""
    from apex_tpu_torch.ops import multi_tensor as MT

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {}
    T = total
    x = torch.randn(T, generator=gen, device="cuda") * 65536.0 * 1e-2
    y = torch.randn(T, generator=gen, device="cuda") * 1e-2
    a = torch.full((), 1.0 / 65536.0, device="cuda")

    # axpby: bit-equal to the plain version in every flag mode; each
    # injected inf or NaN flagged exactly when the mode checks its input
    same, flags = {}, {}
    for check_arg in (-1, 0, 1):
        got, fi = MT.axpby(a, x, 1.0, y, check_arg)
        want, fi0 = MT.axpby_plain(a, x, 1.0, y, check_arg)
        same[check_arg] = bool(torch.equal(got, want)) and \
            not bool(fi) and not bool(fi0)
        for arg, t in (("x", x), ("y", y)):
            covered = check_arg == -1 or check_arg == (0 if arg == "x" else 1)
            for where, pos, bad in (("first", 0, float("inf")),
                                    ("middle", T // 2, float("nan")),
                                    ("last", T - 1, float("-inf"))):
                keep = t[pos].clone()
                t[pos] = bad
                k_flag = bool(MT.axpby(a, x, 1.0, y, check_arg)[1])
                p_flag = bool(MT.axpby_plain(a, x, 1.0, y, check_arg)[1])
                t[pos] = keep
                flags[f"check{check_arg}_{arg}_{where}"] = k_flag
                check(k_flag == covered and p_flag == covered,
                      f"axpby check {check_arg}: {bad} in {arg} at {where} "
                      f"flagged {k_flag} (plain {p_flag}), want {covered}")
    check(all(same.values()), f"axpby: not bit-equal to the plain version "
                              f"{same}")
    got, _ = MT.axpby(a, x, 1.0, y, 0)
    want, _ = MT.axpby_plain(a, x, 1.0, y, 0)
    err = float((got - want).abs().max())
    del got, want
    b_ms, b_by = bound(12 * T + 12, 3 * T)
    row = dict(kernel="axpby", dtype="float32", shape=[T], max_abs_err=err,
               tol=0.0, bitwise=all(same.values()), inf_flags=flags,
               per_step=2,
               ms=timer(lambda: MT.axpby(a, x, 1.0, y, 0)),
               plain_ms=timer(lambda: MT.axpby_plain(a, x, 1.0, y, 0)),
               library_ms=timer(lambda: torch.add(y, x, alpha=1.0 / 65536)),
               library_covers="a·x + y, no flag (torch.add with alpha)",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.axpby(a, x, 1.0, y, 0)))
    emit({"phase": "kernels", **row})
    rows[("axpby", "float32")] = row

    # l2norm: within 1e-5 relative of the plain version; two runs bit-equal
    n1, n2 = MT.l2norm(y), MT.l2norm(y)
    n0 = MT.l2norm_plain(y)
    torch.cuda.synchronize()
    rel = float((n1 - n0).abs() / n0)
    repeat = bool(torch.equal(n1, n2))
    check(rel <= 1e-5, f"l2norm: {float(n1)} against plain {float(n0)} "
                       f"({rel:.3g} relative)")
    check(repeat, "l2norm: two runs on the same input differ")
    b_ms, b_by = bound(4 * T + 4, 2 * T)
    row = dict(kernel="l2norm", dtype="float32", shape=[T],
               max_abs_err=float((n1 - n0).abs()), rel_err=rel, tol=1e-5,
               repeat_equal=repeat, per_step=1,
               ms=timer(lambda: MT.l2norm(y)),
               plain_ms=timer(lambda: MT.l2norm_plain(y)),
               library_ms=timer(lambda: torch.linalg.vector_norm(y)),
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.l2norm(y)))
    emit({"phase": "kernels", **row})
    rows[("l2norm", "float32")] = row
    del x

    # adagrad at lm_bench's lr with weight decay 1e-2, both modes, step 3's
    # accumulator
    g = y
    p = torch.randn(T, generator=gen, device="cuda") * 0.02
    h = torch.rand(T, generator=gen, device="cuda") * 3e-4
    sc = MT.adagrad_scalars(device="cuda", **ADAGRAD)
    same, err = {}, 0.0
    for mode in (MT.MODE_L2, MT.MODE_DECOUPLED):
        got = MT.adagrad(g, p, h, sc, mode)
        want = MT.adagrad_plain(g, p, h, sc, mode)
        torch.cuda.synchronize()
        same[mode] = all(bool(torch.equal(u, w)) for u, w in zip(got, want))
        err = max([err] + [float((u - w).abs().max())
                           for u, w in zip(got, want)])
        del got, want
    check(all(same.values()),
          f"adagrad: not bit-equal to the plain version {same} ({err})")
    lib_p = p.clone().requires_grad_(True)
    lib_p.grad = g.clone()
    lib, lib_kind = None, None
    for kind in ("fused", "foreach"):
        try:
            opt = torch.optim.Adagrad([lib_p], lr=ADAGRAD["lr"],
                                      eps=ADAGRAD["eps"],
                                      weight_decay=ADAGRAD["weight_decay"],
                                      **{kind: True})
            opt.step()
            lib, lib_kind = opt, kind
            break
        except (RuntimeError, TypeError, ValueError):
            continue
    b_ms, b_by = bound(20 * T + 12, 9 * T)
    row = dict(kernel="adagrad", dtype="float32", shape=[T], max_abs_err=err,
               tol=0.0, bitwise=all(same.values()), modes_bit_equal={
                   "l2": same[MT.MODE_L2],
                   "decoupled": same[MT.MODE_DECOUPLED]},
               per_step=1, **ADAGRAD,
               ms=timer(lambda: MT.adagrad(g, p, h, sc, MT.MODE_L2)),
               plain_ms=timer(lambda: MT.adagrad_plain(g, p, h, sc,
                                                       MT.MODE_L2)),
               library_ms=timer(lib.step) if lib is not None else None,
               library_covers=f"torch.optim.Adagrad({lib_kind}=True).step"
               if lib is not None else "none runs",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: MT.adagrad(g, p, h, sc,
                                                         MT.MODE_L2)))
    emit({"phase": "kernels", **row})
    rows[("adagrad", "float32")] = row
    return rows


# impl="auto"'s crossover: the flash kernels against the plain composed
# attention at [128, S, 64] bf16, forward and forward + backward, causal and
# not (SDPA beside them as a yardstick only); the plain path runs in head
# groups of at most 128·2048² score elements, whose times add up
CROSSOVER_S = (128, 256, 512, 1024, 2048, 4096)
CROSSOVER_BH, CROSSOVER_D = 128, 64


def flash_crossover_phase(torch) -> dict:
    """Times of the flash path and the plain path over S; ``min_s`` is the
    smallest S measured from which the kernel wins every case at every
    larger S (None when it never does)."""
    import torch.nn.functional as F

    from apex_tpu_torch.contrib.multihead_attn import (
        DEFAULT_FLASH_MIN_S, flash_attention, reference_attention)

    timer = Timer(torch, reps=5)
    gen = torch.Generator(device="cuda").manual_seed(17)
    bh, d = CROSSOVER_BH, CROSSOVER_D
    table = []
    for causal in (False, True):
        for s in CROSSOVER_S:
            q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                           .to(torch.bfloat16) for _ in range(4))
            qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
            group = max(1, min(bh, bh * 2048 * 2048 // (s * s)))

            def fwd_bwd(fn, q=qg, k=kg, v=vg):
                o = fn(q, k, v, causal=causal)
                torch.autograd.grad(o, (q, k, v), do)

            def plain(grad):
                def run():
                    for i in range(0, bh, group):
                        sl = slice(i, i + group)
                        if grad:
                            o = reference_attention(qg[sl], kg[sl], vg[sl],
                                                    causal=causal)
                            torch.autograd.grad(o, (qg, kg, vg), do[sl],
                                                allow_unused=True)
                        else:
                            reference_attention(q[sl], k[sl], v[sl],
                                                causal=causal)
                return run

            q4, k4, v4 = (t.view(1, bh, s, d) for t in (qg, kg, vg))
            do4 = do.view(1, bh, s, d)

            def sdpa_fb():
                o = F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=causal)
                torch.autograd.grad(o, (qg, kg, vg), do4)

            with torch.no_grad():
                r = {"causal": causal, "s": s, "plain_head_group": group,
                     "fwd_ms": timer(lambda: flash_attention(
                         q, k, v, causal=causal)),
                     "plain_fwd_ms": timer(plain(False)),
                     "sdpa_fwd_ms": timer(
                         lambda: F.scaled_dot_product_attention(
                             q.view(1, bh, s, d), k.view(1, bh, s, d),
                             v.view(1, bh, s, d), is_causal=causal))}
            r["fwd_bwd_ms"] = timer(lambda: fwd_bwd(flash_attention))
            r["plain_fwd_bwd_ms"] = timer(plain(True))
            r["sdpa_fwd_bwd_ms"] = timer(sdpa_fb)
            r["kernel_wins"] = r["fwd_ms"] < r["plain_fwd_ms"] and \
                r["fwd_bwd_ms"] < r["plain_fwd_bwd_ms"]
            emit({"phase": "flash_crossover", "shape": [bh, s, d],
                  "dtype": "bfloat16", **r})
            table.append(r)
            del q, k, v, do, qg, kg, vg, q4, k4, v4, do4
    min_s = None
    for s in sorted(CROSSOVER_S, reverse=True):
        if all(r["kernel_wins"] for r in table if r["s"] >= s):
            min_s = s
        else:
            break
    row = {"phase": "flash_crossover_min_s", "min_s": min_s,
           "default_flash_min_s": DEFAULT_FLASH_MIN_S}
    emit(row)
    check(all(r["kernel_wins"] for r in table
              if r["s"] >= DEFAULT_FLASH_MIN_S),
          f"flash crossover: the kernel does not win at every S >= "
          f"DEFAULT_FLASH_MIN_S {DEFAULT_FLASH_MIN_S} (min_s {min_s})")
    return row


# -- phases 3-4: the serving slice --------------------------------------------

TRAIN_KERNELS = ("scale", "lamb_phase1", "lamb_phase2", "bn_moments",
                 "bn_backward_fused_reduce", "bn_backward_dx")


def counters():
    from apex_tpu_torch.ops import decode_attn as DA
    from apex_tpu_torch.ops import flash_attn as FA
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops import multi_tensor as MT
    from apex_tpu_torch.ops import welford as WF
    from apex_tpu_torch.ops import xentropy as XE
    return {"decode_attention": DA.decode_attention,
            "paged_decode_attention": DA.paged_decode_attention,
            "ln_fwd": LN.ln_fwd, "scale": MT.scale,
            "lamb_phase1": MT.lamb_phase1, "lamb_phase2": MT.lamb_phase2,
            "bn_moments": WF.bn_moments,
            "bn_backward_fused_reduce": WF.bn_backward_fused_reduce,
            "bn_backward_dx": WF.bn_backward_dx,
            "adam": MT.adam, "ln_bwd": LN.ln_bwd,
            "flash_fwd": FA.flash_fwd, "flash_bwd_dq": FA.flash_bwd_dq,
            "flash_bwd_dkv": FA.flash_bwd_dkv, "rowsumsq": MT.rowsumsq,
            "rowmaxabs": MT.rowmaxabs, "sgd": MT.sgd,
            "novograd": MT.novograd, "xent_fwd": XE.xent_fwd,
            "xent_bwd": XE.xent_bwd, "axpby": MT.axpby,
            "l2norm": MT.l2norm, "adagrad": MT.adagrad}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def serve_phase(torch, name, model, params, reqs, **kw):
    from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                      summarize_serving)
    eng = ContinuousBatchingEngine(model, params, slots=8, max_len=1024,
                                   prefill_chunk=32, **kw)
    # one short run first: the card loads each product's kernels on
    # first use, which is set-up, not serving
    eng.run(reqs[:4])
    torch.cuda.synchronize()
    zero_counts()
    results, stats = eng.run(reqs)
    torch.cuda.synchronize()
    counts = read_counts()
    summary = summarize_serving(results, stats, offered_rps=8.0)
    for r, q in zip(results, reqs):
        check(r.finish_s is not None and len(r.tokens) == q.max_new,
              f"{name}: request {q.id} got {len(r.tokens)} of "
              f"{q.max_new} tokens")
        check(all(0 <= t < model.vocab_size for t in r.tokens),
              f"{name}: request {q.id} emitted a token out of range")
    steps = stats["decode_steps"]
    decode_tokens = summary["tokens_out"] - len(results)
    emit({"phase": name, "requests": len(results),
          "completed": summary["completed"],
          "tokens": summary["tokens_out"],
          "wall_s": summary["duration_s"],
          "tokens_per_s": summary["tokens_per_s"],
          "decode_steps": steps,
          "decode_tok_s": decode_tokens / (sum(stats["step_ms"]) / 1e3),
          "decode_step_ms": summary["decode_step_ms"],
          "ttft_ms": summary["ttft_ms"],
          "token_lat_ms": summary["token_lat_ms"],
          "itl_ms": summary["itl_ms"],
          "slot_occupancy": summary["slot_occupancy"],
          "prefill_batches": summary["prefill_batches"],
          "prefill_chunks": summary["prefill_chunks"],
          "kv_reserved_bytes": summary["kv_reserved_bytes"],
          "launches": counts,
          "launches_per_step": {k: v / steps for k, v in counts.items()}})
    return results, stats, counts


# -- phase 5: kernels against the plain versions through the model ------------

def crosscheck_phase(torch, dispatch):
    from apex_tpu_torch.models import TransformerLM

    m = TransformerLM(vocab_size=32768, max_seq_len=1024, embed_dim=1024,
                      num_heads=8, num_layers=2)
    p = m.init(torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    S, P, PAGE = 8, 40, 32
    prompt = torch.randint(0, 32768, (S, P), generator=g).cuda()
    toks = torch.randint(0, 32768, (S,), generator=g).to(torch.int32).cuda()
    pos = torch.tensor([1, 5, 39, 40, 17, 33, 8, 40], dtype=torch.int32,
                       device="cuda")
    max_pages = 1024 // PAGE
    table = (torch.randperm(S * max_pages, generator=g) + 1).to(
        torch.int32).reshape(S, max_pages).cuda()

    def step(paged: bool):
        hid, caches = m._prefill(p, prompt, 1024)
        kw = {}
        if paged:
            pools = {}
            for name, kv in caches.items():
                pools[name] = tuple(
                    torch.zeros((1 + S * max_pages, 8, PAGE, 128),
                                device="cuda") for _ in kv)
                for c, pool in zip(kv, pools[name]):
                    pool[table.reshape(-1).long()] = (
                        c.reshape(S, 8, max_pages, PAGE, 128)
                        .transpose(1, 2).reshape(-1, 8, PAGE, 128))
            caches = pools
            kw = dict(page_table=table, page_size=PAGE)
        out, _ = m._decode_slots(p, toks, pos, caches, **kw)
        return hid, (out @ p["tok_emb"].T).float()

    hid_k, dense_k = step(False)
    _, paged_k = step(True)
    with dispatch.backend("reference"):
        zero_counts()
        hid_r, dense_r = step(False)
        _, paged_r = step(True)
        torch.cuda.synchronize()
        plain_launches = read_counts()
    check(not any(plain_launches.values()),
          f"crosscheck: kernels launched in the plain run {plain_launches}")
    errs = {"prefill_hidden": float((hid_k - hid_r).abs().max()),
            "dense_logits": float((dense_k - dense_r).abs().max()),
            "paged_logits": float((paged_k - paged_r).abs().max())}
    emit({"phase": "crosscheck", "layers": 2, "dtype": "float32",
          "atol": 1e-4, "max_abs_err": errs,
          "paged_equals_dense": bool(torch.equal(paged_k, dense_k)),
          "finite": bool(torch.isfinite(dense_k).all())})
    for what, e in errs.items():
        check(e <= 1e-4, f"crosscheck {what}: max abs err {e} > 1e-4")
    check(torch.equal(paged_k, dense_k),
          "crosscheck: paged logits differ from dense with the kernels")
    check(bool(torch.isfinite(dense_k).all()), "crosscheck: non-finite")


# -- phases 6-8: the training slice -------------------------------------------

KERNEL_FAMILIES = (
    ("SGD", ("sgd_kernel",)),
    ("NovoGrad", ("novograd_kernel",)),
    ("norm kernels", ("rowsumsq_kernel", "rowmaxabs_kernel")),
    ("BN kernels", ("moments_kernel", "bwd_reduce_kernel", "finalize_kernel",
                    "bwd_dx_kernel")),
    ("training kernels", ("scale_kernel", "lamb_phase")),
    ("convolution", ("conv", "xmma", "gemm", "cutlass", "dgrad", "wgrad",
                     "cudnn", "implicit", "sm90")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                     "copy", "fill", "clamp")),
    ("pooling", ("pool",)),
)


LM_KERNEL_FAMILIES = (
    ("flash kernels", ("flash_fwd_kernel", "flash_dq_kernel",
                       "flash_dkv_kernel")),
    ("LN kernels", ("ln_fwd_kernel", "ln_bwd_kernel", "finalize_kernel")),
    ("Adam", ("adam_kernel",)),
    ("GEMMs", ("gemm", "xmma", "cutlass", "nvjet", "sm90", "cublas")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                     "copy", "fill", "clamp", "cat", "index", "embedding")),
)


def _family(name: str, families) -> str:
    low = name.lower()
    for fam, keys in families:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile_steps(torch, step, families=KERNEL_FAMILIES, n=2) -> dict:
    """Device time by kernel family and the device's idle share over
    ``n`` calls of ``step`` under ``torch.profiler`` (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam, top = {}, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        f = _family(e.key, families)
        fam[f] = fam.get(f, 0.0) + us / 1e3 / n
        top.append((us / 1e3 / n, e.count // n, e.key[:90]))
    busy = sum(fam.values())
    top.sort(reverse=True)
    return {"steps": n, "wall_ms_per_step": wall_ms / n,
            "device_ms_per_step": busy,
            "idle_share": (1.0 - busy / (wall_ms / n)) if wall_ms else None,
            "by_family_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": t, "calls": c, "name": k}
                            for t, c, k in top[:12]]}


def timed_steps(torch, step, warm: int, timed: int) -> dict:
    """``warm`` calls of ``step`` (which returns the loss), then ``timed``
    calls with the launch counts zeroed just before and read just after:
    CUDA events per step, one synchronize around the window."""
    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(timed)]
    t0 = time.perf_counter()
    for a, b in events:
        a.record()
        losses.append(step())
        b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    return {"wall": wall, "counts": counts, "step_ms": step_ms,
            "peak": torch.cuda.max_memory_allocated(),
            "loss": [float(v) for v in losses]}


def window_row(r: dict, timed: int) -> dict:
    """Step times, peak memory and losses of a training window."""
    wall, loss, step_ms = r["wall"], r["loss"], r["step_ms"]
    return {"steps_timed": timed, "wall_s": wall,
            "step_ms_mean": wall / timed * 1e3,
            "step_ms_p50": statistics.median(step_ms),
            "step_ms_p95": step_ms[min(timed - 1,
                                       int(round(0.95 * (timed - 1))))],
            "peak_mem_bytes": r["peak"], "loss_first": loss[0],
            "loss_last": loss[-1], "losses": loss}


def step_row(r: dict, batch: int, timed: int, flops: float) -> dict:
    """The end-to-end numbers of a ResNet training window."""
    img_s = batch * timed / r["wall"]
    return {**window_row(r, timed), "img_per_s": img_s,
            "analytic_fwd_gflop_per_img": flops / 1e9,
            "mfu": 3 * flops * img_s / BF16_DENSE_OPS_S}


def check_losses(phase: str, loss: list, *, overshoot=None) -> None:
    """Finite losses that fall: the last below the first; or, where the
    step overshoots the repeated batch (``overshoot``, a factor), the
    first three falling and none above ``overshoot`` times the first."""
    import numpy as np
    check(all(np.isfinite(loss)), f"{phase}: non-finite loss {loss}")
    if overshoot is None:
        fell = loss[-1] < loss[0]
    else:
        fell = loss[0] > loss[1] > loss[2] and \
            max(loss) <= overshoot * loss[0]
    check(fell, f"{phase}: loss did not fall {loss}")


def check_counts(phase: str, counts: dict, want: dict) -> None:
    for k, n in want.items():
        check(counts[k] == n, f"{phase}: {k} launched {counts[k]} times, "
                              f"not {n}")


def train_phase(torch, model, params, state, bn_calls) -> tuple:
    import numpy as np

    from apex_tpu_torch.models import analytic_flops
    from apex_tpu_torch.train import Trainer

    batch, image, warm, timed = 256, 224, 3, 10
    tr = Trainer(model, params, state, opt_level="O2")
    rs = np.random.RandomState(0)                # bench.py:1269-1271
    x = torch.from_numpy(rs.randn(batch, image, image, 3)).cuda().to(
        tr.half).permute(0, 3, 1, 2)             # NHWC data, channels_last
    y = torch.from_numpy(rs.randint(0, model.num_classes, batch).astype(
        np.int32)).cuda()
    r = timed_steps(torch, lambda: tr.step(x, y), warm, timed)
    counts = r["counts"]
    prof = profile_steps(torch, lambda: tr.step(x, y))
    row = {"phase": "train", "model": "resnet50", "batch": batch,
           "image": image, "dtype": "bfloat16", "opt_level": "O2",
           "loss_scale": float(tr.handle.loss_scale(tr.amp_state)),
           **step_row(r, batch, timed, analytic_flops(model, image)),
           "flat_total": tr.table.total,
           "segments": tr.table.num_segments, "launches": counts,
           "profile": prof}
    emit(row)
    check_losses("train", r["loss"])
    n_bn = sum(bn_calls.values())
    check_counts("train", counts, {
        k: timed * (n_bn if k.startswith("bn_") else 1)
        for k in TRAIN_KERNELS})
    return counts, row


# -- phases 11-13: the ImageNet example's slice -------------------------------

IMAGENET_KERNELS = ("sgd", "rowsumsq", "rowmaxabs", "novograd")

# main_amp's lr 0.1 has no warm-up, so on one repeated batch its SGD step
# falls for three steps and then overshoots: 7.06 -> 5.82 at step 4, 17.14
# at step 13 (2.43 times the first, the same bits in three runs), and the
# plain versions' path 21.77 (3.08 times; PR 4's chip runs on the H100).
# The kernel path's losses stay under 4 times the first, and the plain
# versions' path (the witness) must overshoot the same way: the first
# WITNESS_STEPS losses within WITNESS_RTOL of the kernel path's (read
# 1.2e-3), and its last above WITNESS_RISE times its least.
SGD_OVERSHOOT = 4.0
WITNESS_STEPS, WITNESS_RTOL, WITNESS_RISE = 4, 1e-2, 1.25


def plain_witness(torch, make, x, y, n: int) -> dict:
    """``n`` steps of a fresh trainer from ``make`` under the plain
    versions (``dispatch.backend("reference")``): its losses and the
    kernel launches it made (none)."""
    from apex_tpu_torch.ops import dispatch
    with dispatch.backend("reference"):
        tr = make()
        zero_counts()
        loss = [float(tr.step(x, y)) for _ in range(n)]
        torch.cuda.synchronize()
        launches = read_counts()
    return {"losses": loss, "launches": launches}


def check_witness(phase: str, loss: list, w: dict) -> None:
    plain = w["losses"]
    check(not any(w["launches"].values()),
          f"{phase} witness: kernels launched {w['launches']}")
    check(len(plain) == len(loss) and all(
        abs(a - b) <= WITNESS_RTOL * abs(b)
        for a, b in zip(loss[:WITNESS_STEPS], plain[:WITNESS_STEPS])),
        f"{phase} witness: kernel losses {loss} against plain {plain}")
    check(plain[-1] >= WITNESS_RISE * min(plain),
          f"{phase} witness: the plain path does not overshoot {plain}")


def imagenet_batch(torch, batch: int, image: int, classes: int):
    """main_amp.py's synthetic uint8 pool (:362-364), here one batch of
    (image + 8)² images center-cropped to image² as its hold-out is
    (:367-370); labels from the same RandomState."""
    import numpy as np
    rs = np.random.RandomState(0)
    pool = rs.randint(0, 256, (batch, image + 8, image + 8, 3),
                      dtype=np.uint8)
    y = rs.randint(0, classes, batch).astype(np.int32)
    x = np.ascontiguousarray(pool[:, 4:4 + image, 4:4 + image])
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def imagenet_phases(torch, model, params, state, bn_calls) -> dict:
    """main_amp.py's step at full width: FusedSGD (imagenet_train, with a
    profile and one evaluate), LARC(FusedSGD) and FusedNovoGrad at L2 and
    L-inf norms. Returns each run's launch counts."""
    from apex_tpu_torch.models import analytic_flops
    from apex_tpu_torch.train import Trainer

    batch, image = 256, 224
    n_bn = sum(bn_calls.values())
    flops = analytic_flops(model, image)
    x, y = imagenet_batch(torch, batch, image, model.num_classes)
    # (phase, Trainer keywords, warm-up, timed, launches a step); main_amp
    # passes its flags to the class (main_amp.py:208-210)
    runs = (("imagenet_train", dict(optimizer="sgd", **MAIN_AMP_SGD), 3, 10,
             {"sgd": 1}),
            ("imagenet_larc", dict(optimizer="sgd", larc=True), 3, 5,
             {"sgd": 1, "rowsumsq": 2}),
            ("imagenet_novograd", dict(optimizer="novograd", lr=1e-2), 3, 5,
             {"novograd": 1, "rowsumsq": 1}),
            ("imagenet_novograd", dict(optimizer="novograd", lr=1e-2,
                                       norm_type=0), 3, 5,
             {"novograd": 1, "rowmaxabs": 1}))
    out = {}
    for phase, kw, warm, timed, per_step in runs:
        def make():
            return Trainer(model, params, state, opt_level="O2", **kw)

        tr = make()
        r = timed_steps(torch, lambda: tr.step(x, y), warm, timed)
        counts = r["counts"]
        want = {k: timed * per_step.get(k, 0) for k in IMAGENET_KERNELS}
        want.update({k: timed * (n_bn if k.startswith("bn_") else
                                 int(k == "scale"))
                     for k in TRAIN_KERNELS})
        row = {"phase": phase, "model": "resnet50", "batch": batch,
               "image": image, "input": "uint8 NHWC, normalized in the step",
               "dtype": "bfloat16", "opt_level": "O2",
               "loss_scale": float(tr.handle.loss_scale(tr.amp_state)),
               "optimizer": type(tr.opt).__name__,
               "hyperparameters": {k: v for k, v in
                                   tr.opt.param_groups[0].items()},
               **step_row(r, batch, timed, flops),
               "launches": {k: counts[k] for k in want},
               "launches_per_step": {k: counts[k] / timed for k in want}}
        if phase == "imagenet_train":
            row["profile"] = profile_steps(torch, lambda: tr.step(x, y))
            top1, top5 = tr.evaluate(x, y)
            row["evaluate"] = {"top1": float(top1), "top5": float(top5)}
            tr = None                   # the card's memory for the witness
            row["plain_witness"] = plain_witness(torch, make, x, y,
                                                 warm + timed)
        emit(row)
        if phase == "imagenet_train":
            check_losses(phase, r["loss"], overshoot=SGD_OVERSHOOT)
            check_witness(phase, r["loss"], row["plain_witness"])
        else:
            check_losses(phase, r["loss"])
        check_counts(phase, counts, want)
        key = phase if phase != "imagenet_novograd" else \
            f"imagenet_novograd_{row['hyperparameters']['norm_type']}"
        out[key] = counts
        del tr
    return out


IMAGENET_CASES = {
    "sgd": dict(optimizer="sgd"),
    "larc": dict(optimizer="sgd", larc=True),
    "novograd_l2": dict(optimizer="novograd", lr=1e-2),
    "novograd_linf": dict(optimizer="novograd", lr=1e-2, norm_type=0),
}


def imagenet_crosscheck_phase(torch, dispatch):
    """Three steps of main_amp's step on the CI model (uint8 batch) for
    each optimizer, with the kernels and with the plain versions on the
    card, at O0 and O2, under phase 8's bars; two O2 kernel runs must
    give the same losses and masters bit for bit."""
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.train import Trainer

    torch.backends.cudnn.deterministic = True
    model = _ci_model()
    params, state = model.init(0)
    init = flat.flatten(params, dtype=torch.float32)[0]
    x, y = imagenet_batch(torch, 4, 32, 10)
    result = {}
    for case, kw in IMAGENET_CASES.items():
        def run(level):
            tr = Trainer(model, params, state, opt_level=level, **kw)
            loss = [float(tr.step(x, y)) for _ in range(3)]
            return tr.opt.state[0].master, loss

        gk, loss_k = run("O0")
        hk, loss_hk = run("O2")
        hk2, loss_hk2 = run("O2")
        with dispatch.backend("reference"):
            zero_counts()
            gr, loss_r = run("O0")
            hr, loss_hr = run("O2")
            torch.cuda.synchronize()
            plain_launches = read_counts()
        check(not any(plain_launches.values()),
              f"imagenet_crosscheck {case}: kernels launched in the plain "
              f"runs {plain_launches}")
        upd = gr - init
        o0 = {"master": float((gk - gr).abs().max()),
              "update_rel_l2": float(torch.linalg.vector_norm(gk - gr)
                                     / torch.linalg.vector_norm(upd)),
              "update_max": float(upd.abs().max())}
        d_o2, d_bf16 = (hk - hr).abs(), (hr - gr).abs()
        o2 = {"mean": float(d_o2.mean()), "max": float(d_o2.max()),
              "bf16_mean": float(d_bf16.mean()),
              "bf16_max": float(d_bf16.max())}
        loss_lim = [max(5e-3, 1.5 * abs(a - b))
                    for a, b in zip(loss_hr, loss_r)]
        repeat = loss_hk == loss_hk2 and bool(torch.equal(hk, hk2))
        result[case] = {"O0": {"max_abs_err": o0, "loss_kernels": loss_k,
                               "loss_plain": loss_r},
                        "O2": {"master_err": o2, "loss_kernels": loss_hk,
                               "loss_plain": loss_hr, "loss_limit": loss_lim},
                        "repeat_equal": repeat}
        check(o0["master"] <= O0_MASTER_ATOL
              and o0["update_rel_l2"] <= O0_UPDATE_RTOL,
              f"imagenet_crosscheck {case} O0: masters differ by {o0}")
        check(o2["mean"] <= 1.5 * o2["bf16_mean"]
              and o2["max"] <= 1.5 * o2["bf16_max"],
              f"imagenet_crosscheck {case} O2: masters differ by {o2}")
        check(all(abs(a - b) <= lim for a, b, lim in
                  zip(loss_hk, loss_hr, loss_lim)),
              f"imagenet_crosscheck {case} O2: losses {loss_hk} vs "
              f"{loss_hr}")
        check(repeat, f"imagenet_crosscheck {case}: two kernel runs differ")
    emit({"phase": "imagenet_crosscheck", "steps": 3, "model": "CI ResNet",
          "O0_atol": O0_MASTER_ATOL, "O0_update_rtol": O0_UPDATE_RTOL,
          **result})
    torch.backends.cudnn.deterministic = False


def _ci_model():
    from apex_tpu_torch.models import ResNet
    # bench.py:1248's CI model: stage 1 opens with a stride-2 bottleneck
    return ResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10,
                  width=8)


def _ci_batch(torch, dtype):
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(4, 3, 32, 32, generator=g, device="cuda").to(dtype)
    y = torch.randint(0, 10, (4,), generator=g, device="cuda")
    return x, y


def overflow_phase(torch):
    from apex_tpu_torch.train import Trainer

    model = _ci_model()
    params, state = model.init(0)
    tr = Trainer(model, params, state, opt_level="O2",
                 half_dtype=torch.float16, loss_scale="dynamic")
    x, y = _ci_batch(torch, torch.float16)
    gs0 = tr.opt.state[0]
    scale0 = float(tr.handle.loss_scale(tr.amp_state))
    flat_grad, _, new_bn = tr.loss_and_grad(x, y)
    flat_grad[tr.table.offsets[3] + 1] = float("inf")
    found = bool(tr.apply_grads(flat_grad, new_bn))
    gs1 = tr.opt.state[0]
    scale1 = float(tr.handle.loss_scale(tr.amp_state))
    unchanged = {
        "master": bool(torch.equal(gs1.master, gs0.master)),
        "slots": all(bool(torch.equal(gs1.slots[k], gs0.slots[k]))
                     for k in gs0.slots),
        "step": int(gs1.step) == int(gs0.step)}
    tr.step(x, y)
    gs2 = tr.opt.state[0]
    clean = {"step": int(gs2.step), "master_moved": not bool(
        torch.equal(gs2.master, gs0.master)),
        "scale": float(tr.handle.loss_scale(tr.amp_state))}
    emit({"phase": "overflow", "half": "float16", "found_inf": found,
          "scale_before": scale0, "scale_after": scale1,
          "unchanged": unchanged, "clean_step": clean,
          "scaler": tr.handle.state_dict(tr.amp_state)})
    check(found, "overflow: the injected inf was not flagged")
    check(all(unchanged.values()), f"overflow: state moved {unchanged}")
    check(scale0 == 65536.0 and scale1 == 32768.0,
          f"overflow: scale {scale0} -> {scale1}")
    check(clean["step"] == int(gs0.step) + 1 and clean["master_moved"],
          f"overflow: the clean step did not advance {clean}")


O0_MASTER_ATOL = 5e-5
O0_UPDATE_RTOL = 1e-3


def train_crosscheck_phase(torch, dispatch):
    """Three steps of the CI model with every kernel against the plain
    versions on the card. O0 (f32): the BN sums add in another order, so
    a gradient near zero can tip LAMB's first steps, which move a weight
    by about lr times the sign of its gradient; so the masters within
    5e-5 (three steps at lr 1e-3 move a weight by 1e-4 to 1e-3), and the
    whole update within 1e-3 of its own L2 norm, which an update off by a
    percent anywhere fails. O2 (bf16): a bf16 activation may round the
    other way as well; the kernel run's masters may be no farther from the
    plain run's than 1.5 times bf16's own effect (the plain O2 masters
    against the plain O0 ones), in mean and in max, the bar of
    tests/test_torch_resnet.py."""
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.train import Trainer

    torch.backends.cudnn.deterministic = True
    model = _ci_model()
    params, state = model.init(0)
    x, y = _ci_batch(torch, torch.float32)

    def run(level):
        tr = Trainer(model, params, state, opt_level=level)
        loss = [float(tr.step(x, y)) for _ in range(3)]
        return tr.opt.state[0], loss

    init = flat.flatten(params, dtype=torch.float32)[0]
    gk, loss_k = run("O0")
    hk, loss_hk = run("O2")
    with dispatch.backend("reference"):
        zero_counts()
        gr, loss_r = run("O0")
        hr, loss_hr = run("O2")
        torch.cuda.synchronize()
        plain_launches = read_counts()
    # the plain runs' backward too (it runs on the autograd device thread)
    check(not any(plain_launches.values()),
          f"train_crosscheck: kernels launched in the plain runs "
          f"{plain_launches}")
    errs = {"master": float((gk.master - gr.master).abs().max()),
            **{k: float((gk.slots[k] - gr.slots[k]).abs().max())
               for k in gk.slots}}
    upd = gr.master - init
    errs["update_rel_l2"] = float(torch.linalg.vector_norm(
        gk.master - gr.master) / torch.linalg.vector_norm(upd))
    errs["update_max"] = float(upd.abs().max())
    d_o2 = (hk.master - hr.master).abs()
    d_bf16 = (hr.master - gr.master).abs()
    o2 = {"mean": float(d_o2.mean()), "max": float(d_o2.max()),
          "bf16_mean": float(d_bf16.mean()), "bf16_max": float(d_bf16.max())}
    emit({"phase": "train_crosscheck", "steps": 3,
          "O0": {"atol": O0_MASTER_ATOL, "update_rtol": O0_UPDATE_RTOL,
                 "max_abs_err": errs,
                 "loss_kernels": loss_k, "loss_plain": loss_r},
          "O2": {"master_err": o2, "loss_kernels": loss_hk,
                 "loss_plain": loss_hr}})
    torch.backends.cudnn.deterministic = False
    check(errs["master"] <= O0_MASTER_ATOL
          and errs["update_rel_l2"] <= O0_UPDATE_RTOL,
          f"train_crosscheck O0: masters differ by {errs}")
    check(o2["mean"] <= 1.5 * o2["bf16_mean"]
          and o2["max"] <= 1.5 * o2["bf16_max"],
          f"train_crosscheck O2: masters differ by {o2}")
    check(all(abs(a - b) <= 5e-3 for a, b in zip(loss_hk, loss_hr)),
          f"train_crosscheck O2: losses {loss_hk} vs {loss_hr}")


# -- phases 9-10: the LM training slice ---------------------------------------

def lm_model():
    from apex_tpu_torch.models import TransformerLM
    c = LM_SHAPE
    # tools/lm_bench.py's defaults: attn "fast", the fused head in vocab
    # chunks of min(8192, vocab)
    return TransformerLM(vocab_size=c["vocab"], max_seq_len=c["seq"],
                         embed_dim=c["embed"], num_heads=c["heads"],
                         num_layers=c["layers"], attn_impl="fast",
                         head_chunk=min(8192, c["vocab"]))


def lm_batch(torch):
    """Phase 9's token batch: 8 × 4096 from RandomState(1)."""
    import numpy as np
    c = LM_SHAPE
    return torch.from_numpy(np.random.RandomState(1).randint(
        0, c["vocab"], (c["batch"], c["seq"])).astype(np.int64)).cuda()




def lm_step_flops(n_params: int) -> float:
    """lm_bench's FLOP model of one step: 6·P·tokens + 6·L·d·S²·B."""
    c = LM_SHAPE
    return 6.0 * n_params * c["batch"] * c["seq"] + (
        12 * c["layers"] * c["embed"] * c["seq"] ** 2 * c["batch"]) / 2


def lm_train_phase(torch, model, params) -> tuple:
    """tools/lm_bench.py's step at its defaults on one card: O2 bf16 over
    fp32 flat masters, FusedAdam(lr=1e-4), one numpy token batch reused
    every step; 3 warm-up and 10 timed steps, then two profiled ones."""
    from apex_tpu_torch.train import LMTrainer

    c = LM_SHAPE
    warm, timed = 3, 10
    tr = LMTrainer(model, params, lr=1e-4)
    toks = lm_batch(torch)
    r = timed_steps(torch, lambda: tr.step(toks), warm, timed)
    counts = r["counts"]
    tokens = c["batch"] * c["seq"]               # lm_bench's count
    n_params = tr.table.total
    step_flops = lm_step_flops(n_params)
    tok_s = tokens * timed / r["wall"]
    prof = profile_steps(torch, lambda: tr.step(toks), LM_KERNEL_FAMILIES)
    row = {"phase": "lm_train", "model": "TransformerLM", **c,
           "attn_impl": model.attn_impl, "head_chunk": model.head_chunk,
           "dtype": "bfloat16", "masters": "float32", "optimizer":
           "FusedAdam(lr=1e-4)", **window_row(r, timed),
           "tokens_per_step": tokens, "tok_per_s": tok_s,
           "step_tflop": step_flops / 1e12,
           "mfu": step_flops * timed / r["wall"] / BF16_DENSE_OPS_S,
           "params": n_params,
           "launches": {k: counts[k] for k in LM_PER_STEP},
           "launches_per_step": {k: counts[k] / timed for k in LM_PER_STEP},
           "profile": prof}
    emit(row)
    check_losses("lm_train", r["loss"])
    check_counts("lm_train", counts,
                 {k: n * timed for k, n in LM_PER_STEP.items()})
    return counts, row


def crosscheck(torch, dispatch, phase, run, **extra) -> dict:
    """``run(dtype)`` — three training steps from fixed masters, returning
    ``(masters, [flat grad of each step, unscaled], [losses])`` — with the
    kernels (bf16, twice) and with the plain versions on the card (bf16,
    and fp32: ``dtype`` None). Step 1 starts every run from the same
    masters, so its flat gradient holds the kernels' own effect: the
    kernel run's within 1.5 times bf16's (the plain bf16 gradient against
    the plain fp32 one), in mean and in max. After 3 steps the masters
    within 1.5 times bf16's effect in mean, leaving out those whose fp32
    gradient at some step is within 1e-7 of its largest entry (the key
    biases, zero analytically; unused vocabulary rows): Adam and Adagrad
    turn rounding noise there into moves of about lr either way, in every
    run, and cap the largest difference of any master at about 2 × 3 ×
    lr, so the masters' max is reported, not held. Two kernel runs give
    the same losses and masters bit for bit; no kernel launches in the
    plain runs."""
    mk, gk, loss_k = run(torch.bfloat16)
    mk2, _, loss_k2 = run(torch.bfloat16)
    with dispatch.backend("reference"):
        zero_counts()
        mr, gr, loss_r = run(torch.bfloat16)
        mf, gf, loss_f = run(None)
        torch.cuda.synchronize()
        plain_launches = read_counts()
    check(not any(plain_launches.values()),
          f"{phase}: kernels launched in the plain runs {plain_launches}")
    g_k, g_bf16 = (gk[0] - gr[0]).abs(), (gr[0] - gf[0]).abs()
    noise = torch.zeros_like(mk, dtype=torch.bool)
    for g in gf:
        noise |= g.abs() <= 1e-7 * g.abs().max()
    rest = ~noise
    d_k, d_bf16 = (mk - mr).abs(), (mr - mf).abs()
    errs = {"grad1_mean": float(g_k.mean()), "grad1_max": float(g_k.max()),
            "grad1_bf16_mean": float(g_bf16.mean()),
            "grad1_bf16_max": float(g_bf16.max()),
            "grad1_abs_max": float(gf[0].abs().max()),
            "mean": float(d_k[rest].mean()), "max": float(d_k[rest].max()),
            "bf16_mean": float(d_bf16[rest].mean()),
            "bf16_max": float(d_bf16[rest].max()),
            "noise_max": float(d_k[noise].max()) if noise.any() else 0.0,
            "noise_elements": int(noise.sum())}
    repeat = loss_k == loss_k2 and bool(torch.equal(mk, mk2))
    row = {"phase": phase, **extra, "steps": 3, "dtype": "bfloat16",
           "err": errs, "loss_kernels": loss_k, "loss_kernels_again":
           loss_k2, "loss_plain": loss_r, "loss_plain_f32": loss_f,
           "repeat_equal": repeat}
    emit(row)
    check(errs["grad1_mean"] <= 1.5 * errs["grad1_bf16_mean"]
          and errs["grad1_max"] <= 1.5 * errs["grad1_bf16_max"],
          f"{phase}: step 1's gradients differ by {errs}")
    check(errs["mean"] <= 1.5 * errs["bf16_mean"],
          f"{phase}: masters differ by {errs}")
    check(repeat, f"{phase}: two kernel runs differ {loss_k} vs {loss_k2}")
    check(all(abs(a - b) <= 2e-2 for a, b in zip(loss_k, loss_r)),
          f"{phase}: losses {loss_k} vs {loss_r}")
    return row


def adam_crosscheck(torch, dispatch, phase, model, params, batch,
                    loss_kw, adam, **trainer_kw) -> dict:
    """``crosscheck`` of three O2 ``LMTrainer`` steps of ``model`` on
    ``batch``; ``trainer_kw`` (``microbatches``, ``loss_scale``) selects
    train_ring's accumulation."""
    from apex_tpu_torch.train import LMTrainer

    def run(dtype):
        tr = LMTrainer(model, params, dtype=dtype, **adam, **trainer_kw)
        grads, loss = [], []
        for _ in range(3):
            if tr.handle is None:
                (g, l_), fi = tr.loss_and_grad(*batch, **loss_kw), None
            else:
                g, fi, l_ = tr.accumulate_grads(*batch, **loss_kw)
            grads.append(g.clone())
            tr.apply_grads(g, fi)
            loss.append(float(l_))
        return tr.opt.state[0].master, grads, loss

    return crosscheck(torch, dispatch, phase, run, **trainer_kw)


def lm_crosscheck_phase(torch, dispatch):
    """A small LM (2 layers, embed 128, 2 heads of 64, vocab 512, S 257,
    batch 2) under ``adam_crosscheck`` at lr 1e-3."""
    from apex_tpu_torch.models import TransformerLM

    m = TransformerLM(vocab_size=512, max_seq_len=256, embed_dim=128,
                      num_heads=2, num_layers=2, attn_impl="fast",
                      head_chunk=512)
    params = m.init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, 512, (2, 257), generator=torch.Generator()
                         .manual_seed(3)).cuda()
    adam_crosscheck(torch, dispatch, "lm_crosscheck", m, params, (toks,),
                    {}, {"lr": 1e-3})


# -- gradient accumulation and the fp16_utils path on lm_bench's LM ----------

# train_ring's --grad-accum 2: phase 9's batch of 8 as 2 microbatches of 4;
# each kernel of the model runs once per microbatch
ACCUM_MICRO = 2
ACCUM_PER_STEP = {"axpby": ACCUM_MICRO, "adam": 1,
                  **{k: ACCUM_MICRO * LM_PER_STEP[k]
                     for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                               "ln_fwd", "ln_bwd")}}
ACCUM_KERNELS = ("axpby", "l2norm", "adagrad")
FP16_MAX_NORM = 1.0


def lm_accum_phase(torch, dispatch, model, params, peak9: int) -> tuple:
    """examples/lm/train_ring.py's accumulation (--grad-accum 2,
    --loss-scale dynamic) on phase 9's model and batch: step 1's
    accumulated flat grad against the one-batch grad of phase 9's step
    from the same masters, then 3 warm-up and 10 timed steps, then an inf
    in microbatch 2 alone."""
    from apex_tpu_torch.ops import flat
    from apex_tpu_torch.train import LMTrainer

    c = LM_SHAPE
    warm, timed = 3, 10
    toks = lm_batch(torch)
    one = LMTrainer(model, params, lr=1e-4)
    g_one, _ = one.loss_and_grad(toks)
    del one
    tr = LMTrainer(model, params, lr=1e-4, microbatches=ACCUM_MICRO,
                   loss_scale="dynamic")
    g_acc, fi, _ = tr.accumulate_grads(toks)
    check(float(fi) == 0.0, "lm_accum: step 1 overflowed")
    # bf16's own effect on the grad: the one-batch grad against the fp32
    # one of the plain versions, taken a sequence at a time (the plain
    # attention's fp32 scores of the whole batch would need ~50 GB)
    with dispatch.backend("reference"):
        f32 = LMTrainer(model, params, lr=1e-4, dtype=None,
                        microbatches=c["batch"])
        g_f32, _, _ = f32.accumulate_grads(toks)
        del f32
    d_acc, d_bf16 = (g_acc - g_one).abs(), (g_one - g_f32).abs()
    grad1 = {"mean": float(d_acc.mean()), "max": float(d_acc.max()),
             "bf16_mean": float(d_bf16.mean()),
             "bf16_max": float(d_bf16.max()),
             "abs_max": float(g_f32.abs().max())}
    del g_one, g_acc, g_f32, d_acc, d_bf16
    check(grad1["mean"] <= 1.5 * grad1["bf16_mean"]
          and grad1["max"] <= 1.5 * grad1["bf16_max"],
          f"lm_accum: step 1's accumulated grad differs from the one-batch "
          f"grad by {grad1}")
    # a fresh trainer from the same masters for the timed window
    tr = LMTrainer(model, params, lr=1e-4, microbatches=ACCUM_MICRO,
                   loss_scale="dynamic")
    r = timed_steps(torch, lambda: tr.step(toks), warm, timed)
    counts = r["counts"]
    tokens = c["batch"] * c["seq"]
    tok_s = tokens * timed / r["wall"]
    flops = lm_step_flops(tr.table.total)

    # an inf in microbatch 2 alone: the step skipped bit for bit, the scale
    # halved, one overflow counted
    def bad_loss(m, mb):
        t, poison = mb
        p = flat.unflatten(m, tr.table, dtype=torch.bfloat16)
        return model.loss(p, t) + m.sum() * poison

    poison = torch.tensor([0.0, float("inf")], device="cuda")
    micro = (toks.reshape(ACCUM_MICRO, -1, c["seq"]), poison)
    gs0, st0 = tr.opt.state[0], tr.amp_state[0]
    fg, fi, _ = tr.handle.accumulate_grads(bad_loss, gs0.master, micro,
                                           tr.amp_state)
    tr.apply_grads(fg, fi)
    gs1, st1 = tr.opt.state[0], tr.amp_state[0]
    inject = {"found_inf": float(fi),
              "master": bool(torch.equal(gs1.master, gs0.master)),
              "slots": all(bool(torch.equal(gs1.slots[k], gs0.slots[k]))
                           for k in gs0.slots),
              "step": int(gs1.step) == int(gs0.step),
              "scale_before": float(st0.scale),
              "scale_after": float(st1.scale),
              "overflows": int(st1.overflow_count) - int(st0.overflow_count)}
    row = {"phase": "lm_accum", "model": "TransformerLM", **c,
           "microbatches": ACCUM_MICRO, "loss_scale": "dynamic",
           "attn_impl": model.attn_impl, "dtype": "bfloat16",
           "masters": "float32", "optimizer": "FusedAdam(lr=1e-4)",
           **window_row(r, timed), "tokens_per_step": tokens,
           "tok_per_s": tok_s, "step_tflop": flops / 1e12,
           "mfu": flops * timed / r["wall"] / BF16_DENSE_OPS_S,
           "peak_mem_bytes_phase9": peak9, "grad1_err": grad1,
           "launches": {k: counts[k] for k in ACCUM_PER_STEP},
           "launches_per_step": {k: counts[k] / timed
                                 for k in ACCUM_PER_STEP},
           "inject_microbatch2": inject}
    emit(row)
    loss = r["loss"]
    check(all(math.isfinite(v) for v in loss)
          and loss[0] > loss[1] > loss[2],
          f"lm_accum: losses not finite, or the first three not falling "
          f"{loss}")
    check_counts("lm_accum", counts,
                 {k: n * timed for k, n in ACCUM_PER_STEP.items()})
    check(r["peak"] < peak9, f"lm_accum: peak memory {r['peak']} is not "
                             f"below phase 9's {peak9}")
    check(inject["found_inf"] == 1.0 and inject["master"] and inject["slots"]
          and inject["step"] and inject["overflows"] == 1
          and inject["scale_after"] == inject["scale_before"] / 2,
          f"lm_accum: the poisoned microbatch was not skipped {inject}")
    return counts, row


def fp16_grads(torch, model, opt, toks):
    """The grads of ``opt.scale_loss(loss)`` with respect to the model's
    param tree (``opt.params_tree()``, the masters in the model dtype),
    and the loss."""
    from apex_tpu_torch.ops import flat
    params = flat.tree_map(lambda t: t.detach().requires_grad_(True),
                           opt.params_tree())
    leaves, treedef = flat.tree_flatten(params)
    loss = model.loss(params, toks)
    grads = torch.autograd.grad(opt.scale_loss(loss), leaves)
    return flat.tree_unflatten(treedef, list(grads)), loss.detach()


def fp16opt_adagrad_phase(torch, dispatch, model, params) -> tuple:
    """The legacy fp16_utils path on phase 9's model and batch:
    ``FP16_Optimizer(FusedAdagrad(lr=1e-4, model_dtype=bf16),
    dynamic_loss_scale=True)``, each step the grads of the scaled loss,
    ``clip_master_grads(1.0)`` and ``step``: 3 warm-up and 5 timed steps
    (CUDA events around each step; each step reads the overflow flag on
    the host), each step's norm held against the plain version's on the
    same grads between the steps; then an injected overflow."""
    from apex_tpu_torch.fp16_utils import FP16_Optimizer
    from apex_tpu_torch.optimizers import FusedAdagrad
    from apex_tpu_torch.prof import numerics

    c = LM_SHAPE
    warm, timed = 3, 5
    toks = lm_batch(torch)
    opt = FP16_Optimizer(FusedAdagrad(params, lr=1e-4,
                                      model_dtype=torch.bfloat16),
                         dynamic_loss_scale=True)
    n_leaves = opt.optimizer._tables[0].num_segments
    losses, norms, rel = [], [], []
    step_ms = []
    torch.cuda.synchronize()
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        grads, loss = fp16_grads(torch, model, opt, toks)
        clipped, norm = opt.clip_master_grads(FP16_MAX_NORM, grads)
        opt.step(clipped)
        b.record()
        if i >= warm:
            torch.cuda.synchronize()
            step_ms.append(a.elapsed_time(b))
        check(not opt.overflow, f"fp16opt_adagrad: step {i} overflowed")
        with dispatch.backend("reference"):
            _, norm0 = opt.clip_master_grads(FP16_MAX_NORM, grads)
        rel.append(float((norm - norm0).abs() / norm0))
        losses.append(float(loss))
        norms.append(float(norm))
        del grads, clipped
    counts = read_counts()          # the plain norm checks launch none
    peak = torch.cuda.max_memory_allocated()
    coefs = [min(FP16_MAX_NORM / (n + 1e-6), 1.0) for n in norms]
    flops = lm_step_flops(opt.optimizer._tables[0].total)
    tokens = c["batch"] * c["seq"]
    per_step = {"l2norm": 1, "adagrad": 1, "scale": 1 + n_leaves}
    # an inf in one leaf's grad: the clip passes it through, the step is
    # skipped, the leaf named
    grads, _ = fp16_grads(torch, model, opt, toks)
    leaf = "layer_3/mlp/w1"
    grads["layer_3"]["mlp"]["w1"][7, 11] = float("inf")
    gs0, scale0 = opt.optimizer.state[0], opt.loss_scale
    opt.step(opt.clip_master_grads(FP16_MAX_NORM, grads)[0])
    gs1 = opt.optimizer.state[0]
    inject = {"overflow": opt.overflow,
              "master": bool(torch.equal(gs1.master, gs0.master)),
              "slots": bool(torch.equal(gs1.slots["sum"],
                                        gs0.slots["sum"])),
              "step": int(gs1.step) == int(gs0.step),
              "scale_before": scale0, "scale_after": opt.loss_scale,
              "culprits": opt.last_culprits,
              "leaves": numerics.tree_meta(grads).n}
    del grads
    step_ms_sorted = sorted(step_ms)
    row = {"phase": "fp16opt_adagrad", "model": "TransformerLM", **c,
           "dtype": "bfloat16", "masters": "float32",
           "optimizer": "FP16_Optimizer(FusedAdagrad(lr=1e-4), "
                        "dynamic_loss_scale=True)",
           "max_norm": FP16_MAX_NORM, "steps_timed": timed,
           "tok_per_s": tokens * timed / (sum(step_ms) / 1e3),
           "step_ms_p50": statistics.median(step_ms),
           "step_ms_p95": step_ms_sorted[min(timed - 1, int(round(
               0.95 * (timed - 1))))],
           "mfu": flops * timed / (sum(step_ms) / 1e3) / BF16_DENSE_OPS_S,
           "peak_mem_bytes": peak, "losses": losses, "norms": norms,
           "clip_coef": coefs, "norm_rel_err": rel, "grad_leaves": n_leaves,
           "launches": {k: counts[k] for k in per_step},
           "launches_per_step": {k: counts[k] / timed for k in per_step},
           "inject": inject}
    emit(row)
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"fp16opt_adagrad: losses not finite and falling {losses}")
    check(max(rel) <= 1e-5, f"fp16opt_adagrad: norms off the plain "
                            f"version's by {rel}")
    check_counts("fp16opt_adagrad", counts,
                 {k: n * timed for k, n in per_step.items()})
    check(inject["overflow"] and inject["master"] and inject["slots"]
          and inject["step"] and inject["scale_after"] == scale0 / 2
          and inject["culprits"][:1] == [{
              "path": leaf, "inf": 1, "nan": 0,
              "abs_max": inject["culprits"][0]["abs_max"]}],
          f"fp16opt_adagrad: the injected overflow {inject}")
    return counts, row


def fp16opt_crosscheck_phase(torch, dispatch):
    """The small LM of phase 10 (batch 4) under ``crosscheck``:
    ``LMTrainer(microbatches=2, loss_scale="dynamic")``, and
    ``FP16_Optimizer(FusedAdagrad)`` with clipping in both weight-decay
    modes."""
    from apex_tpu_torch.fp16_utils import FP16_Optimizer
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.optimizers import FusedAdagrad

    m = TransformerLM(vocab_size=512, max_seq_len=256, embed_dim=128,
                      num_heads=2, num_layers=2, attn_impl="fast",
                      head_chunk=512)
    params = m.init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, 512, (4, 257), generator=torch.Generator()
                         .manual_seed(3)).cuda()
    rows = [adam_crosscheck(torch, dispatch, "fp16opt_crosscheck", m,
                            params, (toks,), {}, {"lr": 1e-3},
                            microbatches=2, loss_scale="dynamic")]
    for w_mode in (False, True):
        def run(dtype, w_mode=w_mode):
            opt = FP16_Optimizer(FusedAdagrad(
                params, lr=1e-3, weight_decay=1e-2, adagrad_w_mode=w_mode,
                model_dtype=dtype), dynamic_loss_scale=True)
            grads, loss = [], []
            for _ in range(3):
                g, l_ = fp16_grads(torch, m, opt, toks)
                grads.append(opt.optimizer.flatten_grads(g)[0]
                             / opt.scaler_state.scale)
                clipped, _ = opt.clip_master_grads(0.25, g)
                opt.step(clipped)
                loss.append(float(l_))
            return opt.optimizer.state[0].master, grads, loss
        rows.append(crosscheck(torch, dispatch, "fp16opt_crosscheck", run,
                               optimizer="FP16_Optimizer(FusedAdagrad)",
                               adagrad_w_mode=w_mode, max_norm=0.25))
    return rows


# -- phases 14-16: the Seq2Seq Transformer's training step -------------------

# examples/seq2seq/train_translation.py's model at the Transformer-base
# widths (its class defaults: 6 + 6 layers, 512 wide, 8 heads of 64, FFN
# 2048, max_seq_len 512) with Vaswani et al.'s ~37000-token shared BPE
# vocabulary, attention "fast", dropout 0 (fairseq transformer_wmt_en_de's
# attention_dropout); its make_batch at B 128, seq_len 128
S2S = dict(src_vocab_size=37000, tgt_vocab_size=37000, max_seq_len=512,
           embed_dim=512, num_heads=8, num_encoder_layers=6,
           num_decoder_layers=6, ffn_mult=4, pad_id=0, attn_impl="fast")
S2S_BATCH, S2S_SEQ = 128, 128
S2S_PAD, S2S_BOS, S2S_EOS, S2S_RESERVED = 0, 1, 2, 3
# fairseq transformer_wmt_en_de's Adam and peak lr; Table 3's eps_ls
S2S_ADAM = dict(lr=5e-4, betas=(0.9, 0.98), eps=1e-9)
S2S_SMOOTHING = 0.1
# launches of each kernel in one step: 6 encoder self-attentions, 6
# decoder self- and 6 cross-attentions; 2 LayerNorms an encoder layer,
# 3 a decoder layer, and the two final ones; one loss; one Adam
S2S_PER_STEP = {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": 18,
                "flash_bwd_dq": 18, "flash_bwd_dkv": 18, "ln_fwd": 32,
                "ln_bwd": 32, "adam": 1}
S2S_FAMILIES = (("xent kernels", ("xent_fwd_kernel", "xent_bwd_kernel")),
                ) + LM_KERNEL_FAMILIES
# the plain witness's 3 losses within this share of the kernel path's
# (bf16 O2: the flash kernels round P and dS to bf16 where the plain
# versions keep fp32). Read 3.8e-6, 2.1e-6, 2.5e-6 on an H100 80GB HBM3
# at 700 W (PERF.md); the limit keeps 26 times the largest
S2S_WITNESS_RTOL = 1e-4


def s2s_batch(torch, rs, n: int, seq_len: int, vocab: int):
    """train_translation.py's make_batch (:99-111): sources of uniform
    length in [seq_len / 2, seq_len], padded; targets BOS, the reversed
    source through the fixed permutation of RandomState(7), EOS."""
    import numpy as np
    perm = np.arange(vocab)
    perm[S2S_RESERVED:] = np.random.RandomState(7).permutation(
        perm[S2S_RESERVED:])
    src = np.full((n, seq_len), S2S_PAD, np.int32)
    tgt = np.full((n, seq_len + 2), S2S_PAD, np.int32)
    for i in range(n):
        ln = rs.randint(seq_len // 2, seq_len + 1)
        s = rs.randint(S2S_RESERVED, vocab, ln)
        src[i, :ln] = s
        tgt[i, 0] = S2S_BOS
        tgt[i, 1:1 + ln] = perm[s[::-1]]
        tgt[i, 1 + ln] = S2S_EOS
    return torch.from_numpy(src).cuda(), torch.from_numpy(tgt).cuda()


def s2s_flops(c: dict, b: int, ts: int, tt: int) -> float:
    """Analytic FLOPs of one training step (3 × the forward's products,
    every token slot counted, padding included, as the step computes
    them): encoder layer QKV 6·E², out 2·E², MLP 4·E·F per source token
    and attention 4·Ts·E per source token; decoder layer self QKV and out
    8·E², causal attention 4·E·(Tt+1)/2, cross q and out 4·E² per target
    token and kv 4·E² per source token, cross attention 4·Ts·E, MLP
    4·E·F; the head 2·E·V per target token."""
    e, f, v = c["embed_dim"], c["ffn_mult"] * c["embed_dim"], \
        c["tgt_vocab_size"]
    enc = b * ts * (8 * e * e + 4 * e * f + 4 * ts * e)
    dec = b * tt * (8 * e * e + 2 * e * (tt + 1) + 4 * e * e + 4 * ts * e
                    + 4 * e * f) + b * ts * 4 * e * e
    head = b * tt * 2 * e * v
    fwd = c["num_encoder_layers"] * enc + c["num_decoder_layers"] * dec \
        + head
    return 3.0 * fwd


def s2s_kernel_phase(torch, timer) -> dict:
    """The Seq2Seq step's new kernel work at its shapes: the softmax
    cross-entropy kernels over the loss's fp32 logits [B·Tt, V] =
    [16512, 37000] at label smoothing 0.1, and the flash kernels with the
    source's key-padding kv_bias at the encoder's self-attention shape
    [B·H, Ts, D] = [1024, 128, 64] and the cross-attention's (Sq 129,
    Sk 128), bf16, against their plain versions on the same inputs."""
    import numpy as np
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attn as FA
    from apex_tpu_torch.ops import xentropy as XE

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    b, ts, tt = S2S_BATCH, S2S_SEQ, S2S_SEQ + 1
    n, v = b * tt, S2S["tgt_vocab_size"]
    eps = S2S_SMOOTHING
    x = torch.randn(n, v, generator=gen, device="cuda") * 2
    lab = torch.randint(S2S_RESERVED, v, (n,), generator=gen, device="cuda")
    lab[::4] = S2S_PAD
    lab[1] = v - 1
    g = torch.where(lab == S2S_PAD, 0.0,
                    torch.rand(n, generator=gen, device="cuda"))
    loss, lse = XE.xent_fwd(x, lab, eps)
    loss0, lse0 = XE.xent_fwd_plain(x, lab, eps)
    dx = XE.xent_bwd(x, lab, lse, g, eps)
    dx0 = XE.xent_bwd_plain(x, lab, lse, g, eps)
    torch.cuda.synchronize()
    # loss and lse within 1e-5 relative (the row's max and sums in another
    # order); dx bit-equal: given lse, each element is the plain version's
    # expf and _rn operations in its order
    rel = max(float(((loss - loss0).abs() / loss0.abs()).max()),
              float(((lse - lse0).abs() / lse0.abs()).max()))
    dx_max = float((dx - dx0).abs().max())
    dx_equal = bool(torch.equal(dx, dx0))
    repeat = bool(torch.equal(XE.xent_fwd(x, lab, eps)[0], loss)) and \
        bool(torch.equal(XE.xent_bwd(x, lab, lse, g, eps), dx))
    emit({"phase": "xent_tol", "loss_lse_max_rel_err": rel,
          "loss_max_abs_err": float((loss - loss0).abs().max()),
          "dx_max_abs_err": dx_max, "dx_bit_equal": dx_equal,
          "repeat_equal": repeat})
    check(rel <= 1e-5, f"xent_fwd: loss/lse off by {rel} relative")
    check(dx_equal, f"xent_bwd: dx differs from the plain version by up "
                    f"to {dx_max}")
    check(repeat, "xent: two runs on the same inputs differ")
    del dx0
    lab64 = lab.long()
    xl = x.clone().requires_grad_(True)
    lib_loss = F.cross_entropy(xl, lab64, label_smoothing=eps,
                               ignore_index=S2S_PAD, reduction="none")
    nbytes = n * v * 4
    b_ms, b_by = bound(nbytes + 8 * n + 8 * n, 6 * n * v)
    fwd = dict(kernel="xent_fwd", dtype="float32", shape=[n, v],
               smoothing=eps, max_abs_err=float((loss - loss0).abs().max()),
               max_rel_err=rel, tol="loss, lse: 1e-5 relative",
               per_step=S2S_PER_STEP["xent_fwd"],
               ms=timer(lambda: XE.xent_fwd(x, lab, eps)),
               plain_ms=timer(lambda: XE.xent_fwd_plain(x, lab, eps)),
               library_ms=timer(lambda: F.cross_entropy(
                   x, lab64, label_smoothing=eps, ignore_index=S2S_PAD,
                   reduction="none")),
               library_call="F.cross_entropy(label_smoothing=0.1, "
                            "ignore_index=0, reduction='none')",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: XE.xent_fwd(x, lab, eps)))
    b_ms, b_by = bound(2 * nbytes + 16 * n, 7 * n * v)
    bwd = dict(kernel="xent_bwd", dtype="float32", shape=[n, v],
               smoothing=eps, max_abs_err=dx_max, tol="dx: bit-equal",
               repeat_equal=repeat, per_step=S2S_PER_STEP["xent_bwd"],
               ms=timer(lambda: XE.xent_bwd(x, lab, lse, g, eps)),
               plain_ms=timer(lambda: XE.xent_bwd_plain(x, lab, lse, g,
                                                        eps)),
               library_ms=timer(lambda: torch.autograd.grad(
                   lib_loss, xl, g, retain_graph=True)),
               library_call="the backward of that F.cross_entropy",
               bound_ms=b_ms, bound_by=b_by,
               host_us=host_us(torch, lambda: XE.xent_bwd(
                   x, lab, lse, g, eps)))
    for r in (fwd, bwd):
        emit({"phase": "kernels", **r})
        rows[(r["kernel"], "float32")] = r
    del x, xl, lib_loss, dx, loss0, lse0

    # flash with the key-padding kv_bias: the sources' lengths as
    # make_batch draws them (uniform in [64, 128])
    H = S2S["num_heads"]
    D = S2S["embed_dim"] // H
    BH = b * H
    lengths = torch.from_numpy(np.random.RandomState(0).randint(
        ts // 2, ts + 1, b)).cuda()
    keep = torch.arange(ts, device="cuda")[None, :] < lengths[:, None]
    kvb = torch.where(keep, 0.0, FA.NEG_INF).repeat_interleave(H, dim=0)
    live_keys = int(lengths.sum()) * H        # summed over bh
    mask4 = torch.where(keep, 0.0, FA.NEG_INF).to(torch.bfloat16)[
        :, None, None, :]

    def rnd(s):
        return torch.randn(BH, s, D, generator=gen, device="cuda").to(
            torch.bfloat16)

    for shape, sq in (("encoder", ts), ("cross", tt)):
        q, do, k, v_ = rnd(sq), rnd(sq), rnd(ts), rnd(ts)
        kw = dict(causal=False, scale=D ** -0.5, kv_bias=kvb)
        o, lse = FA.flash_fwd(q, k, v_, **kw)
        delta = FA.flash_delta(o, do)
        dq = FA.flash_bwd_dq(q, k, v_, do, lse, delta, **kw)
        dk, dv = FA.flash_bwd_dkv(q, k, v_, do, lse, delta, **kw)
        o0, lse0 = FA.reference_attention(q, k, v_, return_lse=True, **kw)
        dq0, dk0, dv0 = FA.flash_bwd_plain(q, k, v_, do, lse, delta, **kw)
        torch.cuda.synchronize()
        errs = {w: flash_err(torch, a, b0) for w, a, b0 in
                (("o", o, o0), ("dq", dq, dq0), ("dk", dk, dk0),
                 ("dv", dv, dv0))}
        lse_err = float((lse - lse0).abs().max())
        emit({"phase": "flash_tol", "shape": shape, "kv_bias": True,
              "lse_err": lse_err, **errs})
        check(lse_err <= 1e-3, f"flash kv_bias {shape} lse: {lse_err}")
        for w, e in errs.items():
            check(e["used"] <= 1.0, f"flash kv_bias {shape} {w}: {e}")
        # dk, dv of masked keys are exactly zero
        masked = ~keep.repeat_interleave(H, dim=0)
        check(not dk[masked].any() and not dv[masked].any(),
              f"flash kv_bias {shape}: masked keys got a gradient")
        q4, k4, v4, do4 = (t.view(b, H, -1, D) for t in (q, k, v_, do))
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q4, k4, v4))
        lo = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask4)
        lib_bwd = timer(lambda: torch.autograd.grad(
            lo, (ql, kl, vl), do4, retain_graph=True))
        pairs = sq * live_keys               # scores the data needs
        sz_q, sz_k = BH * sq * D * 2, BH * ts * D * 2
        common = dict(dtype="bfloat16", shape=[BH, sq, ts, D],
                      kv_bias="[B·H, Sk] key padding", path_shape=shape,
                      per_step=6, causal=False)
        b_ms, b_by = bound(2 * sz_q + 2 * sz_k + 4 * BH * ts
                           + 4 * BH * sq, 4 * D * pairs, BF16_DENSE_OPS_S)
        r_fwd = dict(kernel="flash_fwd", **common,
                     max_abs_err=errs["o"]["max_abs_err"],
                     tol_used=errs["o"]["used"], lse_err=lse_err,
                     ms=timer(lambda: FA.flash_fwd(q, k, v_, **kw)),
                     plain_ms=timer(lambda: FA.reference_attention(
                         q, k, v_, return_lse=True, **kw)),
                     library_ms=timer(
                         lambda: F.scaled_dot_product_attention(
                             q4, k4, v4, attn_mask=mask4)),
                     bound_ms=b_ms, bound_by=b_by,
                     host_us=host_us(torch, lambda: FA.flash_fwd(
                         q, k, v_, **kw)))
        plain_bwd_ms = timer(lambda: FA.flash_bwd_plain(
            q, k, v_, do, lse, delta, **kw))
        b_ms, b_by = bound(3 * sz_q + 2 * sz_k + 4 * BH * ts
                           + 8 * BH * sq, 6 * D * pairs, BF16_DENSE_OPS_S)
        r_dq = dict(kernel="flash_bwd_dq", **common,
                    max_abs_err=errs["dq"]["max_abs_err"],
                    tol_used=errs["dq"]["used"],
                    ms=timer(lambda: FA.flash_bwd_dq(
                        q, k, v_, do, lse, delta, **kw)),
                    plain_ms=plain_bwd_ms, library_ms=lib_bwd,
                    library_covers="dq, dk and dv (one SDPA backward)",
                    plain_covers="dq, dk and dv (one flash_bwd_plain)",
                    bound_ms=b_ms, bound_by=b_by,
                    host_us=host_us(torch, lambda: FA.flash_bwd_dq(
                        q, k, v_, do, lse, delta, **kw)))
        b_ms, b_by = bound(2 * sz_q + 4 * sz_k + 4 * BH * ts
                           + 8 * BH * sq, 8 * D * pairs, BF16_DENSE_OPS_S)
        r_dkv = dict(kernel="flash_bwd_dkv", **common,
                     max_abs_err=max(errs["dk"]["max_abs_err"],
                                     errs["dv"]["max_abs_err"]),
                     tol_used=max(errs["dk"]["used"], errs["dv"]["used"]),
                     ms=timer(lambda: FA.flash_bwd_dkv(
                         q, k, v_, do, lse, delta, **kw)),
                     plain_ms=plain_bwd_ms, library_ms=lib_bwd,
                     library_covers="dq, dk and dv (one SDPA backward)",
                     plain_covers="dq, dk and dv (one flash_bwd_plain)",
                     bound_ms=b_ms, bound_by=b_by,
                     host_us=host_us(torch, lambda: FA.flash_bwd_dkv(
                         q, k, v_, do, lse, delta, **kw)))
        for r in (r_fwd, r_dq, r_dkv):
            emit({"phase": "kernels", **r})
            rows[(r["kernel"], "kv_bias", shape)] = r
        del q, k, v_, do, o, dq, dk, dv, o0, dq0, dk0, dv0, ql, kl, vl, lo
    return rows


def s2s_model():
    from apex_tpu_torch.models import Seq2SeqTransformer
    return Seq2SeqTransformer(**S2S)


def s2s_train_phase(torch, model, params) -> tuple:
    """The translation example's step at Transformer-base width on one
    card: O2 bf16 over fp32 flat masters through ``LMTrainer``, label
    smoothing 0.1, FusedAdam(5e-4, (0.9, 0.98), 1e-9), one make_batch
    batch reused every step; 3 warm-up and 10 timed steps, two profiled
    ones, and the plain witness: 3 steps from the same init under the
    plain versions, no kernel launched, losses within S2S_WITNESS_RTOL."""
    import math

    import numpy as np

    from apex_tpu_torch.ops import dispatch
    from apex_tpu_torch.train import LMTrainer

    warm, timed = 3, 10
    src, tgt = s2s_batch(torch, np.random.RandomState(0), S2S_BATCH,
                         S2S_SEQ, S2S["src_vocab_size"])

    def make():
        return LMTrainer(model, params, **S2S_ADAM)

    def step():
        return tr.step(src, tgt, label_smoothing=S2S_SMOOTHING)

    tr = make()
    r = timed_steps(torch, step, warm, timed)
    counts = r["counts"]
    ts, tt = src.shape[1], tgt.shape[1] - 1
    real_tgt = int((tgt[:, 1:] != S2S_PAD).sum())
    real_src = int((src != S2S_PAD).sum())
    slots = S2S_BATCH * (ts + tt)
    flops = s2s_flops(S2S, S2S_BATCH, ts, tt)
    prof = profile_steps(torch, step, S2S_FAMILIES)
    master, table = tr.opt.state[0].master, tr.table
    tr = None                           # the card's memory for the witness
    with dispatch.backend("reference"):
        wt = make()
        zero_counts()
        w_loss = [float(wt.step(src, tgt, label_smoothing=S2S_SMOOTHING))
                  for _ in range(3)]
        torch.cuda.synchronize()
        w_launches = read_counts()
        wt = None
    loss = r["loss"]
    w_rel = [abs(a - b) / abs(b) for a, b in zip(loss[:3], w_loss)]
    row = {"phase": "seq2seq_train", "model": "Seq2SeqTransformer",
           **{k: v for k, v in S2S.items()}, "batch": S2S_BATCH,
           "src_len": ts, "tgt_len": tt, "dtype": "bfloat16",
           "masters": "float32", "label_smoothing": S2S_SMOOTHING,
           "optimizer": f"FusedAdam({S2S_ADAM})", **window_row(r, timed),
           "params": table.total,
           "real_src_tokens_per_step": real_src,
           "real_tgt_tokens_per_step": real_tgt,
           "token_slots_per_step": slots,
           "tgt_tok_per_s": real_tgt * timed / r["wall"],
           "slot_tok_per_s": slots * timed / r["wall"],
           "step_tflop": flops / 1e12,
           "mfu": flops * timed / r["wall"] / BF16_DENSE_OPS_S,
           "ln_vocab": math.log(S2S["tgt_vocab_size"]),
           "launches": {k: counts[k] for k in S2S_PER_STEP},
           "launches_per_step": {k: counts[k] / timed
                                 for k in S2S_PER_STEP},
           "profile": prof,
           "plain_witness": {"losses": w_loss, "rel_err": w_rel,
                             "rtol": S2S_WITNESS_RTOL,
                             "launches": w_launches}}
    emit(row)
    check(all(np.isfinite(loss)), f"seq2seq_train: non-finite {loss}")
    check(abs(loss[0] - math.log(S2S["tgt_vocab_size"]))
          <= 0.1 * math.log(S2S["tgt_vocab_size"]),
          f"seq2seq_train: first loss {loss[0]} is not near ln V")
    check(loss[0] > loss[1] > loss[2],
          f"seq2seq_train: the first three losses do not fall {loss}")
    check_counts("seq2seq_train", counts,
                 {k: n * timed for k, n in S2S_PER_STEP.items()})
    check(not any(w_launches.values()),
          f"seq2seq_train witness: kernels launched {w_launches}")
    check(max(w_rel) <= S2S_WITNESS_RTOL,
          f"seq2seq_train witness: kernel losses {loss[:3]} against plain "
          f"{w_loss}")
    return counts, master, table


def s2s_decode_phase(torch, model, master, table) -> dict:
    """``greedy_decode`` of 8 held-out sources (make_batch from
    RandomState(1234)) to max_len 130 with the trained masters cast to
    bf16: decoded tokens a second; every row opens with BOS and is all
    PAD after its first EOS. The first decode step's logits with the
    kernels against the plain versions': on the same encoder memory (the
    step's own kernels are the LayerNorms) within atol 1e-2, and through
    the whole path (the encoder's six flash forwards with ``kv_bias``
    too) within 2 bf16 ulps of the largest logit: the logits are bf16,
    and the kernels' bf16 P moves each by rounding steps. The plain
    path's greedy streams are decoded too and their agreement reported
    (a near tie may turn a token)."""
    import numpy as np

    from apex_tpu_torch.ops import dispatch, flat

    params = flat.unflatten(master, table, dtype=torch.bfloat16)
    src, _ = s2s_batch(torch, np.random.RandomState(1234), 8, S2S_SEQ,
                       S2S["src_vocab_size"])
    max_len = S2S_SEQ + 2

    def decode():
        return model.greedy_decode(params, src, bos_id=S2S_BOS,
                                   eos_id=S2S_EOS, max_len=max_len)

    model.greedy_decode(params, src[:2], bos_id=S2S_BOS, eos_id=S2S_EOS,
                        max_len=4)        # first use of each product
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = decode()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    o = out.cpu().numpy()
    real = 0
    for row_ in o:
        eos = np.nonzero(row_ == S2S_EOS)[0]
        end = int(eos[0]) if eos.size else max_len - 1
        check(row_[0] == S2S_BOS, f"seq2seq_decode: row opens {row_[0]}")
        check(not row_[end + 1:].any(),
              "seq2seq_decode: tokens after EOS are not PAD")
        real += end

    @torch.no_grad()
    def first_step(mem=None):
        if mem is None:
            mem = model.encode(params, src)
        cross = model._cross_kv(params, mem)
        caches = model._self_caches(src.shape[0], max_len,
                                    torch.bfloat16, src.device)
        tok = torch.full((src.shape[0],), S2S_BOS, dtype=torch.int32,
                         device=src.device)
        logits, _ = model._decode_one(params, tok, 0, caches, cross,
                                      model._src_bias(src))
        return logits, mem

    logits, mem = first_step()
    with dispatch.backend("reference"):
        step_plain, _ = first_step(mem)
        path_plain, _ = first_step()
        o_plain = decode().cpu().numpy()
        torch.cuda.synchronize()
    step_err = float((logits - step_plain).abs().max())
    path_err = float((logits - path_plain).abs().max())
    top = path_plain.abs().max()
    path_lim = 2 * float(bf16_ulp(torch, top))
    row = {"phase": "seq2seq_decode", "sources": 8, "max_len": max_len,
           "seconds": secs, "steps": max_len - 1,
           "decoded_tok_per_s": 8 * (max_len - 1) / secs,
           "real_tok_per_s": real / secs, "real_tokens": real,
           "first_step_logits_err": step_err,
           "first_step_logits_err_whole_path": path_err,
           "whole_path_limit": path_lim, "logits_max_abs": float(top),
           "plain_streams_equal_rows": int((o == o_plain).all(1).sum()),
           "plain_streams_equal_tokens": float((o == o_plain).mean()),
           "launches": {k: counts[k] for k in ("flash_fwd", "ln_fwd")}}
    emit(row)
    check(step_err <= 1e-2,
          f"seq2seq_decode: first step's logits off by {step_err}")
    check(path_err <= path_lim,
          f"seq2seq_decode: first step's logits through the whole path "
          f"off by {path_err}, limit {path_lim}")
    check(counts["flash_fwd"] == S2S["num_encoder_layers"]
          and counts["ln_fwd"] > 0,
          f"seq2seq_decode: launches {counts}")
    return counts


def s2s_crosscheck_phase(torch, dispatch):
    """A small Seq2Seq Transformer (2 + 2 layers, embed 256, 4 heads of
    64, vocab 1000, source length 64, batch 8, ragged) under
    ``adam_crosscheck`` with the translation step's Adam and label
    smoothing."""
    import numpy as np

    from apex_tpu_torch.models import Seq2SeqTransformer

    cfg = dict(S2S, src_vocab_size=1000, tgt_vocab_size=1000,
               max_seq_len=128, embed_dim=256, num_heads=4,
               num_encoder_layers=2, num_decoder_layers=2)
    m = Seq2SeqTransformer(**cfg)
    params = m.init(torch.Generator().manual_seed(2))
    src, tgt = s2s_batch(torch, np.random.RandomState(3), 8, 64, 1000)
    adam_crosscheck(torch, dispatch, "seq2seq_crosscheck", m, params,
                    (src, tgt), {"label_smoothing": S2S_SMOOTHING}, S2S_ADAM)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA card", file=sys.stderr)
        return 2

    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.ops import cuda as kcuda
    from apex_tpu_torch.ops import dispatch
    from apex_tpu_torch.serve import poisson_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 0. device
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 1. build
    t0 = time.perf_counter()
    kcuda.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": kcuda.build_seconds is not None,
          "ptxas": ptxas_table(kcuda.build_log)})

    # 2. kernels against their plain versions; the training kernels over
    # the RN50 master store's layout
    from apex_tpu_torch.models import resnet50
    from apex_tpu_torch.ops import flat
    rn50 = resnet50()
    rn50_params, rn50_state = rn50.init(0)
    timer = Timer(torch)
    rows = kernel_phase(torch, timer)
    rows.update(train_kernel_phase(torch, timer,
                                   flat.make_table(rn50_params)))
    bn_calls = rn50_bn_calls(rn50, 256, 224)
    check(sum(bn_calls.values()) == 53, f"RN50 has 53 BNs, got {bn_calls}")
    rows.update(welford_kernel_phase(torch, timer, bn_calls))
    # the LM step's kernels over its flat master store's size
    lm = lm_model()
    lm_params = lm.init(torch.Generator().manual_seed(0))
    rows.update(lm_kernel_phase(torch, timer,
                                flat.make_table(lm_params).total))
    # the ImageNet step's optimizer kernels over the RN50 master store
    rows.update(optimizer_kernel_phase(torch, timer,
                                       flat.make_table(rn50_params)))
    # the Seq2Seq step's softmax cross-entropy and kv_bias flash kernels
    rows.update(s2s_kernel_phase(torch, timer))
    # the accumulation and fp16_utils kernels over the LM's master store,
    # and impl="auto"'s crossover
    rows.update(accum_kernel_phase(torch, timer,
                                   flat.make_table(lm_params).total))
    flash_crossover_phase(torch)

    # 3-4. the serving slice, dense then paged
    model = TransformerLM(vocab_size=32768, max_seq_len=1024,
                          embed_dim=1024, num_heads=8, num_layers=8)
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16)
    reqs = poisson_requests(32, rate=8.0, prompt_dist="uniform:16,96",
                            new_dist="uniform:8,48", vocab_size=32768,
                            seed=0, max_len=1024, prefill_chunk=32)
    dense, dstats, dcounts = serve_phase(torch, "dense", model, params, reqs)
    check(dcounts["decode_attention"]
          == model.num_layers * dstats["decode_steps"],
          f"dense: decode_attention launched {dcounts['decode_attention']}"
          f" times for {dstats['decode_steps']} steps")
    check(dcounts["ln_fwd"] > 0, "dense: ln_fwd never launched")
    check(dcounts["paged_decode_attention"] == 0,
          "dense: the paged kernel ran on the dense arena")
    paged, pstats, pcounts = serve_phase(
        torch, "paged", model, params, reqs, paged=True, page_size=32,
        kv_pages=8 * (1024 // 32) // 2)
    check(pcounts["paged_decode_attention"]
          == model.num_layers * pstats["decode_steps"],
          "paged: paged_decode_attention count != layers x steps")
    check(pcounts["ln_fwd"] > 0, "paged: ln_fwd never launched")
    check(pcounts["decode_attention"] == 0,
          "paged: the dense kernel ran on the paged arena")
    same = [a.tokens == b.tokens for a, b in zip(dense, paged)]
    emit({"phase": "paged_vs_dense", "requests_equal": sum(same),
          "requests": len(same)})
    check(all(same), "paged token streams differ from dense")

    # 5. the model with the kernels against the plain versions
    crosscheck_phase(torch, dispatch)

    # 6-8. the training slice
    del timer
    tcounts, _ = train_phase(torch, rn50, rn50_params, rn50_state,
                             bn_calls)
    # 11-12. the ImageNet example's step on the same model
    icounts = imagenet_phases(torch, rn50, rn50_params, rn50_state,
                              bn_calls)
    del rn50_params, rn50_state
    overflow_phase(torch)
    train_crosscheck_phase(torch, dispatch)

    # 9-10. the LM training slice, with train_ring's accumulation and the
    # fp16_utils path on the same model and batch
    lcounts, lrow = lm_train_phase(torch, lm, lm_params)
    acounts, _ = lm_accum_phase(torch, dispatch, lm, lm_params,
                                lrow["peak_mem_bytes"])
    fcounts, _ = fp16opt_adagrad_phase(torch, dispatch, lm, lm_params)
    del lm_params
    lm_crosscheck_phase(torch, dispatch)
    fp16opt_crosscheck_phase(torch, dispatch)

    # 13. the ImageNet step with the kernels against the plain versions
    imagenet_crosscheck_phase(torch, dispatch)

    # 14-16. the Seq2Seq Transformer's translation step, its greedy
    # decode and the small model against the plain versions
    s2s = s2s_model()
    s2s_params = s2s.init(torch.Generator().manual_seed(0))
    scounts, s2s_master, s2s_table = s2s_train_phase(torch, s2s, s2s_params)
    del s2s_params
    s2s_dec_counts = s2s_decode_phase(torch, s2s, s2s_master, s2s_table)
    del s2s_master
    s2s_crosscheck_phase(torch, dispatch)

    # 17. the kernels line, then the contract line
    launches = {k: dcounts[k] + pcounts[k] for k in dcounts}
    launches.update({k: tcounts[k] for k in TRAIN_KERNELS})
    for k in LM_PER_STEP:                # ln_fwd: serving and training
        launches[k] += lcounts[k]
    for counts in icounts.values():      # scale and BN: both RN50 steps
        for k in TRAIN_KERNELS + IMAGENET_KERNELS:
            launches[k] += counts[k]
    for k in S2S_PER_STEP:               # the translation step and decode
        launches[k] += scounts[k] + s2s_dec_counts[k]
    for counts in (acounts, fcounts):    # accumulation, fp16_utils
        for k, n in counts.items():
            launches[k] += n
    sources = {
        "decode_attention": (
            "apex_tpu_torch/ops/cuda/csrc/decode_attn.cu",
            "apex_tpu/ops/pallas/decode_attn.py:53"),
        "paged_decode_attention": (
            "apex_tpu_torch/ops/cuda/csrc/decode_attn.cu",
            "apex_tpu/ops/pallas/decode_attn.py:122"),
        "ln_fwd": ("apex_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                   "apex_tpu/ops/pallas/layer_norm.py:51"),
        "scale": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                  "apex_tpu/ops/pallas/multi_tensor.py:96"),
        "lamb_phase1": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                        "apex_tpu/ops/pallas/multi_tensor.py:452"),
        "lamb_phase2": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                        "apex_tpu/ops/pallas/multi_tensor.py:480"),
        "bn_moments": ("apex_tpu_torch/ops/cuda/csrc/welford.cu",
                       "apex_tpu/ops/pallas/welford.py:60"),
        "bn_backward_fused_reduce": (
            "apex_tpu_torch/ops/cuda/csrc/welford.cu",
            "apex_tpu/ops/pallas/welford.py:94"),
        "bn_backward_dx": ("apex_tpu_torch/ops/cuda/csrc/welford.cu",
                           "apex_tpu/ops/pallas/welford.py:152"),
        "adam": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                 "apex_tpu/ops/pallas/multi_tensor.py:270"),
        "ln_bwd": ("apex_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                   "apex_tpu/ops/pallas/layer_norm.py:105"),
        "flash_fwd": ("apex_tpu_torch/ops/cuda/csrc/flash_attn.cu",
                      "apex_tpu/contrib/multihead_attn/flash_attention.py"
                      ":181"),
        "flash_bwd_dq": ("apex_tpu_torch/ops/cuda/csrc/flash_attn.cu",
                         "apex_tpu/contrib/multihead_attn/"
                         "flash_attention.py:349"),
        "flash_bwd_dkv": ("apex_tpu_torch/ops/cuda/csrc/flash_attn.cu",
                          "apex_tpu/contrib/multihead_attn/"
                          "flash_attention.py:392"),
        "rowsumsq": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                     "apex_tpu/ops/pallas/multi_tensor.py:197"),
        "rowmaxabs": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                      "apex_tpu/ops/pallas/multi_tensor.py:219"),
        "sgd": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                "apex_tpu/ops/pallas/multi_tensor.py:354"),
        "novograd": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                     "apex_tpu/ops/pallas/multi_tensor.py:393"),
        "xent_fwd": ("apex_tpu_torch/ops/cuda/csrc/xentropy.cu",
                     "apex_tpu/ops/pallas/xentropy.py:55"),
        "xent_bwd": ("apex_tpu_torch/ops/cuda/csrc/xentropy.cu",
                     "apex_tpu/ops/pallas/xentropy.py:131"),
        "axpby": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                  "apex_tpu/ops/pallas/multi_tensor.py:127"),
        "l2norm": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                   "apex_tpu/ops/pallas/multi_tensor.py:169"),
        "adagrad": ("apex_tpu_torch/ops/cuda/csrc/multi_tensor.cu",
                    "apex_tpu/ops/pallas/multi_tensor.py:322"),
    }
    row_keys = {"decode_attention": ("decode_attention", "bfloat16"),
                "paged_decode_attention": ("paged_decode_attention",
                                           "bfloat16"),
                "ln_fwd": ("ln_fwd", "bfloat16", 8),
                # the training kernels at the step's own dtype (fp32
                # master grads and state)
                "scale": ("scale", "float32"),
                "lamb_phase1": ("lamb_phase1", "float32"),
                "lamb_phase2": ("lamb_phase2", "float32"),
                # the BN passes summed over the step's 53 BNs, bf16 rows
                "bn_moments": ("bn_moments", "bfloat16"),
                "bn_backward_fused_reduce": ("bn_backward_fused_reduce",
                                             "bfloat16"),
                "bn_backward_dx": ("bn_backward_dx", "bfloat16"),
                # the LM step's kernels at its shapes
                "adam": ("adam", "float32"), "ln_bwd": ("ln_bwd", "bfloat16"),
                "flash_fwd": ("flash_fwd", "bfloat16"),
                "flash_bwd_dq": ("flash_bwd_dq", "bfloat16"),
                "flash_bwd_dkv": ("flash_bwd_dkv", "bfloat16"),
                # the ImageNet step's optimizer kernels over RN50's buffer
                **{k: (k, "float32") for k in IMAGENET_KERNELS},
                # the translation step's loss over its fp32 logits
                "xent_fwd": ("xent_fwd", "float32"),
                "xent_bwd": ("xent_bwd", "float32"),
                # accumulation and fp16_utils over the LM's master store
                **{k: (k, "float32") for k in ACCUM_KERNELS}}
    kernels = []
    for name, (src, repl) in sources.items():
        r = rows[row_keys[name]]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": repl, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if name.startswith("flash_"):
            # the same kernels with the source's key-padding kv_bias, at
            # the translation step's encoder and cross-attention shapes
            entry["kv_bias"] = {
                shape: {k: rows[(name, "kv_bias", shape)][k] for k in
                        ("shape", "max_abs_err", "ms", "plain_ms",
                         "bound_ms", "bound_by", "library_ms")}
                for shape in ("encoder", "cross")}
        kernels.append(entry)
    check(len(kernels) == 23 and all(e["launches"] > 0 for e in kernels),
          f"kernels line: {[(e['name'], e['launches']) for e in kernels]}")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "nvidia_smi": nvidia_smi(
              "clocks.sm,power.draw,power.limit,temperature.gpu")})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
