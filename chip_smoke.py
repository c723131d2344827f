#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
nonzero, and only a run where every phase passed prints the last line,
``{"ok": true, "device": {...}}``. Phases 0-5 are the serving slice,
phases 6-8 the training slice:

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
   RN50 step's 53 BNs, their times also summed over the step.
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
   in f32 O0 the masters within atol 1e-6; in bf16 O2 within 1.5 times
   bf16's own effect on them.
9. the ``{"kernels": [...]}`` line, then the ``ok`` line.

Times are CUDA-event medians of single calls with the L2 cache flushed
before each and the stream held busy, so host launch time is not counted.
Bounds use the H100 SXM's published 3.35 TB/s and 67 TFLOP/s (fp32,
outside the tensor cores); MFU its 989 TFLOP/s bf16 dense.
"""

from __future__ import annotations

import json
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


def bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
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


# -- phase 2, BatchNorm kernels: the welford passes at RN50's BN shapes ---------

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


# -- phases 3-4: the serving slice --------------------------------------------

TRAIN_KERNELS = ("scale", "lamb_phase1", "lamb_phase2", "bn_moments",
                 "bn_backward_fused_reduce", "bn_backward_dx")


def counters():
    from apex_tpu_torch.ops import decode_attn as DA
    from apex_tpu_torch.ops import layer_norm as LN
    from apex_tpu_torch.ops import multi_tensor as MT
    from apex_tpu_torch.ops import welford as WF
    return {"decode_attention": DA.decode_attention,
            "paged_decode_attention": DA.paged_decode_attention,
            "ln_fwd": LN.ln_fwd, "scale": MT.scale,
            "lamb_phase1": MT.lamb_phase1, "lamb_phase2": MT.lamb_phase2,
            "bn_moments": WF.bn_moments,
            "bn_backward_fused_reduce": WF.bn_backward_fused_reduce,
            "bn_backward_dx": WF.bn_backward_dx}


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
        hid_r, dense_r = step(False)
        _, paged_r = step(True)
    torch.cuda.synchronize()
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


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in KERNEL_FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile_steps(torch, trainer, x, y, n=2) -> dict:
    """Device time by kernel family and the device's idle share over
    ``n`` steps under ``torch.profiler`` (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam, top = {}, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        f = _family(e.key)
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
    losses = [tr.step(x, y) for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(timed)]
    t0 = time.perf_counter()
    for a, b in events:
        a.record()
        losses.append(tr.step(x, y))
        b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    loss = [float(v) for v in losses]
    flops = analytic_flops(model, image)
    img_s = batch * timed / wall
    prof = profile_steps(torch, tr, x, y)
    row = {"phase": "train", "model": "resnet50", "batch": batch,
           "image": image, "dtype": "bfloat16", "opt_level": "O2",
           "loss_scale": float(tr.handle.loss_scale(tr.amp_state)),
           "steps_timed": timed, "wall_s": wall, "img_per_s": img_s,
           "step_ms_mean": wall / timed * 1e3,
           "step_ms_p50": statistics.median(step_ms),
           "step_ms_p95": step_ms[min(timed - 1,
                                      int(round(0.95 * (timed - 1))))],
           "analytic_fwd_gflop_per_img": flops / 1e9,
           "mfu": 3 * flops * img_s / BF16_DENSE_OPS_S,
           "peak_mem_bytes": peak, "loss_first": loss[0],
           "loss_last": loss[-1], "losses": loss,
           "flat_total": tr.table.total,
           "segments": tr.table.num_segments, "launches": counts,
           "profile": prof}
    emit(row)
    check(all(np.isfinite(loss)), f"train: non-finite loss {loss}")
    check(loss[-1] < loss[0], f"train: loss did not fall {loss}")
    n_bn = sum(bn_calls.values())
    for k in TRAIN_KERNELS:
        want = timed * (n_bn if k.startswith("bn_") else 1)
        check(counts[k] == want,
              f"train: {k} launched {counts[k]} times in {timed} steps, "
              f"not {want}")
    return counts, row


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
        gr, loss_r = run("O0")
        hr, loss_hr = run("O2")
    torch.cuda.synchronize()
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
          "ptxas": sorted({ln.split(":", 1)[-1].strip()
                           for ln in kcuda.build_log.splitlines()
                           if "registers" in ln or "spill" in ln})})

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
    del rn50_params, rn50_state
    overflow_phase(torch)
    train_crosscheck_phase(torch, dispatch)

    # 9. the kernels line, then the contract line
    launches = {k: dcounts[k] + pcounts[k] for k in dcounts}
    launches.update({k: tcounts[k] for k in TRAIN_KERNELS})
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
                "bn_backward_dx": ("bn_backward_dx", "bfloat16")}
    kernels = []
    for name, (src, repl) in sources.items():
        r = rows[row_keys[name]]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "nvidia_smi": nvidia_smi(
              "clocks.sm,power.draw,power.limit,temperature.gpu")})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
