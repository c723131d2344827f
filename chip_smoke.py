#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
nonzero, and only a run where every phase passed prints the last line,
``{"ok": true, "device": {...}}``:

0. device — needs CUDA; prints the card's ``nvidia-smi`` name and power
   limit (also as a raw line of its own) and the torch / CUDA versions.
1. build — compiles the hand kernels from ``apex_tpu_torch/ops/cuda/csrc``
   with ``nvcc`` for ``sm_90a`` (all sources at once) and loads them.
2. kernels — each kernel against its plain PyTorch version on the card,
   at the serving path's shapes, bf16 and f32: max abs error against the
   stated tolerance, the kernel's time, the plain version's, one PyTorch
   library call's where one computes the same function, the least time
   the card could take (the bound), and the host time of one wrapper call
   (``host_us``; the eager decode step is host-bound).
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
6. the ``{"kernels": [...]}`` line, then the ``ok`` line.

Times are CUDA-event medians of single calls with the L2 cache flushed
before each and the stream held busy, so host launch time is not counted.
Bounds use the H100 SXM's published 3.35 TB/s and 67 TFLOP/s (fp32,
outside the tensor cores).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12

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


# -- phases 3-4: the serving slice --------------------------------------------

def counters():
    from apex_tpu_torch.ops import decode_attn as DA
    from apex_tpu_torch.ops import layer_norm as LN
    return {"decode_attention": DA.decode_attention,
            "paged_decode_attention": DA.paged_decode_attention,
            "ln_fwd": LN.ln_fwd}


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

    # 2. kernels against their plain versions
    timer = Timer(torch)
    rows = kernel_phase(torch, timer)

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

    # 6. the kernels line, then the contract line
    launches = {k: dcounts[k] + pcounts[k] for k in dcounts}
    sources = {
        "decode_attention": (
            "apex_tpu_torch/ops/cuda/csrc/decode_attn.cu",
            "apex_tpu/ops/pallas/decode_attn.py:53"),
        "paged_decode_attention": (
            "apex_tpu_torch/ops/cuda/csrc/decode_attn.cu",
            "apex_tpu/ops/pallas/decode_attn.py:122"),
        "ln_fwd": ("apex_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                   "apex_tpu/ops/pallas/layer_norm.py:51"),
    }
    kernels = []
    for name, (src, repl) in sources.items():
        key = (name, "bfloat16", 8) if name == "ln_fwd" \
            else (name, "bfloat16")
        r = rows[key]
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
