"""Synthetic serving traffic and the ``serving`` summary — counterpart of
``apex_tpu/serve/traffic.py``.

``parse_dist``, ``poisson_requests``, ``percentile_dict`` and
``summarize_serving`` are copied from the JAX package (lines 34-230 there)
so the port imports nothing of it; ``Request`` comes from the port's
engine. The same seed yields the same request set in both packages. The
span-derived views (``request_phases_from_spans`` and the rest) come with
the tracing hooks (ROADMAP.md Queue 1, slice 8).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from apex_tpu_torch.serve.engine import Request

__all__ = ["parse_dist", "poisson_requests", "percentile_dict",
           "summarize_serving"]


def parse_dist(spec: str) -> Callable:
    """``'fixed:N'`` | ``'uniform:LO,HI'`` (inclusive) |
    ``'geometric:MEAN'`` (1-based, heavy-tailed like real prompt/output
    lengths) -> a ``sampler(rng) -> int`` over numpy ``RandomState``."""
    try:
        name, _, arg = spec.partition(":")
        if name == "fixed":
            n = int(arg)
            if n < 1:
                raise ValueError
            return lambda rng: n
        if name == "uniform":
            lo, hi = (int(x) for x in arg.split(","))
            if not 1 <= lo <= hi:
                raise ValueError
            return lambda rng: int(rng.randint(lo, hi + 1))
        if name == "geometric":
            mean = float(arg)
            if mean < 1.0:
                raise ValueError
            p = 1.0 / mean
            return lambda rng: int(rng.geometric(p))
    except ValueError:
        pass
    raise ValueError(
        f"bad length distribution {spec!r}: expected fixed:N, "
        f"uniform:LO,HI (1 <= LO <= HI) or geometric:MEAN (>= 1)")


def poisson_requests(n: int, *, rate: float, prompt_dist: str,
                     new_dist: str, vocab_size: int, seed: int = 0,
                     max_len: Optional[int] = None,
                     prefill_chunk: int = 1) -> "list[Request]":
    """``n`` requests with Poisson arrivals at ``rate`` req/s
    (``rate <= 0``: everything arrives at t=0 — the deterministic-replay
    and drain-test shape) and lengths drawn from the given specs.

    With ``max_len`` set, sampled lengths are clamped so every request
    fits the pool (prompt padded to ``prefill_chunk`` + output <=
    ``max_len``) — the generator never produces a request the engine
    would refuse, which is what "zero dropped requests" is measured
    against."""
    rng = np.random.RandomState(seed)
    p_len = parse_dist(prompt_dist)
    o_len = parse_dist(new_dist)
    arrivals = (np.zeros(n) if rate <= 0 else
                np.cumsum(rng.exponential(1.0 / rate, size=n)))
    reqs = []
    for i in range(n):
        plen, new = p_len(rng), o_len(rng)
        if max_len is not None:
            # keep at least one generated token; pad-aware prompt cap
            plen = max(1, min(plen, max_len - 1))
            pad = -(-plen // prefill_chunk) * prefill_chunk
            while pad > max_len or plen + 1 > max_len:
                plen -= 1
                pad = -(-plen // prefill_chunk) * prefill_chunk
            new = max(1, min(new, max_len - plen))
        prompt = rng.randint(0, vocab_size, size=plen).astype(np.int32)
        reqs.append(Request(id=i, prompt=prompt, max_new=int(new),
                            arrival_s=float(arrivals[i])))
    return reqs


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile (same rule as telemetry_report)."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, round(q / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def percentile_dict(vals, qs=(50, 95, 99)) -> dict:
    s = sorted(vals)
    out = {f"p{q}": round(_percentile(s, q), 3) for q in qs}
    if s:
        out["max"] = round(s[-1], 3)
    return out


def summarize_serving(results, stats, *, offered_rps: float,
                      shed=None) -> dict:
    """The ``serving`` record payload from one engine run.
    All latencies in ms; percentiles nearest-rank over per-request
    values (TTFT, normalized token latency) or per-gap samples
    (inter-token latency).

    ``shed`` (r19, router runs): the router's shed rows — each a dict
    naming ``request``, the triggering ``rule`` and the ``replica``
    the load was heading for. SHED requests are a counted, attributed
    admission decision and are reported separately from ``dropped``:
    ``dropped`` counts only LOST requests (offered, neither completed
    nor shed — the zero-accounting failures the DROPPED flag exists
    for), so the zero-drop contract stays checkable in shed mode."""
    done = [r for r in results if r.finish_s is not None]
    shed = list(shed or [])
    shed_ids = {int(s["request"]) for s in shed}
    tokens_out = sum(len(r.tokens) for r in done)
    duration = max(stats["duration_s"], 1e-9)
    itl = [g * 1e3 for r in done for g in r.itl_s]
    qd = stats["queue_depth"]
    steps = stats["decode_steps"]
    sizes = stats.get("prefill_batch_sizes") or []
    shed_by_rule: dict = {}
    for s in shed:
        shed_by_rule[s["rule"]] = shed_by_rule.get(s["rule"], 0) + 1
    out = {
        "mode": stats["mode"],
        "fused": stats.get("fused"),
        "requests": len(results),
        "completed": len(done),
        "shed": len(shed),
        "shed_by_rule": shed_by_rule,
        "shed_rate": round(len(shed) / max(len(results), 1), 4),
        "dropped": sum(1 for r in results if r.finish_s is None
                       and int(r.id) not in shed_ids),
        "slots": stats["slots"],
        "offered_rps": round(float(offered_rps), 4),
        "duration_s": round(duration, 4),
        "tokens_out": tokens_out,
        "tokens_per_s": round(tokens_out / duration, 2),
        "decode_steps": steps,
        "prefill_chunks": stats["prefill_chunks"],
        # batched multi-slot prefill (r14): admissions per poll — the
        # serialized-prefill fix made attributable. The serialized path
        # reports batches of 1 (its per-request admissions), so the
        # mean-batch-size row is a direct A/B axis.
        "prefill_batches": stats.get("prefill_batches",
                                     len(stats.get("prefill_batch_sizes")
                                         or [])),
        "prefill_batch_mean": round(sum(sizes) / len(sizes), 3)
        if sizes else None,
        # raw decode-step cadence percentiles (host-observed dispatch->
        # sync), so --compare can carry the fused-decode p50 delta by
        # name without digging through step records
        "decode_step_ms": percentile_dict(stats.get("step_ms") or []),
        "ttft_ms": percentile_dict(
            [r.ttft_s * 1e3 for r in done if r.ttft_s is not None]),
        "token_lat_ms": percentile_dict(
            [r.token_lat_s * 1e3 for r in done
             if r.token_lat_s is not None]),
        "itl_ms": percentile_dict(itl),
        # router merges pass an exact per-replica denominator
        # (sum of steps_i * slots_i); single-engine runs derive it
        "slot_occupancy": round(
            stats["occupancy_sum"]
            / max(stats.get("occupancy_denom")
                  or steps * stats["slots"], 1), 4),
        "queue_depth": {"mean": round(sum(qd) / len(qd), 3) if qd
                        else 0.0,
                        "max": max(qd) if qd else 0},
        "arena_bytes": stats.get("arena_bytes"),
        # r20: reserved vs resident KV — the paged-vs-dense capacity
        # win as committed numbers, not a claim (both modes report
        # both, so the A/B is one --compare row)
        "paged": stats.get("paged"),
        "kv_reserved_bytes": stats.get("kv_reserved_bytes"),
        "kv_resident_peak_bytes": stats.get("kv_resident_peak_bytes"),
    }
    if stats.get("paged"):
        out.update(
            page_size=stats.get("page_size"),
            kv_pages=stats.get("kv_pages"),
            kv_pages_free=stats.get("kv_pages_free"),
            kv_pages_free_min=stats.get("kv_pages_free_min"),
        )
        if stats.get("prefix_lookups") is not None:
            hit = [r for r in done
                   if getattr(r, "prefix_tokens", 0) > 0
                   and r.ttft_s is not None]
            out.update(
                prefix_hits=stats.get("prefix_hits"),
                prefix_lookups=stats.get("prefix_lookups"),
                prefix_entries=stats.get("prefix_entries"),
                prefix_evictions=stats.get("prefix_evictions"),
                prefix_hit_requests=len(hit),
                # the cache-hit TTFT cliff, by name: p95 over ONLY the
                # requests whose prompt pages came from the cache
                prefix_hit_ttft_p95=(percentile_dict(
                    [r.ttft_s * 1e3 for r in hit])["p95"]
                    if hit else None),
            )
    if stats.get("spec_k"):
        # r21 speculative decoding: the acceptance ledger — schema-10
        # serving fields that attribute a tokens/s uplift to how often
        # the draft was right (spec_accept_mean of spec_k), with the
        # full accepted-length histogram for the shape of it
        out.update(
            spec_k=stats["spec_k"],
            spec_draft_tokens=stats.get("spec_draft_tokens"),
            spec_accepted_tokens=stats.get("spec_accepted_tokens"),
            spec_accept_mean=round(
                float(stats.get("spec_accept_mean") or 0.0), 4),
            spec_accept_hist=stats.get("spec_accept_hist"),
        )
    return out
