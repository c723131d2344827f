"""The timing harness under host load: ``chip_smoke.Timer`` against the
form it replaced (one fixed sleep of 2M cycles ahead of every rep), each
timing impl="auto"'s crossover at head dim 64 (``chip_smoke.
flash_crossover_phase``) while busy processes share the host's cores.

Needs one CUDA card; from the repository root:

    python3 timer_load_ab.py [--loads 0,24] [--runs 3] [--out FILE]

Prints one JSON line per load: the host's enqueue time of the four timed
calls at [128, 128, 64] bf16 (behind a long sleep, so the card never
waits for them), and for each timer and run whether the crossover check
passed, its ``min_s``, the reps it made again, and the S 128-256
readings. ``--out`` also writes the list of those lines as JSON.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import statistics
import time

import torch

import chip_smoke as CS

GUARDED = CS.Timer


class FixedSleepTimer(CS.Timer):
    """The form ``Timer`` replaced: every rep behind one sleep of
    ``SLEEP_CYCLES``, however long the host takes to enqueue it."""

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def burn(stop) -> None:
    while not stop.is_set():
        sum(range(100_000))


def enqueue_us(fn, n: int = 50) -> dict:
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    ts.sort()
    return {"p50": ts[n // 2], "p90": ts[n * 9 // 10], "max": ts[-1]}


def host_times() -> dict:
    from apex_tpu_torch.contrib.multihead_attn import (flash_attention,
                                                       reference_attention)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(128, 128, 64, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd(fn):
        o = fn(qg, kg, vg, causal=False)
        torch.autograd.grad(o, (qg, kg, vg), do)

    with torch.no_grad():
        r = {"flash_fwd": enqueue_us(
                 lambda: flash_attention(q, k, v, causal=False)),
             "plain_fwd": enqueue_us(
                 lambda: reference_attention(q, k, v, causal=False))}
    r["flash_fwd_bwd"] = enqueue_us(lambda: fwd_bwd(flash_attention))
    r["plain_fwd_bwd"] = enqueue_us(lambda: fwd_bwd(reference_attention))
    return r


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loads", default="0,24",
                    help="busy processes on the host, one run set each")
    ap.add_argument("--runs", type=int, default=3,
                    help="crossover runs per timer and load")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("timer_load_ab: needs a CUDA card")
    from apex_tpu_torch.ops import cuda as C
    C.lib()
    rows: list = []
    CS.emit = rows.append
    lines = []
    for load in (int(x) for x in args.loads.split(",")):
        stop = mp.Event()
        procs = [mp.Process(target=burn, args=(stop,)) for _ in range(load)]
        for p in procs:
            p.start()
        try:
            time.sleep(1)
            res = {"load_procs": load, "enqueue_us": host_times()}
            for name, timer in (("fixed_sleep", FixedSleepTimer),
                                ("guarded", GUARDED)) * args.runs:
                CS.Timer = timer
                del rows[:]
                try:
                    row = CS.flash_crossover_phase(torch)
                    run = {"ok": True, "min_s": row["min_s"],
                           "redone": (row["timer_reps_redone"]
                                      if name == "guarded" else None)}
                except SystemExit as e:
                    run = {"ok": False, "error": str(e)}
                finally:
                    CS.Timer = GUARDED
                run["readings"] = [
                    {k: r[k] for k in ("causal", "s", "fwd_ms",
                                       "plain_fwd_ms", "fwd_bwd_ms",
                                       "plain_fwd_bwd_ms", "kernel_wins")}
                    for r in rows
                    if r.get("phase") == "flash_crossover" and r["s"] <= 256]
                res.setdefault(name, []).append(run)
        finally:
            stop.set()
            for p in procs:
                p.join()
        print(json.dumps(res), flush=True)
        lines.append(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
