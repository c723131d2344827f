#!/usr/bin/env python3
"""The fp32 flash dq (``flash_bwd_dq`` on fp32 inputs: ``flash_f32_dq`` to
head dim 256, ``flash_f32_d512_dq`` past it) on one NVIDIA card: its
margin on the fp32 flash rule, and its time against a parent tree's. Run
from the repository root on the card::

    python3 flash_f32_dq_check.py rule [D ...]    # D: 256 320 384 448 512
    python3 flash_f32_dq_check.py parent=DIR      # DIR: an unpacked parent

``rule`` takes causal inputs at BH 128, S 1024 (q, k, v, dO = N(0, 1),
an lse cotangent folded into delta, as ``tests/test_torch_cuda.py``'s
``_f32_case`` makes them) for each head dim and seeds 100 + D and 7-11,
and reads dq's largest |kernel − plain| over the rule's limit (2 ulps +
2^-14 of the larger of the row's and the tensor's RMS): overall, on row 0
and rows 1-3, where it is, and the kernel's and the plain version's
distance from an fp64 dq of the same inputs over rows 0-15 and the worst
rows (the plain version is the rule's reference, not the exact value).

``parent=DIR`` builds both trees' kernels at once (each into its own
``_build``), then runs one process a turn, parent, this tree, this tree,
parent, each importing its own tree's package and timing dq at [32, 1024,
320] and [16, 1024, 512] causal fp32: CUDA-event medians of 30 calls
after 3, without an L2 flush.

One JSON line each, the card's name and power limit first.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEEDS = (7, 8, 9, 10, 11)
TIMED = ((32, 1024, 320), (16, 1024, 512))


def _case(torch, FA, dev, bh, s, d, seed, **kw):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(bh, s, d, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(bh, s, d, generator=g, device=dev) for _ in range(2))
    o, lse = FA.reference_attention(q, k, v, None, return_lse=True, **kw)
    dlse = torch.randn(bh, s, generator=g, device=dev)
    return q, k, v, do, lse, FA.flash_delta(o, do, dlse)


def _limit(torch, got, want):
    def ulp(t):
        return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - 24)
    rms = torch.clamp(want.pow(2).mean(-1, keepdim=True).sqrt(),
                      min=float(want.pow(2).mean().sqrt()))
    return 2 * torch.maximum(ulp(got), ulp(want)) + 2.0 ** -14 * rms


def _dq64(torch, q, k, v, do, lse, delta, scale, rows):
    """fp64 dq of the query rows ``rows``, causal, every bh."""
    dev = q.device
    qd, dod = q[:, rows].double(), do[:, rows].double()
    kd, vd = k.double(), v.double()
    qi = torch.as_tensor(rows, device=dev)[:, None]
    kj = torch.arange(k.shape[1], device=dev)[None, :]
    s = torch.matmul(qd, kd.transpose(1, 2)) * scale
    p = torch.where(kj <= qi, torch.exp(s - lse[:, rows, None].double()),
                    torch.zeros_like(s))
    dp = torch.matmul(dod, vd.transpose(1, 2))
    ds = p * (dp - delta[:, rows, None].double())
    return torch.matmul(ds, kd) * scale


def rule_main(dims) -> int:
    import torch

    from apex_tpu_torch.ops import flash_attn as FA
    dev = torch.device("cuda")
    for d in dims:
        kw = dict(causal=True, scale=d ** -0.5)
        for seed in (100 + d, *SEEDS):
            args = _case(torch, FA, dev, 128, 1024, d, seed, **kw)
            dq = FA.flash_bwd_dq(*args, **kw)
            want = FA.flash_bwd_plain(*args, **kw)[0]
            lim = _limit(torch, dq, want)
            ratio = (dq - want).abs() / lim
            per_row = ratio.amax(-1).amax(0)                 # [S]
            at = int(ratio.argmax())
            worst = sorted(set((per_row > 0.5).nonzero()[:, 0].tolist()))
            rows = sorted(set(range(16)) | set(worst[:16]))
            ref = _dq64(torch, *args, kw["scale"], rows)
            lk = lim[:, rows].double()
            print(json.dumps({
                "d": d, "seed": seed, "max_ratio": float(ratio.max()),
                "at": [at // (1024 * d), (at // d) % 1024, at % d],
                "row0": float(per_row[0]), "rows1_3": float(per_row[1:4].max()),
                "kernel_vs_fp64": float(((dq[:, rows].double() - ref).abs()
                                         / lk).max()),
                "plain_vs_fp64": float(((want[:, rows].double() - ref).abs()
                                        / lk).max())}), flush=True)
            del args, dq, want, lim, ratio
    return 0


def time_turn(tree: str, label: str) -> int:
    """One process's turn: the tree's own package times dq."""
    sys.path.insert(0, tree)
    import torch

    import apex_tpu_torch
    from apex_tpu_torch.ops import flash_attn as FA
    if not apex_tpu_torch.__file__.startswith(tree):
        print(f"flash_f32_dq_check: imported {apex_tpu_torch.__file__}, not "
              f"{tree}'s package", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"tree": label}
    for bh, s, d in TIMED:
        kw = dict(causal=True, scale=d ** -0.5)
        args = _case(torch, FA, dev, bh, s, d, d, **kw)
        for _ in range(3):
            FA.flash_bwd_dq(*args, **kw)
        ms = []
        for _ in range(30):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            FA.flash_bwd_dq(*args, **kw)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        out[f"{bh}x{s}x{d}"] = statistics.median(ms)
    print(json.dumps(out), flush=True)
    return 0


def parent_main(parent: str) -> int:
    """Build both trees' kernels at once, then the turns."""
    trees = {"parent": str(Path(parent).resolve()), "change": str(ROOT)}
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from apex_tpu_torch.ops import cuda; cuda.build()")
    procs = {n: subprocess.Popen([sys.executable, "-c", build, t])
             for n, t in trees.items()}
    for n, p in procs.items():
        if p.wait():
            print(f"flash_f32_dq_check: the {n} tree did not build",
                  file=sys.stderr)
            return 1
    for label in ("parent", "change", "change", "parent"):
        rc = subprocess.run([sys.executable, __file__, "time", trees[label],
                             label]).returncode
        if rc:
            return rc
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_dq_check: needs an NVIDIA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["time"]:
        return time_turn(args[1], args[2])
    import chip_smoke as cs
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args[:1] == ["rule"]:
        return rule_main([int(a) for a in args[1:]]
                         or [256, 320, 384, 448, 512])
    if len(args) == 1 and args[0].startswith("parent="):
        return parent_main(args[0].split("=", 1)[1])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
