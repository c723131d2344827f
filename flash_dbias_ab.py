#!/usr/bin/env python3
"""The shared-bias gradient (``flash_bwd_dbias``) on one NVIDIA card: a
parent checkout's and this tree's in turns, and the design variants of
``apex_tpu_torch/ops/cuda/csrc/flash_dbias.cu`` side by side. Run from the
repository root on the card::

    python3 flash_dbias_ab.py parent=DIR   # DIR: an unpacked parent tree
    python3 flash_dbias_ab.py variants

``parent=DIR`` builds both trees' kernels (at once, each into its own
``_build``), then runs one process a turn, parent, this tree, this tree,
parent, each importing its own tree's package: at each reading (below) it
holds ``flash_bwd_dbias`` against ``flash_bwd_dbias_plain`` (the dtype's
flash rule, ``chip_smoke.flash_err``; the share of it used), hashes its
bits, and times it (``chip_smoke.Timer``: CUDA-event medians, L2
flushed). The readings are ``chip_smoke.DBIAS_READINGS`` ([32, 1024, 256]
and [32, 1024, 320] causal in bf16 and fp32, ViT's [1536, 197, 64] fp32
with dropout) and the two of phase 2 at D <= 128: ViT's shape in bf16
without dropout and [128, 1024, 64] bf16 causal, on the inputs of
``chip_smoke.dbias_case``.

``variants`` builds ``flash_dbias.cu`` once per variant (``VARIANTS``:
text substitutions, all built at once into ``_ab/dbias/``), swaps each
library in for the package's (the forward that makes lse stays the
package's), holds each against the plain version at its dtype family's
readings (the rule, bit-for-bit repeats) and times them in turns (A, B,
..., B, A):

- ``committed``: one consumer warpgroup of 64 queries, three 32 KB
  stages, two blocks an SM; fp32 four warps, two stages of 18 KB, two
  blocks an SM;
- ``w1_s2``, ``w1_s4``: two or four stages (two blocks an SM fit two or
  three, one block four);
- ``w2_s2``, ``w2_s4``: two consumer warpgroups of 64 queries sharing
  the block's K and V stages (blocks of 128 queries; the runs counted
  over their tiles), two or four stages of 48 KB;
- ``f32_s3``: fp32 three stages;
- ``f32_b3``: fp32 registers capped for three blocks an SM, not two;
- ``f32_u2``: fp32 dP's column quads unrolled by two;
- ``f32_w8``: fp32 blocks of eight warps over 128 queries sharing the
  K and V stages (one block an SM; the runs over their tiles).

One JSON line each, every variant's registers and spills first; the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "apex_tpu_torch/ops/cuda/csrc"
OUT = ROOT / "_ab/dbias"

# the readings at D <= 128 beside chip_smoke.DBIAS_READINGS
LOW_D = {"vit_bf16": ([1536, 197, 64], "bfloat16", False, False),
         "causal_d64": ([128, 1024, 64], "bfloat16", True, False)}

_W = "constexpr int kTcDbW = 1;"
_NS = "constexpr int kTcDbStages = 3;"
_F32NS = "constexpr int kF32DbStages = 2;"
_F32WR = "constexpr int kF32DbWarps = 4;"
VARIANTS = {
    "committed": [],
    "w1_s2": [(_NS, "constexpr int kTcDbStages = 2;")],
    "w1_s4": [(_NS, "constexpr int kTcDbStages = 4;")],
    "w2_s2": [(_W, "constexpr int kTcDbW = 2;"),
              (_NS, "constexpr int kTcDbStages = 2;")],
    "w2_s4": [(_W, "constexpr int kTcDbW = 2;"),
              (_NS, "constexpr int kTcDbStages = 4;")],
    "f32_s3": [(_F32NS, "constexpr int kF32DbStages = 3;")],
    "f32_b3": [("constexpr int kF32DbBlocks = 2;",
                "constexpr int kF32DbBlocks = 3;")],
    "f32_u2": [("constexpr int kF32DbDpUnroll = 1;",
                "constexpr int kF32DbDpUnroll = 2;")],
    "f32_w8": [(_F32WR, "constexpr int kF32DbWarps = 8;")],
}
# the variants each dtype family's readings are timed over
TC_VARIANTS = ("committed", "w1_s2", "w1_s4", "w2_s2", "w2_s4")
F32_VARIANTS = ("committed", "f32_s3", "f32_b3", "f32_u2", "f32_w8")


def readings(cs) -> dict:
    return {**cs.DBIAS_READINGS, **LOW_D}


def hold(torch, cs, FA, case, dt) -> dict:
    """One reading's result against the plain version and a repeat."""
    q, k, v, do, lse, delta, kw = case
    got = FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw)
    again = FA.flash_bwd_dbias(q, k, v, do, lse, delta, **kw)
    want = FA.flash_bwd_dbias_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    err = cs.flash_err(torch, got, want, dt)
    return {"used": err["used"], "max_abs_err": err["max_abs_err"],
            "repeat_equal": bool(torch.equal(got, again)),
            "sha": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
            [:16]}


def turn(tree: str, label: str) -> int:
    """One process's turn: this tree's package at every reading."""
    import importlib.util

    import torch

    # this tree's chip_smoke (a parent's lacks dbias_case), the tree's
    # package: chip_smoke imports the package inside its functions
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, tree)
    from apex_tpu_torch.ops import flash_attn as FA
    assert Path(FA.__file__).resolve().is_relative_to(Path(tree).resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch, reps=15)
    for name, (shape, dt, causal, drop) in readings(cs).items():
        case = cs.dbias_case(torch, shape, dt, causal, drop)
        row = hold(torch, cs, FA, case, getattr(torch, dt))
        q, k, v, do, lse, delta, kw = case
        row["ms"] = timer(lambda: FA.flash_bwd_dbias(q, k, v, do, lse, delta,
                                                     **kw))
        print(json.dumps({"tree": label, "reading": name, "shape": shape,
                          "dtype": dt, **row}), flush=True)
        del case, q, k, v, do, lse, delta, kw
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
            print(f"flash_dbias_ab: the {n} tree did not build",
                  file=sys.stderr)
            return 1
    for label in ("parent", "change", "change", "parent"):
        rc = subprocess.run([sys.executable, __file__, "turn",
                             trees[label], label]).returncode
        if rc:
            return rc
    return 0


def build_variants(kc) -> dict:
    """Every variant's library of flash_dbias.cu (built at once), its entry
    points declared; prints each variant's registers and spills."""
    import chip_smoke as cs

    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "flash_dbias.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"flash_dbias_ab: {name}: {old!r} not found")
            text = text.replace(old, new)
        cu = OUT / f"flash_dbias_{name}.cu"
        cu.write_text(text)
        cmd = [kc._nvcc(), *kc._ARCH, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-Xptxas=-v", "-shared", "-I", str(CSRC), str(cu),
               "-o", str(OUT / f"libflash_dbias_{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L, U = ctypes.c_longlong, ctypes.c_uint32
    tail = [P, L, P, L, U, U, F] + [I] * 7 + [F, P]
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"flash_dbias_ab: nvcc failed for {name}:\n"
                             f"{err[-4000:]}")
        forms = {n.split("_dbias_kernel")[0].split("flash_")[-1] + " "
                 + n.split("_dbias_kernel")[1][:40]: e
                 for n, e in cs.ptxas_table(err).items()
                 if "_dbias_kernel" in n}
        print(json.dumps({"variant": name, "ptxas": forms}), flush=True)
        so = ctypes.CDLL(str(OUT / f"libflash_dbias_{name}.so"))
        so.apex_flash_tc_dbias.argtypes = [I] + [P] * 8 + [P, I] + tail
        so.apex_flash_tc_dbias.restype = I
        so.apex_flash_f32_dbias.argtypes = [I] + [P] * 8 + [I] + [L] * 8 \
            + tail
        so.apex_flash_f32_dbias.restype = I
        libs[name] = so
    return libs


def variants_main() -> int:
    import torch

    import chip_smoke as cs
    from apex_tpu_torch.ops import cuda as kc
    from apex_tpu_torch.ops import flash_attn as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    package = kc.lib()                  # the package's forward, for lse
    libs = build_variants(kc)
    timer = cs.Timer(torch, reps=15)
    runs = FA.dbias_runs

    def use(name):
        kc._lib = libs[name]
        subs = "".join(n for _, n in VARIANTS[name])
        wide = "kTcDbW = 2" in subs or "kF32DbWarps = 8" in subs
        # blocks of 128 queries: the runs over their tiles
        FA.dbias_runs = (lambda bh, sq, sk, sms: runs(bh, -(-sq // 2), sk,
                                                      sms)) if wide else runs

    for name, (shape, dt, causal, drop) in readings(cs).items():
        names = F32_VARIANTS if dt == "float32" else TC_VARIANTS
        kc._lib = package
        q, k, v, do, lse, delta, kw = case = cs.dbias_case(
            torch, shape, dt, causal, drop)
        row = {"reading": name, "shape": shape, "dtype": dt}
        for n in names:
            use(n)
            row[n] = {**hold(torch, cs, FA, case, getattr(torch, dt)),
                      "ms": []}
        for n in names + names[::-1]:
            use(n)
            row[n]["ms"].append(timer(lambda: FA.flash_bwd_dbias(
                q, k, v, do, lse, delta, **kw)))
        print(json.dumps(row), flush=True)
        del case, q, k, v, do, lse, delta, kw
    FA.dbias_runs = runs
    kc._lib = package
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_dbias_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["turn"]:
        return turn(args[1], args[2])
    import chip_smoke as cs
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    if args[:1] == ["variants"]:
        return variants_main()
    if len(args) == 1 and args[0].startswith("parent="):
        return parent_main(args[0].split("=", 1)[1])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
