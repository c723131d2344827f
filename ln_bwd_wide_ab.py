#!/usr/bin/env python3
"""The wide LayerNorm backward (``ln_bwd_wide``) on one NVIDIA card: a
parent checkout's and this tree's in turns, and the design variants of
the one-pass kernel (``apex_tpu_torch/ops/cuda/csrc/ln_bwd_row.cu``) side
by side. Run from the repository root on the card::

    python3 ln_bwd_wide_ab.py parent=DIR   # DIR: an unpacked parent tree
    python3 ln_bwd_wide_ab.py variants
    python3 ln_bwd_wide_ab.py floor

``parent=DIR`` builds both trees' kernels (at once, each into its own
``_build``), then runs one process a turn, parent, this tree, this tree,
parent, each importing its own tree's package: at each reading
(``READINGS``) it holds ``ln_bwd_wide`` against ``ln_bwd_plain`` under
``chip_smoke.check_ln_bwd`` (this tree's: dx within one ulp plus 1e-5 of
its terms, the column sums within 1e-5 of their Σ|terms|), hashes its
bits, and times it and ``native_layer_norm_backward`` on the same inputs
(``chip_smoke.Timer``: CUDA-event medians, L2 flushed). The inputs are
``chip_smoke.wide_ln_readings``': x = 2·N(0, 1) + 0.5, dy = N(0, 1), γ =
N(0, 1) + 1 from the seed rows + F. Then, in turns again, each tree's own
``chip_smoke.wide_lm_train_phase`` (phase 24, the wide LM's step: step ms,
tok/s and the profile's "LN kernels" family a step).

``variants`` builds ``ln_bwd_row.cu`` (with ``ln_row_plan.cuh``, the
launch plan) once per variant (``VARIANTS``: text substitutions in either
file, built at once into ``_ab/ln_row/<variant>/``), swaps each library in
for the package's, holds each at every reading it takes (the rule,
bit-for-bit repeats) and times them in turns (A, B, ..., B, A):

- ``committed``: 15 consumer warps and a producer warp, one block an SM,
  as many stages as fit up to four;
- ``s2``, ``s3``: at most two or three stages;
- ``w8``, ``w12``, ``w16``: 8, 12 or 16 consumer warps (16 and the
  producer are 17 warps: five on one scheduler, 96 registers a thread);
- ``c2b2``: 16-bit rows too in 2-block clusters, each block half of every
  row, registers held for two blocks an SM, stages as fit in half an SM's
  shared memory less the 1 KB each block keeps (so two blocks share an
  SM), min(rows, 132) clusters; fp32 rows do not fit it.

``floor`` reads this tree's kernel against what bounds it in practice, at
F 12288 bf16 over 2048 to 16384 rows: its time with γ and without, an
elementwise add that moves the same bytes (dy and x read, one [rows, F]
written), and the bound; then, at 8192 rows, each of its two kernels'
device time under ``torch.profiler`` (the flush between calls as
``chip_smoke.Timer``'s).

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
OUT = ROOT / "_ab/ln_row"

# tag: rows, F, dtype, affine
READINGS = {
    "lm": (8192, 12288, "bfloat16", True),
    "f12290": (8192, 12290, "bfloat16", True),
    "f12289": (8192, 12289, "bfloat16", True),
    "f16384": (8192, 16384, "bfloat16", True),
    "f16_lm": (8192, 12288, "float16", True),
    "f32_lm": (8192, 12288, "float32", True),
    "520x9344": (520, 9344, "float32", True),
    "13x16384": (13, 16384, "float32", True),
}

_W = "constexpr int kLnbWarps = 15;"
_S = "constexpr int kLnbMaxStages = 4;"
VARIANTS = {
    "committed": [],
    "s2": [(_S, "constexpr int kLnbMaxStages = 2;")],
    "s3": [(_S, "constexpr int kLnbMaxStages = 3;")],
    "w8": [(_W, "constexpr int kLnbWarps = 8;")],
    "w12": [(_W, "constexpr int kLnbWarps = 12;")],
    "w16": [(_W, "constexpr int kLnbWarps = 16;")],
    "c2b2": [("__launch_bounds__(kLnbThreads, 1)",
              "__launch_bounds__(kLnbThreads, 2)"),
             ("for (int cluster = 1; cluster <= 2; ++cluster)",
              "for (int cluster = 2; cluster <= 2; ++cluster)"),
             ("constexpr int kLnbSmemMax = 232448;",
              "constexpr int kLnbSmemMax = 115712;"),
             ("std::min<long long>(rows, kLnbSms / cluster)",
              "std::min<long long>(rows, kLnbSms)"),
             ("plan.cluster == 2 && sizeof(T) != 4", "false"),
             ("} else if constexpr (sizeof(T) == 4) {",
              "} else if constexpr (true) {")],
}
# the files a variant's substitutions may touch
SOURCES = ("ln_bwd_row.cu", "ln_row_plan.cuh")


def inputs(torch, rows, f, dt, affine):
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda").manual_seed(rows + f)
    x = (torch.randn(rows, f, generator=gen, device="cuda") * 2
         + 0.5).to(dtype)
    dy = torch.randn(rows, f, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(f, generator=gen, device="cuda") + 1).to(dtype) \
        if affine else None
    b = torch.zeros_like(w) if affine else None
    return dy, x, w, b


def hold(torch, cs, LN, dy, x, w) -> tuple:
    """One reading against the plain version, a repeat, and its bits."""
    _, mean, inv = LN.ln_fwd_plain(x, w, None if w is None
                                   else torch.zeros_like(w), 1e-5)
    got = LN.ln_bwd_wide(dy, x, w, mean, inv)
    again = LN.ln_bwd_wide(dy, x, w, mean, inv)
    want = LN.ln_bwd_plain(dy, x, w, mean, inv)
    torch.cuda.synchronize()
    errs = cs.check_ln_bwd(torch, "ln_bwd_wide", got, want, dy, x, w, mean,
                           inv, row_sums=x.dtype == torch.float32)
    h = hashlib.sha256()
    for t in got:
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
    return {**errs, "repeat_equal": all(
        bool(torch.equal(a, c)) for a, c in zip(got, again)
        if a is not None), "sha": h.hexdigest()[:16]}, mean, inv


def load_cs():
    """This tree's chip_smoke (its rule and Timer) whichever tree runs."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def turn(tree: str, label: str) -> int:
    """One process's turn: this tree's package at every reading."""
    import torch

    cs = load_cs()
    sys.path.insert(0, tree)
    from apex_tpu_torch.ops import layer_norm as LN
    assert Path(LN.__file__).resolve().is_relative_to(Path(tree).resolve())
    timer = cs.Timer(torch, reps=15)
    for tag, (rows, f, dt, affine) in READINGS.items():
        dy, x, w, b = inputs(torch, rows, f, dt, affine)
        row, mean, inv = hold(torch, cs, LN, dy, x, w)
        _, lm, lr = torch.ops.aten.native_layer_norm(x, [f], w, b, 1e-5)
        row["ms"] = timer(lambda: LN.ln_bwd_wide(dy, x, w, mean, inv))
        row["library_ms"] = timer(
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [f], lm, lr, w, b, [True, affine, affine]))
        print(json.dumps({"tree": label, "reading": tag, "shape": [rows, f],
                          "dtype": dt, **row}), flush=True)
        del dy, x, w, b, lm, lr
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
            print(f"ln_bwd_wide_ab: the {n} tree did not build",
                  file=sys.stderr)
            return 1
    for kind in ("turn", "step"):
        for label in ("parent", "change", "change", "parent"):
            rc = subprocess.run([sys.executable, __file__, kind,
                                 trees[label], label]).returncode
            if rc:
                return rc
    return 0


def step_turn(tree: str, label: str) -> int:
    """One process's phase 24: the tree's own chip_smoke and package."""
    import importlib.util

    import torch

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(tree) / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _, row = cs.wide_lm_train_phase(torch)
    prof = row["profile"]
    print(json.dumps({"tree": label, "step_ms_mean": row["step_ms_mean"],
                      "step_ms_p50": row["step_ms_p50"],
                      "tok_per_s": row["tok_per_s"],
                      "by_family_ms": prof["by_family_ms"],
                      "idle_share": prof["idle_share"]}), flush=True)
    return 0


def build_variants(kc, cs) -> dict:
    """Every variant's library of ln_bwd_row.cu (built at once), its entry
    points declared; prints each variant's registers and spills."""
    texts = {f: (CSRC / f).read_text() for f in SOURCES}
    procs = {}
    for name, subs in VARIANTS.items():
        out = dict(texts)
        for old, new in subs:
            where = [f for f in SOURCES if old in out[f]]
            if len(where) != 1:
                raise SystemExit(f"ln_bwd_wide_ab: {name}: {old!r} found in "
                                 f"{where}")
            out[where[0]] = out[where[0]].replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in out.items():
            (d / f).write_text(text)
        # the variant's own files first, the rest (common.cuh, hopper.cuh)
        # from the package's sources
        cmd = [kc._nvcc(), *kc._ARCH, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-Xptxas=-v", "-shared", "-I", str(d), "-I",
               str(CSRC), str(d / "ln_bwd_row.cu"), "-o",
               str(d / "libln_bwd_row.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"ln_bwd_wide_ab: nvcc failed for {name}:\n"
                             f"{err[-4000:]}")
        forms = {n.split("row_kernelI", 1)[1]: e
                 for n, e in cs.ptxas_table(err).items()
                 if "ln_wide_bwd_row_kernel" in n}
        print(json.dumps({"variant": name, "ptxas": forms}), flush=True)
        so = ctypes.CDLL(str(OUT / name / "libln_bwd_row.so"))
        so.apex_layer_norm_bwd_row.argtypes = [I, I] + [P] * 9 + [L, I, P]
        so.apex_layer_norm_bwd_row.restype = I
        so.apex_layer_norm_bwd_row_plan.argtypes = [L, I, I, I, P]
        so.apex_layer_norm_bwd_row_plan.restype = I
        libs[name] = so
    return libs


def variants_main() -> int:
    import torch

    import chip_smoke as cs
    from apex_tpu_torch.ops import cuda as kc
    from apex_tpu_torch.ops import layer_norm as LN

    package = kc.lib()
    libs = build_variants(kc, cs)
    timer = cs.Timer(torch, reps=15)
    for tag, (rows, f, dt, affine) in READINGS.items():
        dy, x, w, b = inputs(torch, rows, f, dt, affine)
        row = {"reading": tag, "shape": [rows, f], "dtype": dt}
        run = []
        for n in libs:
            kc._lib = libs[n]
            try:
                plan = LN.row_plan(rows, f, x.element_size(),
                                   w.element_size() if affine else 0)
            except ValueError:
                continue             # the variant has no launch here
            if n == "c2b2" and x.element_size() == 4:
                continue             # c2b2 is a form of 16-bit rows
            got, mean, inv = hold(torch, cs, LN, dy, x, w)
            row[n] = {**got, "plan": plan, "ms": []}
            run.append(n)
        for n in run + run[::-1]:
            kc._lib = libs[n]
            row[n]["ms"].append(timer(lambda: LN.ln_bwd_wide(dy, x, w, mean,
                                                             inv)))
        print(json.dumps(row), flush=True)
        del dy, x, w, b
    kc._lib = package
    return 0


def floor_main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from apex_tpu_torch.ops import layer_norm as LN

    timer = cs.Timer(torch, reps=15)
    f = 12288
    for rows in (2048, 4096, 8192, 16384):
        dy, x, w, b = inputs(torch, rows, f, "bfloat16", True)
        _, mean, inv = LN.ln_fwd_plain(x, w, b, 1e-5)
        out = torch.empty_like(x)
        print(json.dumps({
            "rows": rows, "f": f, "dtype": "bfloat16",
            "ms": timer(lambda: LN.ln_bwd_wide(dy, x, w, mean, inv)),
            "no_gamma_ms": timer(lambda: LN.ln_bwd_wide(dy, x, None, mean,
                                                        inv)),
            "add_same_bytes_ms": timer(lambda: torch.add(dy, x, out=out)),
            "bound_ms": cs.bound(3 * rows * f * 2, 11 * rows * f)[0]}),
            flush=True)
        del dy, x, out
    dy, x, w, b = inputs(torch, 8192, f, "bfloat16", True)
    _, mean, inv = LN.ln_fwd_plain(x, w, b, 1e-5)
    for _ in range(3):
        LN.ln_bwd_wide(dy, x, w, mean, inv)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            timer.flush.zero_()
            LN.ln_bwd_wide(dy, x, w, mean, inv)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        name = next((k for k in ("ln_wide_bwd_row_kernel", "finalize_kernel")
                     if k in e.key), None)
        if name:
            # finalize_kernel's time includes its wait for the row kernel
            print(json.dumps({"kernel": name, "calls": e.count,
                              "device_us_a_call": e.device_time_total
                              / e.count}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ln_bwd_wide_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["turn"]:
        return turn(args[1], args[2])
    if args[:1] == ["step"]:
        return step_turn(args[1], args[2])
    import chip_smoke as cs
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    if args[:1] == ["variants"]:
        return variants_main()
    if args[:1] == ["floor"]:
        return floor_main()
    if len(args) == 1 and args[0].startswith("parent="):
        return parent_main(args[0].split("=", 1)[1])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
