#!/usr/bin/env python3
"""The decode kernel on one NVIDIA card: the 1-query form of a parent
checkout and of this tree in turns, and the design variants of the
multi-row form (``apex_tpu_torch/ops/cuda/csrc/decode_attn.cu``) side by
side. Run from the repository root on the card::

    python3 decode_rows_ab.py parent=DIR   # DIR: an unpacked parent tree
    python3 decode_rows_ab.py variants

``parent=DIR`` builds both trees' kernels (at once, each into its own
``_build``), then runs one process a turn, parent, this tree, this tree,
parent, each importing its own tree's package: the 1-query
``decode_attention`` and ``paged_decode_attention`` (page 32) at
``chip_smoke.py`` phase 2's serve shapes (S 8, L 1024, lengths
``DECODE_LENGTHS``, bf16; H 8 at head dim 128 and 16 at 64), timed by this
tree's ``chip_smoke.Timer`` (CUDA-event medians, L2 flushed), with the
sha256 of the outputs (the same bits in both trees show the 1-query
arithmetic kept).

``variants`` builds ``decode_attn.cu`` alone once per variant
(``VARIANTS``: text substitutions, built at once into
``_ab/decode_rows/<variant>/``), swaps each library in for the package's
and, in turns (A, B, ..., B, A), times the multi-row form at phase 2's
rows (S 8, Q 4, H 8, hd 128, L 1024, rows around 900; bf16 dense and
paged, fp32, and hd 64 with 16 heads), each row held bit-equal to the
variant's 1-query call and its outputs hashed:

- ``committed``: the keys and values kept as loaded across the rows (each
  row's pass unpacks them), four blocks an SM in 16-bit, three in fp32;
- ``hoisted``: their fp32 unpacking left to the compiler, which hoists it
  out of the row loop (206 registers at hd 128, two blocks an SM);
- ``unroll2``: the row loop unrolled by two;
- ``lb3``, ``lb4``: three or four blocks an SM for every dtype.

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
OUT = ROOT / "_ab/decode_rows"

_LOOP = "  for (int r = 0; r < nq; ++r) {\n    int n = __ldg(len_s + r);"
_LB = ("__launch_bounds__(kThreads,\n" + " " * 34
       + "MULTI && sizeof(T) == 4 ? 3 : 4)")
_KEEP = """    if (MULTI) {
#pragma unroll
      for (int i = 0; i < kLaneKeys; ++i) {
        keep_raw(kraw[i]);
        keep_raw(vraw[i]);
      }
    }
"""
VARIANTS = {
    "committed": [],
    "hoisted": [(_KEEP, ""), (_LB, "__launch_bounds__(kThreads, "
                              "MULTI ? 2 : 4)")],
    "unroll2": [(_LOOP, "#pragma unroll 2\n" + _LOOP)],
    "lb3": [(_LB, "__launch_bounds__(kThreads, MULTI ? 3 : 4)")],
    "lb4": [(_LB, "__launch_bounds__(kThreads, 4)")],
}


def load_cs():
    """This tree's chip_smoke (its Timer and helpers) whichever tree
    runs."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def sha(torch, *ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def turn(tree: str, label: str) -> int:
    """One process's turn: the tree's 1-query kernel at phase 2's serve
    shapes."""
    import torch

    cs = load_cs()
    sys.path.insert(0, tree)
    from apex_tpu_torch.ops import decode_attn as DA
    assert Path(DA.__file__).resolve().is_relative_to(Path(tree).resolve())
    timer = cs.Timer(torch)
    lengths = torch.tensor(cs.DECODE_LENGTHS, dtype=torch.int32,
                           device="cuda")
    for hd, h in ((128, 8), (64, cs.LM_SERVE_HEADS)):
        gen = torch.Generator(device="cuda").manual_seed(hd)
        q = torch.randn(8, h, hd, generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn(8, h, 1024, hd, generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        kp, vp, table, _ = cs.paged_copy(torch, gen, k, v,
                                         cs.DECODE_LENGTHS, 32)
        dense = DA.decode_attention(q, k, v, lengths)
        paged = DA.paged_decode_attention(q, kp, vp, lengths,
                                          page_table=table)
        print(json.dumps({
            "tree": label, "head_dim": hd, "heads": h,
            "sha": sha(torch, dense, paged),
            "paged_equal": bool(torch.equal(dense, paged)),
            "ms": timer(lambda: DA.decode_attention(q, k, v, lengths)),
            "paged_ms": timer(lambda: DA.paged_decode_attention(
                q, kp, vp, lengths, page_table=table))}), flush=True)
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
            print(f"decode_rows_ab: the {n} tree did not build",
                  file=sys.stderr)
            return 1
    for label in ("parent", "change", "change", "parent"):
        rc = subprocess.run([sys.executable, __file__, "turn",
                             trees[label], label]).returncode
        if rc:
            return rc
    return 0


def build_variants(kc, cs) -> dict:
    """Every variant's library of decode_attn.cu (built at once), its entry
    points declared; prints each variant's registers and spills."""
    text = (CSRC / "decode_attn.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        out = text
        for old, new in subs:
            if out.count(old) != 1:
                raise SystemExit(f"decode_rows_ab: {name}: {old!r} found "
                                 f"{out.count(old)} times")
            out = out.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "decode_attn.cu").write_text(out)
        cmd = [kc._nvcc(), *kc._ARCH, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-Xptxas=-v", "-shared", "-I", str(CSRC),
               str(d / "decode_attn.cu"), "-o", str(d / "libdecode.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"decode_rows_ab: nvcc failed for {name}:\n"
                             f"{err[-4000:]}")
        forms = {n.split("decode_chunk_kernel", 1)[1]: e
                 for n, e in cs.ptxas_table(err).items()
                 if "decode_chunk_kernel" in n and "Lb1EEE" in n}
        print(json.dumps({"variant": name, "multi_row_ptxas": forms}),
              flush=True)
        so = ctypes.CDLL(str(OUT / name / "libdecode.so"))
        so.apex_decode_attention.argtypes = [
            I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P]
        so.apex_decode_attention.restype = I
        so.apex_decode_merge.argtypes = [I, P, P, P, I, I, I, I, I, P]
        so.apex_decode_merge.restype = I
        libs[name] = so
    return libs


def variants_main() -> int:
    import torch

    cs = load_cs()
    from apex_tpu_torch.ops import cuda as kc
    from apex_tpu_torch.ops import decode_attn as DA

    print(cs.nvidia_smi("name,power.limit"), flush=True)
    libs = build_variants(kc, cs)
    timer = cs.Timer(torch)
    S, Q, L = 8, cs.SPEC_K + 1, 1024
    lengths = torch.tensor([[b + j for j in range(Q)] for b in cs.ROW_BASES],
                           dtype=torch.int32, device="cuda")
    nmax = lengths.amax(dim=1).tolist()
    cases = {}
    for reading, hd, h, dt in (("bfloat16", 128, 8, torch.bfloat16),
                               ("float32", 128, 8, torch.float32),
                               ("hd64", 64, cs.LM_SERVE_HEADS,
                                torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(hd)
        q = torch.randn(S, Q, h, hd, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(S, h, L, hd, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        kp, vp, table, _ = cs.paged_copy(torch, gen, k, v, nmax, 32)
        cases[reading] = (q, k, v, kp, vp, table)
    order = list(libs) + list(libs)[::-1]
    for name in order:
        kc._lib = libs[name]
        for reading, (q, k, v, kp, vp, table) in cases.items():
            got = DA.decode_attention_rows(q, k, v, lengths)
            paged = DA.paged_decode_attention_rows(q, kp, vp, lengths,
                                                   page_table=table)
            rows_equal = all(bool(torch.equal(got[:, j], DA.decode_attention(
                q[:, j].contiguous(), k, v, lengths[:, j].contiguous())))
                for j in range(Q))
            print(json.dumps({
                "variant": name, "reading": reading, "sha": sha(torch, got),
                "rows_equal_one_query": rows_equal,
                "paged_equal": bool(torch.equal(got, paged)),
                "ms": timer(lambda: DA.decode_attention_rows(q, k, v,
                                                             lengths)),
                "paged_ms": timer(lambda: DA.paged_decode_attention_rows(
                    q, kp, vp, lengths, page_table=table))}), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_rows_ab: needs an NVIDIA card (CUDA is not "
              "available)", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["turn"]:
        return turn(args[1], args[2])
    if len(args) == 1 and args[0].startswith("parent="):
        return parent_main(args[0].split("=", 1)[1])
    if args == ["variants"]:
        return variants_main()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
