#!/usr/bin/env python3
"""Design variants of ``apex_tpu_torch/ops/cuda/csrc/flash_d512.cu`` (the
bf16/fp16 flash forward and dq at head dims 257-512) side by side on one
NVIDIA card.

Each variant is the committed source with text substitutions, built alone
by ``nvcc -shared`` (all variants at once) into ``_ab/d512/`` and driven
through the package's wrappers (``flash_d512_fwd``, ``flash_d512_dq``)
with the kernel library swapped for the variant's:

- ``committed``: the two consumer warpgroups trade partial scores; P
  enters PV as its rounding to 16 bits and what that left (two products);
- ``full_s``: each warpgroup takes QK^T over all of D (no trade);
- ``p_once``: P rounded to 16 bits once (one PV product), as the D <= 256
  forwards take it.

At [32, 1024, 320], [16, 1024, 320] and [16, 1024, 512] bf16 causal
(seeded inputs): each variant's o against ``reference_attention`` and dq
against ``flash_bwd_plain`` on the same lse and delta (``chip_smoke``'s
flash rule, the share of it used), and the whole chain as
``chip_smoke.py``'s phase 30 holds it: the variant's forward, delta of
its o, its dq, against the plain forward, delta of the plain o and the
plain dq; then the forward's and dq's times in turns (A, B, C, C, B, A;
``chip_smoke.Timer``: CUDA events, L2 flushed), and at D 320 the
committed forward with q, k and v first copied to 384 columns (the
padding the kernels' TMA fill saves). One JSON line each, every variant's
registers and spills first; the card's name and power limit first. Run
from the repository root on the card::

    python3 flash_d512_ab.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

CSRC = Path("apex_tpu_torch/ops/cuda/csrc")
OUT = Path("_ab/d512")

VARIANTS = {
    "committed": [],
    "full_s": [("cols_product<E, BN, D / 32>(sc, sm.q, sm.k[s], c0);",
                "cols_product<E, BN, D / 16>(sc, sm.q, sm.k[s], 0);"),
               ("    put<BN>(sm.x, par, wg, tid, sc);\n"
                "    bar_sync(kXBar, 256);\n", ""),
               ("    for (int i = 0; i < BN / 2; ++i) sc[i] += "
                "sm.x[par][wg ^ 1][i][tid];\n", "")],
    "p_once": [("    cols_by_tile<E, H, BN / 16>(acc, plo, sm.v[s], c0);\n",
                "")],
}
SHAPES = ((32, 1024, 320), (16, 1024, 320), (16, 1024, 512))
CHECK_HEADS = 8


def build(kc) -> dict:
    """Every variant's library (built at once), with the two entry points
    declared; prints each variant's registers and spills."""
    import chip_smoke as cs

    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "flash_d512.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:     # the first match: the forward's
            if old not in text:
                raise SystemExit(f"flash_d512_ab: {name}: {old!r} not found")
            text = text.replace(old, new, 1)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        cmd = [kc._nvcc(), *kc._ARCH, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-Xptxas=-v", "-shared", "-I", str(CSRC), str(cu),
               "-o", str(OUT / f"lib{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L, U = ctypes.c_longlong, ctypes.c_uint32
    tail = [P, L, P, L, U, U, F] + [I] * 7 + [F, P]
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"flash_d512_ab: nvcc failed for {name}:\n"
                             f"{err[-4000:]}")
        forms = {n.split("_d512_kernel")[0].split("flash_")[-1] + " "
                 + n.split("_d512_kernel")[1][:40]: e
                 for n, e in cs.ptxas_table(err).items()
                 if "_d512_kernel" in n}
        print(json.dumps({"variant": name, "ptxas": forms}), flush=True)
        so = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        so.apex_flash_d512_fwd.argtypes = [I] + [P] * 5 + [P, I] + tail
        so.apex_flash_d512_fwd.restype = I
        so.apex_flash_d512_dq.argtypes = [I] + [P] * 8 + [P, I] + tail
        so.apex_flash_d512_dq.restype = I
        libs[name] = so
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_d512_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from apex_tpu_torch.ops import cuda as kc
    from apex_tpu_torch.ops import flash_attn as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    libs = build(kc)
    timer = cs.Timer(torch, reps=15)
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    n = CHECK_HEADS
    for shape in SHAPES:
        bh, s, d = shape
        q, k, v, do = cs.form_inputs(torch, list(shape), torch.bfloat16)
        kw = dict(causal=True, scale=d ** -0.5)
        o0, lse0 = FA.reference_attention(q[:n], k[:n], v[:n],
                                          return_lse=True, **kw)
        chain0 = FA.flash_bwd_plain(q[:n], k[:n], v[:n], do[:n], lse0,
                                    FA.flash_delta(o0, do[:n]), **kw)[0]
        row = {"shape": list(shape), "dtype": "bfloat16", "causal": True}
        for name, so in libs.items():
            kc._lib = so
            o, lse = FA.flash_d512_fwd(q, k, v, **kw)
            delta = FA.flash_delta(o, do)
            dq = FA.flash_d512_dq(q, k, v, do, lse, delta, **kw)
            want = FA.flash_bwd_plain(q[:n], k[:n], v[:n], do[:n], lse[:n],
                                      delta[:n], **kw)[0]
            row[name] = {
                "o_used": cs.flash_err(torch, o[:n], o0)["used"],
                "dq_used": cs.flash_err(torch, dq[:n], want)["used"],
                "chain_dq_used": cs.flash_err(torch, dq[:n], chain0)["used"],
                "fwd_ms": [], "dq_ms": []}
        for name in order:
            kc._lib = libs[name]
            row[name]["fwd_ms"].append(timer(
                lambda: FA.flash_d512_fwd(q, k, v, **kw)))
            row[name]["dq_ms"].append(timer(
                lambda: FA.flash_d512_dq(q, k, v, do, lse, delta, **kw)))
        dp = FA.padded_head_dim(d)
        if dp != d:
            kc._lib = libs["committed"]
            row["committed"]["fwd_padded_copy_ms"] = timer(
                lambda: FA._unpad(FA.flash_d512_fwd(
                    *(FA._pad_d(t, dp) for t in (q, k, v)), **kw)[0], d))
        print(json.dumps(row), flush=True)
        del q, k, v, do, o0, lse0, chain0
    return 0


if __name__ == "__main__":
    sys.exit(main())
