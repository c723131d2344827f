#!/usr/bin/env python3
"""Design variants of ``apex_tpu_torch/ops/cuda/csrc/flash_d512.cu`` (the
bf16/fp16 flash forward and dq at head dims 257-512) and, with ``dkv``, of
``csrc/flash_d512_dkv.cu`` (dk/dv there) side by side on one NVIDIA card.

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
registers and spills first; the card's name and power limit first.

``dkv`` builds ``flash_d512_dkv.cu`` per variant (``DKV_VARIANTS``):

- ``committed``: the dv kernel's warpgroups trade partial scores over
  their halves of D; Pᵀ enters Pᵀ dO rounded to 16 bits once;
- ``full_s``: each of the dv kernel's warpgroups takes Sᵀ over all of D
  (no trade, 1.5x the dv kernel's first product);
- ``p_two``: Pᵀ enters Pᵀ dO as its rounding and what that left (two
  products), as the forward takes P;

and at [32, 1024, 320] and [16, 1024, 512] bf16 causal holds each
variant's dk and dv against ``flash_bwd_plain`` (the flash rule's share
used, bit-for-bit repeats) and the whole chain as phase 30 does (the
committed forward and dq, the variant's dk/dv, against the plain chain),
then times dk/dv in turns with the simple form's on the same inputs. Run
from the repository root on the card::

    python3 flash_d512_ab.py        # the forward and dq
    python3 flash_d512_ab.py dkv    # dk/dv
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
_DV_FRAG = "          f[ks][jj] = pack2<E>(pd[0], pd[1]);\n"
DKV_VARIANTS = {
    "committed": [],
    "full_s": [("cols_product<E, BQ, D / 32>(sc, sm.k, sm.q[s], c0);",
                "cols_product<E, BQ, D / 16>(sc, sm.k, sm.q[s], 0);"),
               ("    put<BQ>(sm.x, par, wg, tid, sc);\n"
                "    bar_sync(kXBar, 256);\n", ""),
               ("    for (int j = 0; j < BQ / 2; ++j) sc[j] += "
                "sm.x[par][wg ^ 1][j][tid];\n", "")],
    "p_two": [("    uint32_t f[BQ / 16][4];\n",
               "    uint32_t f[BQ / 16][4], flo[BQ / 16][4];\n"),
              (_DV_FRAG, _DV_FRAG + "          flo[ks][jj] = "
               "pack2_rest<E>(pd[0], pd[1], f[ks][jj]);\n"),
              ("    cols_by_tile<E, H, BQ / 16>(acc, f, sm.o[s], c0);"
               "   // dv += P^T dO\n",
               "    cols_by_tile<E, H, BQ / 16>(acc, f, sm.o[s], c0);\n"
               "    cols_by_tile<E, H, BQ / 16>(acc, flo, sm.o[s], c0);\n")],
}
SHAPES = ((32, 1024, 320), (16, 1024, 320), (16, 1024, 512))
DKV_SHAPES = ((32, 1024, 320), (16, 1024, 512))
CHECK_HEADS = 8


def build(kc, variants=None, source: str = "flash_d512.cu") -> dict:
    """Every variant's library of ``source`` (built at once), with its entry
    points declared; prints each variant's registers and spills."""
    import chip_smoke as cs

    variants = VARIANTS if variants is None else variants
    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / source).read_text()
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:     # the first match: the forward's
            if old not in text:
                raise SystemExit(f"flash_d512_ab: {name}: {old!r} not found")
            text = text.replace(old, new, 1)
        stem = f"{Path(source).stem}_{name}"
        cu = OUT / f"{stem}.cu"
        cu.write_text(text)
        cmd = [kc._nvcc(), *kc._ARCH, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-Xptxas=-v", "-shared", "-I", str(CSRC), str(cu),
               "-o", str(OUT / f"lib{stem}.so")]
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
        so = ctypes.CDLL(str(OUT / f"lib{Path(source).stem}_{name}.so"))
        if source == "flash_d512.cu":
            so.apex_flash_d512_fwd.argtypes = [I] + [P] * 5 + [P, I] + tail
            so.apex_flash_d512_fwd.restype = I
            so.apex_flash_d512_dq.argtypes = [I] + [P] * 8 + [P, I] + tail
            so.apex_flash_d512_dq.restype = I
        else:
            so.apex_flash_d512_dkv.argtypes = [I] + [P] * 8 + [P, I] + tail
            so.apex_flash_d512_dkv.restype = I
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
    if sys.argv[1:] == ["dkv"]:
        return dkv_main(torch, cs, kc, FA)
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


def dkv_main(torch, cs, kc, FA) -> int:
    """The ``dkv`` mode: every variant of ``flash_d512_dkv.cu`` held and
    timed against the simple form on the same inputs (module note)."""
    base = kc.lib()                 # the package's library: the forward, dq
    libs = build(kc, DKV_VARIANTS, "flash_d512_dkv.cu")
    timer = cs.Timer(torch, reps=15)
    order = list(libs) + list(libs)[::-1]
    n = CHECK_HEADS
    for shape in DKV_SHAPES:
        bh, s, d = shape
        q, k, v, do = cs.form_inputs(torch, list(shape), torch.bfloat16)
        kw = dict(causal=True, scale=d ** -0.5)
        kc._lib = base
        o, lse = FA.flash_d512_fwd(q, k, v, **kw)
        delta = FA.flash_delta(o, do)
        want = FA.flash_bwd_plain(q[:n], k[:n], v[:n], do[:n], lse[:n],
                                  delta[:n], **kw)
        o0, lse0 = FA.reference_attention(q[:n], k[:n], v[:n],
                                          return_lse=True, **kw)
        chain0 = FA.flash_bwd_plain(q[:n], k[:n], v[:n], do[:n], lse0,
                                    FA.flash_delta(o0, do[:n]), **kw)
        row = {"shape": list(shape), "dtype": "bfloat16", "causal": True,
               "simple_ms": timer(lambda: FA.flash_simt_dkv(
                   q, k, v, do, lse, delta, **kw))}
        for name, so in libs.items():
            kc._lib = so
            dk, dv = FA.flash_d512_dkv(q, k, v, do, lse, delta, **kw)
            dk2, dv2 = FA.flash_d512_dkv(q, k, v, do, lse, delta, **kw)
            torch.cuda.synchronize()
            row[name] = {
                "dk_used": cs.flash_err(torch, dk[:n], want[1])["used"],
                "dv_used": cs.flash_err(torch, dv[:n], want[2])["used"],
                "chain_dk_used": cs.flash_err(torch, dk[:n],
                                              chain0[1])["used"],
                "chain_dv_used": cs.flash_err(torch, dv[:n],
                                              chain0[2])["used"],
                "repeat_equal": bool(torch.equal(dk, dk2)
                                     and torch.equal(dv, dv2)),
                "ms": []}
            del dk, dv, dk2, dv2
        for name in order:
            kc._lib = libs[name]
            row[name]["ms"].append(timer(
                lambda: FA.flash_d512_dkv(q, k, v, do, lse, delta, **kw)))
        kc._lib = base
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, delta, want, o0, lse0, chain0
    return 0


if __name__ == "__main__":
    sys.exit(main())
