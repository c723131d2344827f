#!/usr/bin/env python3
"""Design variants of ``apex_tpu_torch/ops/cuda/csrc/flash_f32.cu`` side by
side on one NVIDIA card.

Each variant is the committed source with text substitutions, built alone
by ``nvcc -shared`` (all variants at once) into ``_ab/v/<name>/`` and
called through ctypes with the wrappers' arguments. At each shape
([BH, S, D], causal, seeded inputs) every variant's forward is held
against ``reference_attention`` on the first 8 heads (o under
``chip_smoke.py``'s fp32 flash rule, lse within 1e-4) and repeated bit for
bit, then timed in turns, twice (``chip_smoke.Timer``: CUDA events, L2
flushed); at D 64 its dq and dk/dv likewise, against ``flash_bwd_plain``.
Then every variant's forward at edge cases (offsets, ragged tails, biases,
dropout). ``d256bwd`` does the same for dq and dk/dv at D 256 (dS too, at
the edge cases with a full bias), with the simple form's times on the same
inputs. ``d512`` builds ``flash_f32_d512.cu`` alone per variant and does
the same for its forward and dq at D 384 and 512 ([32, 1024, 320] and
[16, 1024, 512]), the simple form's forward and dq timed beside them;
``d512dkv`` does the same for its dk/dv (the quad kernel's blocks), the
simple dk/dv timed beside it. One JSON line each; the card's name and
power limit last. Run from the repository root on the card::

    python3 flash_f32_ab.py tile     # the forward's staged keys a tile
    python3 flash_f32_ab.py exp      # the forward's exponentials, P's split
    python3 flash_f32_ab.py d256     # the forward's warps and keys at D 256
    python3 flash_f32_ab.py d256bwd  # dq's and dk/dv's blocks at D 256
    python3 flash_f32_ab.py d256ops  # their instruction choices at D 256
    python3 flash_f32_ab.py d512     # the blocks of the forward and dq at
                                     # D 384 and 512
    python3 flash_f32_ab.py d512dkv  # the blocks of dk/dv there
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

CSRC = Path("apex_tpu_torch/ops/cuda/csrc")

_TILE = "  return D <= 64 ? 64 : D <= 128 ? 32 : 8;\n}"
_WARPS = "  return D <= 64 ? 8 : 4;\n}"
_EXP = [("      alpha[h] = ex2(m[h] - mx[h]);",
         "      alpha[h] = exp2f(m[h] - mx[h]);"),
        ("ex2(sc - m[i >> 1]) : 0.f;", "exp2f(sc - m[i >> 1]) : 0.f;")]
_SPLIT = "// x = big + small, both TF32\n"
_BITS = [(_SPLIT, """// x = big + small by integer rounding (to nearest, ties away)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_bits(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}
""" + _SPLIT)] + [
    (f"      split(p[j][{i}], ab[{k}], as[{k}]);",
     f"      split_bits(p[j][{i}], ab[{k}], as[{k}]);")
    for i, k in ((0, 0), (2, 1), (1, 2), (3, 3))]

# (bh, sq, sk, d, causal, q_start, k_start, bias rows, kv_bias, dropout)
_CASES = [(3, 1, 63, 1, True, 62, 0, None, False, 0.0),
          (3, 65, 127, 65, True, 64, 2, None, False, 0.0),
          (3, 200, 77, 128, True, 5, 130, None, False, 0.0),
          (3, 300, 250, 64, True, -40, 0, None, False, 0.0),
          (4, 197, 200, 64, False, 0, 0, None, True, 0.0),
          (4, 197, 197, 96, False, 0, 0, 1, False, 0.0),
          (4, 257, 257, 64, True, 0, 0, None, False, 0.1),
          (4, 129, 200, 128, True, 71, 0, "bh", True, 0.2)]
# the same kinds at head dims 129-256 (padded to 256)
_CASES_D256 = [(3, 1, 63, 256, True, 62, 0, None, False, 0.0),
               (3, 65, 127, 129, True, 64, 2, None, False, 0.0),
               (3, 200, 77, 256, True, 5, 130, None, False, 0.0),
               (3, 300, 250, 192, True, -40, 0, None, False, 0.0),
               (4, 197, 200, 256, False, 0, 0, None, True, 0.0),
               (4, 197, 197, 200, False, 0, 0, 1, False, 0.0),
               (4, 257, 257, 256, True, 0, 0, None, False, 0.1),
               (4, 129, 200, 256, True, 71, 0, "bh", True, 0.2)]



def _pair(warps=8, tile=16, own_raw=True, tile_raw=True) -> list:
    """The D-256 pair kernels' shape (dq and dk/dv alike) in place of the
    committed one, whatever it is: warps a block, rows a staged tile,
    whether the block's own rows and the tiles are kept raw (split as
    read) or split once."""
    return [(re.compile(rf"({name}\(\) {{\n  return )[^;]*;"),
             rf"\g<1>{str(value).lower()};")
            for name, value in (("p_warps", warps), ("p_tile", tile),
                                ("p_own_raw", own_raw),
                                ("p_tile_raw", tile_raw))]


# the pair kernels' instruction choices: small rounded for the tensor
# cores (half of TF32's unit added, its low bits left for them to drop)
# in place of truncated; their exponentials by exp2f in place of the
# committed ex2.approx.ftz; the second products eight n-tiles at a time in
# place of four (dk/dv's two: p_group), or dk/dv's four or one; dk/dv's
# P^T by the masked path alone, in place of the unmasked one taken inside
# its loop where the tile is all visible
_ROUND_SMALL = [("  small = __float_as_uint(__uint_as_float(x) - "
                 "__uint_as_float(big));",
                 "  small = __float_as_uint(__uint_as_float(x) - "
                 "__uint_as_float(big)) + 0x1000u;")]
_PAIR_EXP2F = [(f"{lhs}ex2({arg})", f"{lhs}exp2f({arg})") for lhs, arg in (
    ("x[n][i] = ", "x[n][i] * sl2 - lse2[i >> 1]"),
    ("x[n][i] = sc > kNegInf * 0.5f ? ", "sc - lse2[i >> 1]"),
    ("x[n][i] = ", "x[n][i] * a.scale * kLog2e - lb[c] * kLog2e"),
    ("x[n][i] = sc > kNegInf * 0.5f ? ", "sc - lb[c] * kLog2e"))]
_G8 = [("  constexpr int G = G0 ? G0 : N < 8 ? N : N == 8 ? 8 : 4;",
        "  constexpr int G = N < 8 ? N : 8;")]
# dq's or dk/dv's first products one k-step a fresh accumulator, not two
_DQ_CHAIN1, _DKV_CHAIN1 = ([(re.compile(r"(p_chain\(\) \{\n  return )[^;]*;"),
                             rf"\g<1>{r};")] for r in ("KV ? 2 : 1",
                                                        "KV ? 1 : 2"))
_DKV_G4, _DKV_G1 = ([(re.compile(r"(p_group\(\) \{\n  return )[^;]*;"),
                      rf"\g<1>KV ? {g} : 4;")] for g in (4, 1))
_DKV_OPEN_PATH = """          const int c = 8 * n + 2 * t + (i & 1);
          if (!EXTRA && all_visible(a, qb0, BQ, c0, 16)) {
            x[n][i] = ex2(x[n][i] * a.scale * kLog2e - lb[c] * kLog2e);
            continue;
          }
          const float sc = score2(a, bh, qb0 + c, c0 + g + 8 * (i >> 1),
                                  x[n][i]);
          x[n][i] = sc > kNegInf * 0.5f ? ex2(sc - lb[c] * kLog2e) : 0.f;"""
_DKV_MASKED = [(_DKV_OPEN_PATH, """          const int c = 8 * n + 2 * t + (i & 1);
          const float sc = score2(a, bh, qb0 + c, c0 + g + 8 * (i >> 1),
                                  x[n][i]);
          x[n][i] = sc > kNegInf * 0.5f ? ex2(sc - lb[c] * kLog2e) : 0.f;""")]

def _x(**forms) -> list:
    """``flash_f32_d512.cu``'s blocks in place of the committed ones, per
    form (``f384``, ``f512``: the forward at D 384, 512; ``q384``,
    ``q512``: dq): (pairs of warps, keys a tile, tiles raw) each; a form
    not named keeps the committed shape."""
    cur = {"f": {384: None, 512: None}, "q": {384: None, 512: None}}
    for name, shape in forms.items():
        cur[name[0]][int(name[1:])] = shape
    subs = []
    for k in "fq":
        for i, knob in enumerate(("pairs", "tile", "raw")):
            a, b = (cur[k][d][i] if cur[k][d] is not None else None
                    for d in (384, 512))
            if a is None and b is None:
                continue
            pat = re.compile(rf"(x{k}_{knob}\(\) {{\n  return D == 384 \? )"
                             rf"(\w+) : (\w+);")

            def sub(m, a=a, b=b):
                new_a = m.group(2) if a is None else str(a).lower()
                new_b = m.group(3) if b is None else str(b).lower()
                return f"{m.group(1)}{new_a} : {new_b};"
            subs.append((pat, sub))
    return subs


def _xk(**forms) -> list:
    """dk/dv's blocks at D 384 and 512 in place of the committed ones
    (``k384``, ``k512``: (quads of warps, queries a tile, n-tiles a pass of
    the second product)); a width not named keeps the committed shape."""
    subs = []
    for i, knob in enumerate(("quads", "tile", "group")):
        a, b = (forms[f"k{d}"][i] if f"k{d}" in forms else None
                for d in (384, 512))
        pat = re.compile(rf"(xk_{knob}\(\) {{\n  return D == 384 \? )"
                         rf"(\w+) : (\w+);")

        def sub(m, a=a, b=b):
            return (f"{m.group(1)}{m.group(2) if a is None else a} : "
                    f"{m.group(3) if b is None else b};")
        subs.append((pat, sub))
    return subs


# dk/dv's first products other than as two traded halves of D: each warp
# takes its product over all of D (``full_d``: warps 1 and 3 repeat warps
# 0 and 2), or warp 0 takes S^T and warp 2 dP^T over all of D while warps
# 1 and 3 wait (``one_warp``); the halves the others would trade read as
# zeros
_DKV_HALF = """    product_t<NH, NQ, LD, true, true>(x, own, nullptr,
                                      (kside ? ob : qb) + H * half,
                                      nullptr);     // half of KQ^T, VdO^T
    tile_out<NQ, LDX>(mine, x, g, t);
"""
_DKV_FULL = """    product_t<2 * NH, NQ, LD, true, true>(x, own - H * half, nullptr,
                                          kside ? ob : qb, nullptr);
    tile_out<NQ, LDX>(mine, x, g, t);
"""
_DKV_ZERO = [
    (f"    tile_in<NQ, LDX>({v}, xq + {o}16 * LDX, g, t);\n",
     f"    for (int n = 0; n < NQ; ++n)\n"
     f"      for (int i = 0; i < 4; ++i) {v}[n][i] = 0.f;\n")
    for v, o in (("x", ""), ("y", "3 * "))]
_DKV_FULL_D = [(_DKV_HALF, _DKV_FULL)] + [
    (a.replace("    tile_in", "      tile_in", 1) if "y" in a else a,
     b.replace("    for", "      for", 1) if "y" in a else b)
    for a, b in _DKV_ZERO]
_DKV_ONE_WARP = [(_DKV_HALF, "    if (half == 0) {\n" + "".join(
    "  " + ln + "\n" for ln in _DKV_FULL.splitlines()) + "    }\n")] + \
    _DKV_FULL_D[1:]


# dq's and the forward's edge cases at D 257-512
_CASES_D512 = [(3, 1, 63, 512, True, 62, 0, None, False, 0.0),
               (3, 65, 127, 257, True, 64, 2, None, False, 0.0),
               (3, 200, 77, 384, True, 5, 130, None, False, 0.0),
               (3, 300, 250, 448, True, -40, 0, None, False, 0.0),
               (4, 197, 200, 320, False, 0, 0, None, True, 0.0),
               (4, 197, 197, 300, False, 0, 0, 1, False, 0.0),
               (4, 257, 257, 512, True, 0, 0, None, False, 0.1),
               (4, 129, 200, 318, True, 71, 0, "bh", True, 0.2)]

SETS = {
    # the committed 64 keys a tile at D 64 and 32 at D 128, against 32 and
    # 16
    "tile": dict(variants={
        "bk64": [],
        "bk32": [(_TILE, "  return D <= 64 ? 32 : D <= 128 ? 32 : 8;\n}")],
        "d128_bk16": [(_TILE,
                       "  return D <= 64 ? 64 : D <= 128 ? 16 : 8;\n}")]},
        shapes=[[128, 4095, 64], [384, 2048, 128]], backward=False),
    # the committed ex2.approx.ftz against exp2f, and P split for the
    # second products by integer rounding in place of cvt.rna
    "exp": dict(variants={"ex2": [], "exp2f": _EXP, "ex2_bits": _BITS},
                shapes=[[128, 4095, 64]], backward=True),
    # the forward's block at D 256, where shared memory sets it: the
    # committed 4 warps and 8-key tiles against 3 warps and 16 keys, 2
    # warps and 16 keys, 5 warps and 8 keys
    "d256": dict(variants={
        "w4_bk8": [],
        "w3_bk16": [(_WARPS, "  return D <= 64 ? 8 : D <= 128 ? 4 : 3;\n}"),
                    (_TILE,
                     "  return D <= 64 ? 64 : D <= 128 ? 32 : 16;\n}")],
        "w2_bk16": [(_WARPS, "  return D <= 64 ? 8 : D <= 128 ? 4 : 2;\n}"),
                    (_TILE,
                     "  return D <= 64 ? 64 : D <= 128 ? 32 : 16;\n}")],
        "w5_bk8": [(_WARPS,
                    "  return D <= 64 ? 8 : D <= 128 ? 4 : 5;\n}")]},
        shapes=[[32, 1024, 256], [16, 4096, 256]], backward=False,
        cases=_CASES_D256),
    # dq's and dk/dv's blocks at D 256 (pairs of warps), the ones whose
    # shared memory fits: 8 warps over 64 rows with raw 16-row tiles (the
    # committed), with 8-row tiles split once; 6 warps with 16-row tiles
    # split once; 4 warps, the block's rows split once, raw 16-row tiles;
    # 4 warps, everything split once, 8-row tiles; 4 warps, raw rows and
    # 32-row tiles
    "d256bwd": dict(variants={
        "w8_t16_raw": [],
        "w8_t8": _pair(8, 8, True, False),
        "w6_t16": _pair(6, 16, True, False),
        "w4_t16_own": _pair(4, 16, False, True),
        "w4_t8": _pair(4, 8, False, False),
        "w4_t32_raw": _pair(4, 32, True, True)},
        shapes=[[32, 1024, 256], [64, 4096, 256]], backward=True,
        cases=_CASES_D256, mode="bwd256"),
    # ex2 was measured as a variant against exp2f and committed (PERF.md)
    "d256ops": dict(variants={
        "ex2": [], "exp2f": _PAIR_EXP2F, "round_small": _ROUND_SMALL,
        "g8": _G8, "dkv_g4": _DKV_G4, "dkv_g1": _DKV_G1,
        "dkv_masked": _DKV_MASKED, "dq_chain1": _DQ_CHAIN1,
        "dkv_chain1": _DKV_CHAIN1},
        shapes=[[32, 1024, 256], [64, 4096, 256]], backward=True,
        cases=_CASES_D256, mode="bwd256", seeds=range(100, 112)),
    # the forward's and dq's blocks at D 384 and 512: (pairs of warps, keys
    # a tile, tiles raw) per form, the shapes whose shared memory fits;
    # each build varies every form, so each form's candidates are read
    # across the builds
    "d512": dict(variants={
        "committed": [],
        "v2": _x(f384=(4, 8, True), f512=(2, 16, True), q384=(3, 8, True),
                 q512=(1, 16, True)),
        "v3": _x(f384=(3, 16, True), f512=(3, 8, True), q384=(2, 8, True),
                 q512=(1, 8, True)),
        "v4": _x(f384=(2, 16, True), f512=(2, 8, True), q384=(1, 16, True),
                 q512=(1, 8, False)),
        "v5": _x(f384=(4, 8, False), f512=(2, 8, False),
                 q384=(2, 8, False), q512=(2, 8, True)),
        "v6": _x(f384=(4, 16, True), f512=(4, 8, True), q384=(2, 16, True),
                 q512=(2, 8, True)),
        "v7": _x(f384=(4, 16, True), f512=(4, 8, True), q384=(3, 8, False),
                 q512=(2, 8, True))},
        shapes=[[32, 1024, 320], [16, 1024, 512]], cases=_CASES_D512,
        mode="d512", source="flash_f32_d512.cu"),
    # dk/dv's blocks at D 384 and 512: (quads, queries a tile, n-tiles a
    # pass) per width, the shapes whose shared memory and registers fit
    # (3 quads are 384 threads, 168 registers a thread); and its first
    # products other than as traded halves (``_DKV_FULL_D``,
    # ``_DKV_ONE_WARP``)
    "d512dkv": dict(variants={
        "committed": [],
        "full_d": _DKV_FULL_D, "one_warp": _DKV_ONE_WARP,
        "v2": _xk(k384=(2, 8, 4), k512=(1, 16, 2)),
        "v3": _xk(k384=(3, 8, 4), k512=(2, 8, 4)),
        "v4": _xk(k384=(2, 16, 4), k512=(1, 8, 2)),
        "v5": _xk(k384=(1, 16, 4), k512=(2, 8, 1))},
        shapes=[[32, 1024, 320], [16, 1024, 512]], cases=_CASES_D512,
        mode="d512dkv", source="flash_f32_d512.cu"),
}


def build(variants: dict, nvcc, arch, flags, ptxas_table,
          source: str = "flash_f32.cu") -> dict:
    src = (CSRC / source).read_text()
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if isinstance(old, re.Pattern) and callable(new):
                text, n = old.subn(new, text)
                n = min(n, 1) if n else 0
            elif isinstance(old, re.Pattern):
                text, n = old.subn(new, text)
            else:
                n = text.count(old)
                text = text.replace(old, new)
            if n != 1:
                raise SystemExit(f"variant {name}: {old!r} matches {n} "
                                 f"times in the source")
        d = Path("_ab/v") / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(text)
        cmd = [nvcc, *arch, *flags, "-I", str(CSRC), "-shared", "-o",
               str(d / "lib.so"), str(d / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    P, I, F, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
    tail = [P, L, P, L, ctypes.c_uint32, ctypes.c_uint32, F] + [I] * 7 + \
        [F, P]
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        print(json.dumps({"variant": name, "rc": p.returncode, "ptxas": {
            n[n.rindex("f32"):][:40]: e for n, e in ptxas_table(err).items()
            if "f32" in n}}), flush=True)
        if p.returncode != 0:             # reported, left out
            print(json.dumps({"variant": name, "error": err[-6000:]}),
                  flush=True)
            continue
        so = ctypes.CDLL(str(Path("_ab/v") / name / "lib.so"))
        wide = source == "flash_f32_d512.cu"
        fwd = "apex_flash_f32_d512_fwd" if wide else "apex_flash_f32_fwd"
        getattr(so, fwd).argtypes = [I] + [P] * 5 + [L] * 6 + tail
        for fn in (("apex_flash_f32_d512_dq", "apex_flash_f32_d512_dkv")
                   if wide else
                   ("apex_flash_f32_dq", "apex_flash_f32_dkv")):
            getattr(so, fn).argtypes = [I] + [P] * 8 + [L] * 8 + tail
        libs[name] = so
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2 \
            or sys.argv[1] not in SETS:
        print(f"usage on an NVIDIA card: python3 flash_f32_ab.py "
              f"{{{','.join(SETS)}}}", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from apex_tpu_torch.ops import cuda as kcuda
    from apex_tpu_torch.ops import flash_attn as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SETS[sys.argv[1]]
    libs = build(cfg["variants"], kcuda._nvcc(), kcuda._ARCH, kcuda._FLAGS,
                 cs.ptxas_table, cfg.get("source", "flash_f32.cu"))

    def fwd(so, q, k, v, kw):
        d = q.shape[-1]
        qp, kp, vp = (FA._readable(FA._pad_d(t, FA.padded_head_dim(d)))
                      for t in (q, k, v))
        args, _keep = FA._tail("ab", qp, kp, kw.get("kv_bias"),
                               kw.get("bias"), kw.get("dropout_rate", 0.0),
                               kw.get("dropout_seed", 0), kw["causal"],
                               kw["scale"], kw.get("q_start", 0),
                               kw.get("k_start", 0))
        o = torch.empty(qp.shape, device="cuda")
        lse = torch.empty(qp.shape[:2], device="cuda")
        err = so.apex_flash_f32_fwd(0, qp.data_ptr(), kp.data_ptr(),
                                    vp.data_ptr(), o.data_ptr(),
                                    lse.data_ptr(), *FA._strides(qp, kp, vp),
                                    *args)
        kcuda.check(err, "apex_flash_f32_fwd")
        return o[..., :d], lse

    def bwd(so, which, q, k, v, do, lse, delta, kw):
        args, _keep = FA._tail("ab", q, k, None, None, 0.0, 0, True,
                               kw["scale"], 0, 0)
        strides = FA._strides(q, k, v, do)
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
        if which == "dq":
            dq = torch.empty_like(q)
            kcuda.check(so.apex_flash_f32_dq(0, *ptrs, dq.data_ptr(), None,
                                             *strides, *args), "dq")
            return (dq,)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        kcuda.check(so.apex_flash_f32_dkv(0, *ptrs, dk.data_ptr(),
                                          dv.data_ptr(), *strides, *args),
                    "dkv")
        return dk, dv

    timer = cs.Timer(torch)
    n = cs.FLASH_CHECK_HEADS
    if cfg.get("mode") in ("bwd256", "d512", "d512dkv"):
        {"bwd256": bwd256, "d512": d512, "d512dkv": d512dkv}[cfg["mode"]](
            torch, cs, kcuda, FA, libs, cfg, timer)
        print(cs.nvidia_smi("name,power.limit"))
        return 0
    for shape in cfg["shapes"]:
        bh, s, d = shape
        q, k, v, do = cs.form_inputs(torch, shape, torch.float32)
        kw = dict(causal=True, scale=d ** -0.5)
        o0, lse0 = FA.reference_attention(q[:n], k[:n], v[:n],
                                          return_lse=True, **kw)
        res = {name: {} for name in libs}
        for name, so in libs.items():
            o, lse = fwd(so, q, k, v, kw)
            o2, lse2 = fwd(so, q, k, v, kw)
            torch.cuda.synchronize()
            res[name].update(
                tol_used=cs.flash_err(torch, o[:n], o0,
                                      torch.float32)["used"],
                lse_err=float((lse[:n] - lse0).abs().max()),
                repeat_equal=bool(torch.equal(o, o2)
                                  and torch.equal(lse, lse2)))
            del o, lse, o2, lse2
        del o0, lse0
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                so = libs[name]
                res[name].setdefault("fwd_ms", []).append(
                    timer(lambda: fwd(so, q, k, v, kw)))
        if cfg["backward"] and d == 64:
            o, lse = FA.flash_simt_fwd(q, k, v, **kw)
            delta = FA.flash_delta(o, do)
            want = FA.flash_bwd_plain(q[:n], k[:n], v[:n], do[:n], lse[:n],
                                      delta[:n], **kw)
            for name, so in libs.items():
                got = bwd(so, "dq", q, k, v, do, lse, delta, kw) + \
                    bwd(so, "dkv", q, k, v, do, lse, delta, kw)
                torch.cuda.synchronize()
                res[name]["bwd_tol_used"] = [
                    cs.flash_err(torch, a[:n], b, torch.float32)["used"]
                    for a, b in zip(got, want)]
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    for which in ("dq", "dkv"):
                        res[name].setdefault(which + "_ms", []).append(
                            timer(lambda: bwd(libs[name], which, q, k, v,
                                              do, lse, delta, kw)))
            del o, lse, delta, want
        for name, r in res.items():
            print(json.dumps({"shape": shape, "variant": name, **r}),
                  flush=True)
        del q, k, v, do
    for case in cfg.get("cases", _CASES):
        bh, sq, sk, d, causal, q_start, k_start, rows, kvb, rate = case
        g = torch.Generator(device="cuda").manual_seed(sq * sk + d)
        q = torch.randn(bh, sq, d, generator=g, device="cuda")
        k, v = (torch.randn(bh, sk, d, generator=g, device="cuda")
                for _ in range(2))
        kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start,
                  k_start=k_start, dropout_rate=rate, dropout_seed=-123)
        if kvb:
            kw["kv_bias"] = torch.where(
                torch.rand(bh, sk, generator=g, device="cuda") < 0.25,
                FA.NEG_INF, 0.0)
        bias = None
        if rows is not None:
            bias = torch.randn(1 if rows == 1 else bh, sq, sk, generator=g,
                               device="cuda")
            bias[..., ::7] = FA.NEG_INF
        o0, lse0 = FA.reference_attention(q, k, v, bias, return_lse=True,
                                          **kw)
        kw["bias"] = bias
        for name, so in libs.items():
            o, lse = fwd(so, q, k, v, kw)
            torch.cuda.synchronize()
            print(json.dumps({"case": case, "variant": name, "tol_used":
                              cs.flash_err(torch, o, o0,
                                           torch.float32)["used"],
                              "lse_err": float((lse - lse0).abs().max())}),
                  flush=True)
    print(cs.nvidia_smi("name,power.limit"))
    return 0


def bwd256(torch, cs, kcuda, FA, libs, cfg, timer) -> None:
    """dq and dk/dv of every variant at D 256: at each shape (causal,
    ``form_inputs``; o and lse by the committed forward) against
    ``flash_bwd_plain`` on the first heads under the fp32 flash rule and
    repeated bit for bit, then timed in turns twice beside the simple
    form's dq and dk/dv on the same inputs; then at the edge cases (with
    their biases and dropout; dS with a full bias) against the plain
    version; with ``seeds``, the worst share of the rule over those seeds'
    inputs at the first shape (all heads)."""
    n = cs.FLASH_CHECK_HEADS

    def call(so, which, q, k, v, do, lse, delta, kw, ds=False):
        d = q.shape[-1]
        qp, kp, vp, dop = (FA._readable(FA._pad_d(t, 256))
                           for t in (q, k, v, do))
        args, _keep = FA._tail("ab", qp, kp, kw.get("kv_bias"),
                               kw.get("bias"), kw.get("dropout_rate", 0.0),
                               kw.get("dropout_seed", 0), kw["causal"],
                               kw["scale"], kw.get("q_start", 0),
                               kw.get("k_start", 0))
        strides = FA._strides(qp, kp, vp, dop)
        ptrs = [t.data_ptr() for t in (qp, kp, vp, dop, lse, delta)]
        if which == "dq":
            dq = torch.empty_like(qp)
            dsm = torch.empty(q.shape[0], q.shape[1], k.shape[1],
                              device="cuda") if ds else None
            kcuda.check(so.apex_flash_f32_dq(
                0, *ptrs, dq.data_ptr(), None if dsm is None else
                dsm.data_ptr(), *strides, *args), "dq")
            return (dq[..., :d],) + ((dsm,) if ds else ())
        dk, dv = torch.empty_like(kp), torch.empty_like(vp)
        kcuda.check(so.apex_flash_f32_dkv(0, *ptrs, dk.data_ptr(),
                                          dv.data_ptr(), *strides, *args),
                    "dkv")
        return dk[..., :d], dv[..., :d]

    def held(got, want):
        return [cs.flash_err(torch, a, b, torch.float32)["used"]
                for a, b in zip(got, want)]

    for shape in cfg["shapes"]:
        bh, s, d = shape
        q, k, v, do = cs.form_inputs(torch, shape, torch.float32)
        kw = dict(causal=True, scale=d ** -0.5)
        o, lse = FA.flash_f32_fwd(q, k, v, **kw)
        delta = FA.flash_delta(o, do)
        del o
        args = (q, k, v, do, lse, delta)
        want = FA.flash_bwd_plain(*(t[:n] for t in args), **kw)
        res = {name: {} for name in libs}
        for name, so in libs.items():
            got = call(so, "dq", *args, kw) + call(so, "dkv", *args, kw)
            again = call(so, "dq", *args, kw) + call(so, "dkv", *args, kw)
            torch.cuda.synchronize()
            res[name].update(
                tol_used=held([t[:n] for t in got], want),
                repeat_equal=all(torch.equal(a, b)
                                 for a, b in zip(got, again)))
            del got, again
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                for which in ("dq", "dkv"):
                    res[name].setdefault(which + "_ms", []).append(
                        timer(lambda: call(libs[name], which, *args, kw)))
        slow = cs.Timer(torch, reps=5) if s > 1024 else timer
        simple = {"dq_ms": slow(lambda: FA.flash_simt_dq(*args, **kw)),
                  "dkv_ms": slow(lambda: FA.flash_simt_dkv(*args, **kw))}
        for name, r in res.items():
            print(json.dumps({"shape": shape, "variant": name, **r}),
                  flush=True)
        print(json.dumps({"shape": shape, "variant": "simple form",
                          **simple}), flush=True)
        del q, k, v, do, lse, delta, args, want
    worst = {name: [0.0, 0.0, 0.0] for name in libs}
    for seed in cfg.get("seeds", ()):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, do = (torch.randn(*cfg["shapes"][0], generator=g,
                                   device="cuda") for _ in range(4))
        kw = dict(causal=True, scale=q.shape[-1] ** -0.5)
        o, lse = FA.flash_f32_fwd(q, k, v, **kw)
        args = (q, k, v, do, lse, FA.flash_delta(o, do))
        want = FA.flash_bwd_plain(*args, **kw)
        for name, so in libs.items():
            got = call(so, "dq", *args, kw) + call(so, "dkv", *args, kw)
            worst[name] = [max(w, u) for w, u in zip(worst[name],
                                                     held(got, want))]
        del q, k, v, do, o, lse, args, want
    if cfg.get("seeds"):
        for name, w in worst.items():
            print(json.dumps({"seeds": list(cfg["seeds"]), "variant": name,
                              "shape": cfg["shapes"][0],
                              "worst_tol_used": w}), flush=True)
    for case in cfg["cases"]:
        bh, sq, sk, d, causal, q_start, k_start, rows, kvb, rate = case
        g = torch.Generator(device="cuda").manual_seed(sq * sk + d)
        q, do = (torch.randn(bh, sq, d, generator=g, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn(bh, sk, d, generator=g, device="cuda")
                for _ in range(2))
        kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start,
                  k_start=k_start, dropout_rate=rate, dropout_seed=-123)
        if kvb:
            kw["kv_bias"] = torch.where(
                torch.rand(bh, sk, generator=g, device="cuda") < 0.25,
                FA.NEG_INF, 0.0)
        if rows is not None:
            kw["bias"] = torch.randn(1 if rows == 1 else bh, sq, sk,
                                     generator=g, device="cuda")
            kw["bias"][..., ::7] = FA.NEG_INF
        o, lse = FA.reference_attention(q, k, v, kw.get("bias"),
                                        return_lse=True, **{
                                            x: y for x, y in kw.items()
                                            if x != "bias"})
        delta = FA.flash_delta(o, do)
        ds = "bias" in kw
        want = FA.flash_bwd_plain(q, k, v, do, lse, delta, return_ds=ds,
                                  **kw)
        for name, so in libs.items():
            got = call(so, "dq", q, k, v, do, lse, delta, kw, ds)
            got = (got[0], *call(so, "dkv", q, k, v, do, lse, delta, kw),
                   *got[1:])
            torch.cuda.synchronize()
            print(json.dumps({"case": case, "variant": name,
                              "tol_used": held(got, want)}), flush=True)


def d512(torch, cs, kcuda, FA, libs, cfg, timer) -> None:
    """The forward and dq at D 384 and 512 of every variant: at each shape
    (causal, ``form_inputs``) o and lse against ``reference_attention`` and
    dq against ``flash_bwd_plain`` (o, lse, delta from the plain forward)
    on the first heads under the fp32 flash rule (lse within 1e-4), each
    repeated bit for bit, then timed in turns twice, the simple form's
    forward and dq on the same inputs beside them; then at the edge cases
    (biases, dropout, dS with a full bias)."""
    n = cs.FLASH_CHECK_HEADS

    def call(so, which, q, k, v, do, lse, delta, kw, ds=False):
        d = q.shape[-1]
        dw = -(-d // 4) * 4
        qp, kp, vp, dop = (FA._pad_d(t, dw).contiguous()
                           for t in (q, k, v, do))
        args, _keep = FA._tail("ab", qp, kp, kw.get("kv_bias"),
                               kw.get("bias"), kw.get("dropout_rate", 0.0),
                               kw.get("dropout_seed", 0), kw["causal"],
                               kw["scale"], kw.get("q_start", 0),
                               kw.get("k_start", 0))
        if which == "fwd":
            o = torch.empty(qp.shape, device="cuda")
            lse_o = torch.empty(qp.shape[:2], device="cuda")
            kcuda.check(so.apex_flash_f32_d512_fwd(
                0, qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
                lse_o.data_ptr(), *FA._strides(qp, kp, vp), *args), "fwd")
            return o[..., :d], lse_o
        dq = torch.empty_like(qp)
        dsm = torch.empty(q.shape[0], q.shape[1], k.shape[1],
                          device="cuda") if ds else None
        ptrs = [t.data_ptr() for t in (qp, kp, vp, dop, lse, delta)]
        kcuda.check(so.apex_flash_f32_d512_dq(
            0, *ptrs, dq.data_ptr(), None if dsm is None else dsm.data_ptr(),
            *FA._strides(qp, kp, vp, dop), *args), "dq")
        return (dq[..., :d],) + ((dsm,) if ds else ())

    def used(a, b):
        return cs.flash_err(torch, a, b, torch.float32)["used"]

    for shape in cfg["shapes"]:
        bh, s, d = shape
        q, k, v, do = cs.form_inputs(torch, shape, torch.float32)
        kw = dict(causal=True, scale=d ** -0.5)
        o0, lse0 = FA.reference_attention(q, k, v, return_lse=True, **kw)
        delta = FA.flash_delta(o0, do)
        args = (q, k, v, do, lse0, delta)
        want = FA.flash_bwd_plain(*(t[:n] for t in args), **kw)[0]
        res = {name: {} for name in libs}
        for name, so in libs.items():
            o, lse = call(so, "fwd", *args, kw)
            o2, lse2 = call(so, "fwd", *args, kw)
            dq = call(so, "dq", *args, kw)[0]
            dq2 = call(so, "dq", *args, kw)[0]
            torch.cuda.synchronize()
            res[name].update(
                o_used=used(o[:n], o0[:n]),
                lse_err=float((lse[:n] - lse0[:n]).abs().max()),
                dq_used=used(dq[:n], want),
                repeat_equal=bool(torch.equal(o, o2) and torch.equal(lse, lse2)
                                  and torch.equal(dq, dq2)))
            del o, lse, o2, lse2, dq, dq2
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                for which in ("fwd", "dq"):
                    res[name].setdefault(which + "_ms", []).append(
                        timer(lambda: call(libs[name], which, *args, kw)))
        simple = {"fwd_ms": timer(lambda: FA.flash_simt_fwd(q, k, v, **kw)),
                  "dq_ms": timer(lambda: FA.flash_simt_dq(*args, **kw))}
        for name, r in res.items():
            print(json.dumps({"shape": shape, "variant": name, **r}),
                  flush=True)
        print(json.dumps({"shape": shape, "variant": "simple form",
                          **simple}), flush=True)
        del q, k, v, do, o0, lse0, delta, args, want
    for case in cfg["cases"]:
        bh, sq, sk, d, causal, q_start, k_start, rows, kvb, rate = case
        g = torch.Generator(device="cuda").manual_seed(sq * sk + d)
        q, do = (torch.randn(bh, sq, d, generator=g, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn(bh, sk, d, generator=g, device="cuda")
                for _ in range(2))
        kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start,
                  k_start=k_start, dropout_rate=rate, dropout_seed=-123)
        if kvb:
            kw["kv_bias"] = torch.where(
                torch.rand(bh, sk, generator=g, device="cuda") < 0.25,
                FA.NEG_INF, 0.0)
        bias = None
        if rows is not None:
            bias = torch.randn(1 if rows == 1 else bh, sq, sk, generator=g,
                               device="cuda")
            bias[..., ::7] = FA.NEG_INF
        o0, lse0 = FA.reference_attention(q, k, v, bias, return_lse=True,
                                          **kw)
        kw["bias"] = bias
        delta = FA.flash_delta(o0, do)
        ds = bias is not None
        want = FA.flash_bwd_plain(q, k, v, do, lse0, delta, return_ds=ds,
                                  **kw)
        for name, so in libs.items():
            o, lse = call(so, "fwd", q, k, v, do, lse0, delta, kw)
            got = call(so, "dq", q, k, v, do, lse0, delta, kw, ds)
            torch.cuda.synchronize()
            live = lse0 > FA.NEG_INF * 0.5
            print(json.dumps({
                "case": case, "variant": name, "o_used": used(o, o0),
                "lse_err": float((lse - lse0)[live].abs().max())
                if bool(live.any()) else 0.0,
                "dq_used": used(got[0], want[0]),
                "ds_used": used(got[1], want[3]) if ds else None}),
                flush=True)


def d512dkv(torch, cs, kcuda, FA, libs, cfg, timer) -> None:
    """dk/dv at D 384 and 512 of every variant: at each shape (causal,
    ``form_inputs``; lse and delta from the plain forward) dk and dv
    against ``flash_bwd_plain`` on the first heads under the fp32 flash
    rule, repeated bit for bit, then timed in turns twice, the simple
    dk/dv on the same inputs beside them; then at the edge cases."""
    n = cs.FLASH_CHECK_HEADS

    def call(so, q, k, v, do, lse, delta, kw):
        d = q.shape[-1]
        dw = -(-d // 4) * 4
        qp, kp, vp, dop = (FA._pad_d(t, dw).contiguous()
                           for t in (q, k, v, do))
        args, _keep = FA._tail("ab", qp, kp, kw.get("kv_bias"),
                               kw.get("bias"), kw.get("dropout_rate", 0.0),
                               kw.get("dropout_seed", 0), kw["causal"],
                               kw["scale"], kw.get("q_start", 0),
                               kw.get("k_start", 0))
        dk, dv = torch.empty_like(kp), torch.empty_like(vp)
        ptrs = [t.data_ptr() for t in (qp, kp, vp, dop, lse, delta)]
        kcuda.check(so.apex_flash_f32_d512_dkv(
            0, *ptrs, dk.data_ptr(), dv.data_ptr(),
            *FA._strides(qp, kp, vp, dop), *args), "dkv")
        return dk[..., :d], dv[..., :d]

    def used(a, b):
        return cs.flash_err(torch, a, b, torch.float32)["used"]

    for shape in cfg["shapes"]:
        bh, s, d = shape
        q, k, v, do = cs.form_inputs(torch, shape, torch.float32)
        kw = dict(causal=True, scale=d ** -0.5)
        o0, lse0 = FA.reference_attention(q, k, v, return_lse=True, **kw)
        delta = FA.flash_delta(o0, do)
        args = (q, k, v, do, lse0, delta)
        want = FA.flash_bwd_plain(*(t[:n] for t in args), **kw)
        res = {name: {} for name in libs}
        for name, so in libs.items():
            dk, dv = call(so, *args, kw)
            dk2, dv2 = call(so, *args, kw)
            torch.cuda.synchronize()
            res[name].update(
                dk_used=used(dk[:n], want[1]), dv_used=used(dv[:n], want[2]),
                repeat_equal=bool(torch.equal(dk, dk2)
                                  and torch.equal(dv, dv2)))
            del dk, dv, dk2, dv2
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                res[name].setdefault("ms", []).append(
                    timer(lambda: call(libs[name], *args, kw)))
        for name, r in res.items():
            print(json.dumps({"shape": shape, "variant": name, **r}),
                  flush=True)
        print(json.dumps({"shape": shape, "variant": "simple form",
                          "ms": timer(lambda: FA.flash_simt_dkv(*args,
                                                                **kw))}),
              flush=True)
        del q, k, v, do, o0, lse0, delta, args, want
    for case in cfg["cases"]:
        bh, sq, sk, d, causal, q_start, k_start, rows, kvb, rate = case
        g = torch.Generator(device="cuda").manual_seed(sq * sk + d)
        q, do = (torch.randn(bh, sq, d, generator=g, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn(bh, sk, d, generator=g, device="cuda")
                for _ in range(2))
        kw = dict(causal=causal, scale=d ** -0.5, q_start=q_start,
                  k_start=k_start, dropout_rate=rate, dropout_seed=-123)
        if kvb:
            kw["kv_bias"] = torch.where(
                torch.rand(bh, sk, generator=g, device="cuda") < 0.25,
                FA.NEG_INF, 0.0)
        bias = None
        if rows is not None:
            bias = torch.randn(1 if rows == 1 else bh, sq, sk, generator=g,
                               device="cuda")
            bias[..., ::7] = FA.NEG_INF
        o0, lse0 = FA.reference_attention(q, k, v, bias, return_lse=True,
                                          **kw)
        kw["bias"] = bias
        delta = FA.flash_delta(o0, do)
        want = FA.flash_bwd_plain(q, k, v, do, lse0, delta, **kw)
        for name, so in libs.items():
            dk, dv = call(so, q, k, v, do, lse0, delta, kw)
            torch.cuda.synchronize()
            print(json.dumps({"case": case, "variant": name,
                              "dk_used": used(dk, want[1]),
                              "dv_used": used(dv, want[2])}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
