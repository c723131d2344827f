"""CUDA build and loader for the port's hand kernels — takes the place of
``apex_tpu/ops/pallas/_common.py``.

The sources are ``csrc/*.cu``, each with a plain C interface. At first use
every source is compiled by its own ``nvcc`` (all started together) for
``sm_90a`` and the objects are linked into one shared library under
``apex_tpu_torch/_build/``, named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads at once. The library is
loaded with ``ctypes``: pointers are ``c_void_p``, the stream is PyTorch's
current stream. Each C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` raises on anything but 0.

Nothing here runs at import: this module imports on machines without
``nvcc`` or a card (the CPU tests import every module). The first
:func:`lib` builds and loads under a lock, so threads that reach it
together (the router's replicas) build once; processes share the built
library, which appears whole (``os.replace``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["build", "lib", "check", "stream", "dtype_code"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
          "-Xptxas=-v"]

# dtype codes shared with the C entry points (csrc/common.cuh)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lib = None
_lib_mu = threading.Lock()
build_seconds = None   # wall time of the last build (None: loaded cached)
build_log = ""         # ptxas register/spill report of the last build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the "
            "port's kernels are built from source on the machine with "
            "the card")
    return found


def _sources() -> list:
    return sorted(_CSRC.glob("*.cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join([nvcc] + _ARCH + _FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into the shared library if it is not built yet
    for this exact source set; return its path. Raises with nvcc's
    stderr when a compile or the link fails."""
    global build_seconds, build_log
    nvcc = _nvcc()
    out = _BUILD / f"apex_tpu_torch_kernels_{_digest(nvcc)}.so"
    if out.exists():
        build_seconds = None
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *_ARCH, *_FLAGS, "-I", str(_CSRC), "-c",
                   str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors, logs = [], []
        for src, _obj, p in procs:
            _, err = p.communicate()
            logs.append(f"{src.name}:\n{err}")
            if p.returncode != 0:
                errors.append(logs[-1])
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / out.name
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp_so),
               *[str(obj) for _, obj, _ in procs]]
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{p.stderr}")
        os.replace(tmp_so, out)     # atomic: a reader never sees half
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return out


def _declare(so: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.apex_decode_attention.argtypes = [
        I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P]
    so.apex_decode_attention.restype = I
    so.apex_decode_merge.argtypes = [I, P, P, P, I, I, I, I, I, P]
    so.apex_decode_merge.restype = I
    so.apex_layer_norm_fwd.argtypes = [
        I, I, P, P, P, P, P, P, I, I, F, P]
    so.apex_layer_norm_fwd.restype = I
    L = ctypes.c_longlong
    so.apex_scale.argtypes = [I, P, P, P, P, L, P]
    so.apex_scale.restype = I
    so.apex_lamb_phase1.argtypes = [I, I] + [P] * 10 + [L, I, P]
    so.apex_lamb_phase1.restype = I
    so.apex_lamb_phase2.argtypes = [I, P, P, P, P, P, L, P]
    so.apex_lamb_phase2.restype = I
    so.apex_bn_moments.argtypes = [I, P, L, I, I, P, P, P, P]
    so.apex_bn_moments.restype = I
    so.apex_bn_bwd_reduce.argtypes = [I, P, P, P, P, P, L, I, I, P, P, P, P]
    so.apex_bn_bwd_reduce.restype = I
    so.apex_bn_bwd_dx.argtypes = [I, P, P, P, P, P, P, L, I, I, P]
    so.apex_bn_bwd_dx.restype = I
    so.apex_adam.argtypes = [I, I] + [P] * 8 + [L, I, P]
    so.apex_adam.restype = I
    so.apex_rowsumsq.argtypes = [I, P, P, L, P]
    so.apex_rowsumsq.restype = I
    so.apex_rowmaxabs.argtypes = [I, P, P, L, P]
    so.apex_rowmaxabs.restype = I
    so.apex_sgd.argtypes = [I, I] + [P] * 6 + [L, I, P]
    so.apex_sgd.restype = I
    so.apex_novograd.argtypes = [I, I] + [P] * 8 + [L, I, P]
    so.apex_novograd.restype = I
    so.apex_axpby.argtypes = [I, I] + [P] * 5 + [L, I, P]
    so.apex_axpby.restype = I
    so.apex_l2norm.argtypes = [I, P, P, P, L, I, P]
    so.apex_l2norm.restype = I
    so.apex_adagrad.argtypes = [I, I] + [P] * 6 + [L, I, P]
    so.apex_adagrad.restype = I
    so.apex_layer_norm_bwd.argtypes = [I, I] + [P] * 9 + [I] * 4 + [P]
    so.apex_layer_norm_bwd.restype = I
    # the wide rows: rows and F (and rows per block) in 64 bits
    so.apex_layer_norm_fwd_wide.argtypes = [I, I] + [P] * 7 + [L, L, F, P]
    so.apex_layer_norm_fwd_wide.restype = I
    so.apex_layer_norm_bwd_wide.argtypes = [I, I] + [P] * 10 + [L, L, L, I,
                                                                P]
    so.apex_layer_norm_bwd_wide.restype = I
    # the one-pass wide backward (rows in 64 bits) and its plan's query
    so.apex_layer_norm_bwd_row.argtypes = [I, I] + [P] * 9 + [L, I, P]
    so.apex_layer_norm_bwd_row.restype = I
    so.apex_layer_norm_bwd_row_plan.argtypes = [L, I, I, I, P]
    so.apex_layer_norm_bwd_row_plan.restype = I
    so.apex_bn_bwd_reduce_xhat.argtypes = [I, I, P, P, L, I, I, P, P, P, P]
    so.apex_bn_bwd_reduce_xhat.restype = I
    # kv_bias and bias with their bh strides; dropout's seed, threshold
    # and 1 / (1 - rate); bh, sq, sk, d, q_start, k_start, causal; scale
    U = ctypes.c_uint32
    tail = [P, L, P, L, U, U, F] + [I] * 7 + [F, P]
    # the forward, dq and dk/dv: the dtype, the tensor maps of q, k, v
    # (and dO), 8 long longs each, and the grid's row blocks in place of
    # the strides
    # (the forward and dq at D 384 and 512 take the same)
    for name in ("apex_flash_fwd", "apex_flash_d512_fwd"):
        getattr(so, name).argtypes = [I] + [P] * 5 + [P, I] + tail
        getattr(so, name).restype = I
    for name in ("apex_flash_bwd_dq", "apex_flash_d512_dq"):
        getattr(so, name).argtypes = [I] + [P] * 8 + [P, I] + tail
        getattr(so, name).restype = I
    for name in ("apex_flash_bwd_dkv", "apex_flash_d512_dkv"):
        getattr(so, name).argtypes = [I] + [P] * 8 + [P, I] + tail
        getattr(so, name).restype = I
    # the shared-bias gradient: the dtype, q, k, v, dO, lse, delta, dbias
    # and the runs' scratch, then the maps and the runs (bf16/fp16) or the
    # runs and the strides (fp32)
    so.apex_flash_tc_dbias.argtypes = [I] + [P] * 8 + [P, I] + tail
    so.apex_flash_tc_dbias.restype = I
    so.apex_flash_f32_dbias.argtypes = [I] + [P] * 8 + [I] + [L] * 8 + tail
    so.apex_flash_f32_dbias.restype = I
    # the simple form: the dtype, pointers, then the strides (bh, row) of
    # q, k, v (and dO) in elements
    # (the fp32 forwards on the tensor cores take the same)
    for name in ("apex_flash_simt_fwd", "apex_flash_f32_fwd",
                 "apex_flash_f32_d512_fwd"):
        getattr(so, name).argtypes = [I] + [P] * 5 + [L] * 6 + tail
        getattr(so, name).restype = I
    # the fp32 backward on the tensor cores takes the simple form's
    # arguments
    for name in ("apex_flash_simt_dq", "apex_flash_simt_dkv",
                 "apex_flash_simt_dbias", "apex_flash_f32_dq",
                 "apex_flash_f32_dkv", "apex_flash_f32_d512_dq",
                 "apex_flash_f32_d512_dkv"):
        getattr(so, name).argtypes = [I] + [P] * 8 + [L] * 8 + tail
        getattr(so, name).restype = I
    so.apex_xent_fwd.argtypes = [I, P, L, P, I, I, I, I, F, F, P, P, P]
    so.apex_xent_fwd.restype = I
    so.apex_xent_bwd.argtypes = [I, P, L, P, I, P, P, I, I, I, F, F, I, P,
                                 P]
    so.apex_xent_bwd.restype = I


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once)."""
    global _lib
    if _lib is None:
        with _lib_mu:
            if _lib is None:
                so = ctypes.CDLL(str(build()))
                _declare(so)
                _lib = so
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dt: torch.dtype, what: str) -> int:
    if dt not in _DTYPES:
        raise TypeError(f"{what}: dtype {dt} is not supported by the "
                        f"kernel (float32, bfloat16, float16)")
    return _DTYPES[dt]
