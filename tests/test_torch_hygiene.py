"""Port hygiene: ``apex_tpu_torch`` and ``chip_smoke.py`` stand alone.

The port imports no JAX and nothing of the JAX package (checked both in
a fresh interpreter and by an AST scan of every source), its entry points
default to the card and raise without CUDA unless the caller passes
``device="cpu"``, and the kernel build reports a missing ``nvcc``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "apex_tpu_torch"


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "flash_f32_ab.py",
                                        ROOT / "flash_d512_ab.py",
                                        ROOT / "flash_dbias_ab.py",
                                        ROOT / "ln_bwd_wide_ab.py",
                                        ROOT / "timer_load_ab.py",
                                        ROOT / "decode_rows_ab.py",
                                        ROOT / "flash_f32_dq_check.py",
                                        ROOT / "ddp_profile_ab.py",
                                        ROOT / "tools" / "_perf_common_torch.py",
                                        ROOT / "tools" / "serve_bench_torch.py",
                                        ROOT / "tools" / "decode_bench_torch.py"]


def test_fresh_import_pulls_in_no_jax():
    code = ("import sys, apex_tpu_torch, apex_tpu_torch.serve, "
            "apex_tpu_torch.models, apex_tpu_torch.convert, "
            "apex_tpu_torch.models.seq2seq, apex_tpu_torch.ops.xentropy, "
            "apex_tpu_torch.fp16_utils, apex_tpu_torch.prof.numerics, "
            "apex_tpu_torch.optimizers.fused_adagrad\n"
            "from apex_tpu_torch.models import Seq2SeqTransformer\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'apex_tpu.')) or "
            "m == 'apex_tpu')\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_the_data_parallel_modules_pull_in_no_jax():
    """``parallel`` (every submodule), ``contrib.groupbn`` and
    ``contrib.optimizers`` load no JAX and nothing of the JAX package."""
    code = ("import sys\n"
            "import apex_tpu_torch.parallel as P\n"
            "from apex_tpu_torch.parallel import (collectives, mesh, plan, "
            "launch, multiproc, distributed, sync_batchnorm)\n"
            "import apex_tpu_torch.contrib.groupbn, "
            "apex_tpu_torch.contrib.optimizers\n"
            "from apex_tpu_torch.train import DDPTrainer, ZeROTrainer\n"
            "[getattr(P, n) for n in P.__all__]\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'apex_tpu.')) or "
            "m == 'apex_tpu')\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_apex_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "apex_tpu"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_the_kernel_variant_script_refuses_without_a_card():
    """``flash_f32_ab.py`` builds and times kernel variants on the card
    only: without CUDA it prints its usage and exits 2, building
    nothing."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "flash_f32_ab.py", "tile"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 2 and "usage" in out.stderr
    assert out.stdout == ""


def test_the_wide_ln_ab_script_refuses_without_a_card():
    """``ln_bwd_wide_ab.py`` builds and times on the card only: without
    CUDA it exits 2 before it builds, unpacks or starts anything."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "ln_bwd_wide_ab.py", "variants"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 2 and "needs an NVIDIA card" in out.stderr
    assert out.stdout == ""


def test_the_decode_rows_ab_script_refuses_without_a_card():
    """``decode_rows_ab.py`` builds and times on the card only: without
    CUDA it exits 2 before it builds or starts anything."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "decode_rows_ab.py", "variants"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 2 and "needs an NVIDIA card" in out.stderr
    assert out.stdout == ""


def test_the_dq_check_script_refuses_without_a_card():
    """``flash_f32_dq_check.py`` holds and times the fp32 dq on the card
    only: without CUDA it exits 2 before it builds or starts anything."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "flash_f32_dq_check.py", "rule"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 2 and "needs an NVIDIA card" in out.stderr
    assert out.stdout == ""


def test_the_timer_load_script_refuses_without_a_card():
    """``timer_load_ab.py`` times the card only: without CUDA it exits
    with an error before it builds or starts anything."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "timer_load_ab.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 1 and "needs a CUDA card" in out.stderr
    assert out.stdout == ""


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card_and_raise_without_it(no_cuda):
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.normalization import FusedLayerNorm
    from apex_tpu_torch.serve import (ContinuousBatchingEngine,
                                      init_paged_state, init_slot_state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(vocab_size=50, embed_dim=32, num_heads=4,
                      num_layers=1)
    m = TransformerLM(vocab_size=50, max_seq_len=16, embed_dim=32,
                      num_heads=4, num_layers=1, device="cpu")
    p = m.init(0)
    for call in (
            lambda: ContinuousBatchingEngine(m, p, slots=2, max_len=16,
                                             prefill_chunk=4),
            lambda: init_slot_state(m, p, 2, 16),
            lambda: init_paged_state(m, p, 2, 16, 4, 8),
            lambda: params_from_jax({"w": np.zeros(2, np.float32)}),
            lambda: FusedLayerNorm(8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cpu_model_and_engine_stay_on_the_cpu():
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.serve import ContinuousBatchingEngine
    m = TransformerLM(vocab_size=50, max_seq_len=16, embed_dim=32,
                      num_heads=4, num_layers=1, device="cpu")
    p = m.init(0)
    assert p["tok_emb"].device.type == "cpu"
    eng = ContinuousBatchingEngine(m, p, slots=2, max_len=16,
                                   prefill_chunk=4, device="cpu")
    assert eng.device.type == "cpu"


def test_dispatch_backend_names_and_nesting():
    from apex_tpu_torch.ops import dispatch
    assert dispatch.get_backend() == "auto"
    with dispatch.backend("reference"):
        assert dispatch.get_backend() == "reference"
    assert dispatch.get_backend() == "auto"
    with pytest.raises(ValueError, match="backend"):
        with dispatch.backend("pallas"):
            pass


def test_missing_nvcc_is_reported(monkeypatch, tmp_path):
    from apex_tpu_torch.ops import cuda
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build()


def test_training_subpackages_import_without_jax():
    code = ("import sys, apex_tpu_torch\n"
            "import apex_tpu_torch.amp, apex_tpu_torch.optimizers, "
            "apex_tpu_torch.parallel, apex_tpu_torch.contrib.xentropy, "
            "apex_tpu_torch.ops.flat, apex_tpu_torch.ops.kernels, "
            "apex_tpu_torch.ops.welford, "
            "apex_tpu_torch.train\n"
            "from apex_tpu_torch.amp import initialize, LossScaler\n"
            "from apex_tpu_torch.optimizers import FusedLAMB\n"
            "from apex_tpu_torch.parallel import SyncBatchNorm\n"
            "from apex_tpu_torch.models import ResNet, resnet50\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'apex_tpu.')) or "
            "m == 'apex_tpu')\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_training_entry_points_default_to_the_card_and_raise_without_it(
        no_cuda):
    from apex_tpu_torch.amp import LossScaler, initialize
    from apex_tpu_torch.convert import resnet_from_jax
    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.parallel import SyncBatchNorm
    from apex_tpu_torch.train import Trainer
    ci = dict(block_sizes=(1, 1), bottleneck=True, num_classes=10, width=8)
    m = ResNet(**ci, device="cpu")
    params, state = m.init(0)
    _, handle = initialize(opt_level="O2", verbosity=0)
    for call in (
            lambda: ResNet(**ci),
            lambda: FusedLAMB(params),
            lambda: Trainer(m, params, state),
            lambda: LossScaler().init(),
            lambda: handle.init_state(),
            lambda: SyncBatchNorm(8, axis_name=None).init(),
            lambda: resnet_from_jax({"w": np.zeros(2, np.float32)}, {})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cpu_trainer_stays_on_the_cpu():
    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.train import Trainer
    m = ResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10, width=8,
               device="cpu")
    tr = Trainer(m, *m.init(0), device="cpu")
    loss = tr.step(torch.randn(2, 3, 16, 16), torch.tensor([1, 2]))
    assert loss.device.type == "cpu" and loss.dim() == 0
    assert tr.opt.state[0].master.device.type == "cpu"
    assert tr.amp_state[0].scale.device.type == "cpu"


def test_ctypes_declarations_match_the_c_entry_points():
    """Every ``extern "C"`` entry point of csrc/*.cu is declared by the
    loader with one ctypes type per C parameter (machines without nvcc
    cannot compile them, so a miscounted declaration would show only on
    the card), and every source is part of the build and its hash."""
    import re
    import types

    from apex_tpu_torch.ops import cuda
    sources = cuda._sources()
    assert {p.name for p in sources} >= {"decode_attn.cu", "flash_dbias.cu",
                                         "flash_d512.cu", "flash_simt.cu",
                                         "flash_d512_dkv.cu",
                                         "flash_f32.cu", "flash_f32_d512.cu",
                                         "layer_norm.cu", "ln_bwd_row.cu",
                                         "multi_tensor.cu", "welford.cu",
                                         "xentropy.cu"}
    sigs = {}
    for p in sources:
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', p.read_text()):
            sigs[name] = len([a for a in params.split(",") if a.strip()])
    so = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in sigs})
    cuda._declare(so)
    for name, n in sigs.items():
        assert len(getattr(so, name).argtypes) == n, name
    assert len(sigs) == 43           # the decode merge and the simple
    # flash form's four are the 27th to 31st, the fp32 backward's two on
    # the tensor cores the 32nd and 33rd, the fp32 forward the 34th, the
    # forward and dq at head dims 384 and 512 the 35th and 36th, their
    # fp32 forms the 37th and 38th, and dk/dv there in both the 39th and
    # 40th; the shared-bias gradient's two (bf16/fp16 and fp32) took the
    # place of its one D <= 128 kernel; the one-pass wide LayerNorm
    # backward and its plan's query are the 42nd and 43rd


def test_lm_training_entry_points_default_to_the_card_and_raise_without_it(
        no_cuda):
    from apex_tpu_torch.convert import opt_state_from_jax
    from apex_tpu_torch.models import TransformerLM
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.train import LMTrainer
    m = TransformerLM(vocab_size=64, max_seq_len=16, embed_dim=32,
                      num_heads=2, num_layers=1, attn_impl="fast",
                      head_chunk=32, device="cpu")
    p = m.init(0)
    for call in (lambda: FusedAdam(p), lambda: LMTrainer(m, p),
                 lambda: opt_state_from_jax([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    tr = LMTrainer(m, p, device="cpu")
    loss = tr.step(torch.randint(0, 64, (2, 9)))
    assert loss.device.type == "cpu" and tr.opt.state[0].master.dtype == \
        torch.float32


def _string_constants(tree):
    """String literals that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_tpu_measurement_file_or_override_is_read(path):
    """The TPU's crossover records, bench defaults and the environment
    overrides of its dispatch hold TPU measurements; no port code names
    them."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for s in _string_constants(tree):
        for bad in ("_crossover.json", "BENCH_DEFAULTS", "APEX_FLASH",
                    "APEX_TPU_"):
            assert bad not in s, f"{path.name} names {bad!r}: {s!r}"


def test_dispatch_backend_reaches_other_threads():
    """PyTorch runs a CUDA backward on its own device thread: the forced
    backend must be visible there, or the plain run's backward launches
    kernels."""
    import threading

    from apex_tpu_torch.ops import dispatch
    seen = []
    with dispatch.backend("reference"):
        t = threading.Thread(target=lambda: seen.append(
            dispatch.get_backend()))
        t.start()
        t.join()
    assert seen == ["reference"] and dispatch.get_backend() == "auto"


def test_scan_reaches_the_imagenet_slice_modules():
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert {"data/__init__.py", "optimizers/fused_sgd.py",
            "optimizers/fused_novograd.py", "optimizers/larc.py"} <= names


def test_scan_reaches_the_seq2seq_slice_modules():
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert {"models/seq2seq.py", "ops/xentropy.py",
            "contrib/xentropy/softmax_xentropy.py",
            "contrib/multihead_attn/modules.py"} <= names


def test_scan_reaches_the_router_slice_modules():
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert {"serve/router.py", "prof/slo.py", "prof/live.py",
            "prof/spans.py"} <= names


def test_router_slice_imports_without_jax_or_torch():
    """The router, ``slo``, ``live`` and ``spans`` are stdlib only: a
    process hosting the router (the socket transport's parent) loads
    neither JAX nor torch."""
    code = ("import sys\n"
            "import apex_tpu_torch.serve.router, apex_tpu_torch.prof.slo, "
            "apex_tpu_torch.prof.live, apex_tpu_torch.prof.spans\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'torch') "
            "or m.startswith(('jax.', 'torch.', 'apex_tpu.')))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_scan_reaches_the_telemetry_slice_modules():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"apex_tpu_torch/prof/metrics.py",
            "apex_tpu_torch/prof/flightrec.py",
            "apex_tpu_torch/prof/watchdog.py",
            "tools/_perf_common_torch.py", "tools/serve_bench_torch.py",
            "tools/decode_bench_torch.py"} <= names


def test_telemetry_modules_load_no_torch():
    """``prof.metrics``, ``prof.flightrec`` and ``prof.watchdog`` load no
    torch (nor JAX) at import, nor when a logger writes a sidecar of
    host numbers: a process hosting a router or a collector can log."""
    code = ("import sys, os, tempfile\n"
            "import apex_tpu_torch.prof.metrics, apex_tpu_torch.prof."
            "flightrec, apex_tpu_torch.prof.watchdog\n"
            "from apex_tpu_torch.prof import MetricsLogger, Watchdog, "
            "FlightRecorder, SCHEMA_VERSION, metrics, watchdog, flightrec\n"
            "d = tempfile.mkdtemp()\n"
            "log = MetricsLogger(os.path.join(d, 't.jsonl'), run='x')\n"
            "wd = Watchdog(log, min_interval_s=60.0).start()\n"
            "fr = FlightRecorder(path=os.path.join(d, 'f.json'))\n"
            "fr.attach(telemetry=log)\n"
            "log.log_step(0, step_ms=1.0)\n"
            "wd.heartbeat()\n"
            "wd.stop()\n"
            "fr.dump()\n"
            "log.close()\n"
            "print(','.join(sorted(m for m in sys.modules if m in "
            "('torch', 'numpy', 'jax') or m.startswith(('torch.', "
            "'jax.', 'apex_tpu.')))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_imagenet_slice_imports_without_jax():
    code = ("import sys\n"
            "import apex_tpu_torch.data, apex_tpu_torch.optimizers.fused_sgd, "
            "apex_tpu_torch.optimizers.fused_novograd, "
            "apex_tpu_torch.optimizers.larc\n"
            "from apex_tpu_torch.optimizers import (FusedSGD, FusedNovoGrad, "
            "LARC)\n"
            "from apex_tpu_torch.data import normalize_imagenet\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'apex_tpu.')) or "
            "m == 'apex_tpu')\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_imagenet_entry_points_default_to_the_card_and_raise_without_it(
        no_cuda):
    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.optimizers import LARC, FusedNovoGrad, FusedSGD
    from apex_tpu_torch.train import Trainer
    m = ResNet(block_sizes=(1, 1), bottleneck=True, num_classes=10, width=8,
               device="cpu")
    params, state = m.init(0)
    for call in (lambda: FusedSGD(params, lr=0.1),
                 lambda: FusedNovoGrad(params),
                 lambda: Trainer(m, params, state, optimizer="sgd"),
                 lambda: Trainer(m, params, state, optimizer="novograd",
                                 larc=True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    tr = Trainer(m, params, state, optimizer="sgd", larc=True, device="cpu")
    assert isinstance(tr.opt, LARC)
    x = torch.randint(0, 256, (2, 16, 16, 3), dtype=torch.uint8)
    loss = tr.step(x, torch.tensor([1, 2]))
    top1, top5 = tr.evaluate(x, torch.tensor([1, 2]))
    assert loss.device.type == top1.device.type == "cpu"
    assert tr.opt.state[0].master.device.type == "cpu"


def test_fp16_utils_entry_points_default_to_the_card_and_raise_without_it(
        no_cuda):
    from apex_tpu_torch.convert import optimizer_state_dict_from_jax
    from apex_tpu_torch.fp16_utils import (DynamicLossScaler, FP16_Optimizer,
                                           LossScaler)
    from apex_tpu_torch.optimizers import FusedAdagrad
    from apex_tpu_torch.prof import numerics
    p = {"w": torch.zeros(4, 4)}
    for call in (lambda: FusedAdagrad(p), lambda: LossScaler(),
                 lambda: DynamicLossScaler(),
                 lambda: numerics.empty_census(3),
                 lambda: optimizer_state_dict_from_jax(
                     {"param_groups": [], "groups": []})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    opt = FP16_Optimizer(FusedAdagrad(p, device="cpu"),
                         dynamic_loss_scale=True)
    assert opt.scaler_state.scale.device.type == "cpu"
    opt.step({"w": torch.ones(4, 4)})
    assert not opt.overflow
    assert opt.optimizer.state[0].master.device.type == "cpu"


def test_scan_reaches_the_vit_slice_modules():
    names = {p.relative_to(PKG).as_posix() for p in _sources()
             if p.is_relative_to(PKG)}
    assert {"models/vit.py", "ops/flash_attn.py",
            "contrib/multihead_attn/flash_attention.py"} <= names


def test_vit_slice_imports_without_jax():
    code = ("import sys\n"
            "from apex_tpu_torch.models import ViT, vit_b16\n"
            "from apex_tpu_torch.models.vit import analytic_flops\n"
            "from apex_tpu_torch.ops.flash_attn import (dropout_bits, "
            "flash_bwd_dbias)\n"
            "from apex_tpu_torch.train import Trainer\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'apex_tpu.')) or "
            "m == 'apex_tpu')\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_vit_entry_points_default_to_the_card_and_raise_without_it(no_cuda):
    from apex_tpu_torch.models import vit_tiny
    from apex_tpu_torch.train import Trainer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vit_tiny(dropout=0.1)
    m = vit_tiny(dropout=0.1, device="cpu")
    p = m.init(0)
    assert p["pos_emb"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(m, p, optimizer="sgd")
    tr = Trainer(m, p, optimizer="sgd", device="cpu")
    x = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    loss = tr.step(x, torch.tensor([1, 2]))
    assert loss.device.type == tr.opt.state[0].master.device.type == "cpu"
