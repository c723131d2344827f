"""bench.py's ``--zero ddp`` step at NCCL world size 1 against ``Trainer``'s
plain step on the H100 (RN50, batch 256 at 224², O2 bf16, FusedLAMB), in
turns (plain, ddp, ddp, plain): 10 timed steps each (CUDA events), 3
under ``torch.profiler`` (``chip_smoke.profile_steps``: device time by
kernel family, idle share), and 3 under a host-only profile
(``host_ops``: the host's time a step inside each op, collectives and
the rest, and the host time outside any op). Run from the repository
root on a machine with one card::

    python3 ddp_profile_ab.py

Without CUDA it prints this usage and exits 2.
"""
import json
import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

if not torch.cuda.is_available():
    print(__doc__, file=sys.stderr)
    sys.exit(2)

import chip_smoke as cs  # noqa: E402
from apex_tpu_torch.ops import cuda as kcuda  # noqa: E402
from apex_tpu_torch.models import resnet50  # noqa: E402
from apex_tpu_torch.parallel import (collectives, convert_syncbn_model,  # noqa: E402
                                     launch, make_mesh)
from apex_tpu_torch.train import DDPTrainer, Trainer  # noqa: E402


def host_ops(step, n=3, top=15) -> dict:
    """The host's time a step under ``torch.profiler`` (CPU only): wall,
    the self time of every op (collectives apart: ``c10d`` ops and the
    ``record_param_comms`` span around each), what is outside any op,
    and the ``top`` ops by self time."""
    import time

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = [(e.self_cpu_time_total / 1e3 / n, e.count / n, e.key)
            for e in prof.key_averages()]
    comm = sum(ms for ms, _, k in rows
               if "c10d" in k or "nccl" in k.lower()
               or k == "record_param_comms")
    inside = sum(ms for ms, _, _ in rows)
    rows.sort(reverse=True)
    return {"wall_ms_per_step": wall, "ops_self_ms": inside,
            "collective_ops_self_ms": comm,
            "other_ops_self_ms": inside - comm,
            "outside_ops_ms": wall - inside,
            "op_calls_per_step": sum(c for _, c, _ in rows),
            "top_ops": [{"ms": ms, "calls": c, "name": k[:80]}
                        for ms, c, k in rows[:top]]}


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(cs.nvidia_smi("name,power.limit"), flush=True)
kcuda.lib()
tmp = tempfile.mkdtemp()
launch.initialize(device="cuda", rank=0, world_size=1,
                  init_method=f"file://{tmp}/s")
make_mesh(device="cuda")
model = resnet50()
params, state = model.init(0)
x, y = cs.dp_batch(torch, 1000)
plain = Trainer(model, params, state)
ddp = DDPTrainer(convert_syncbn_model(model), params, state)
fams = cs.KERNEL_FAMILIES + (("nccl", ("nccl",)),)
for _ in range(3):
    plain.step(x, y)
    ddp.step(x, y)
for name, tr in (("plain", plain), ("ddp", ddp), ("ddp", ddp),
                 ("plain", plain)):
    r = cs.timed_steps(torch, lambda: tr.step(x, y), 0, 10)
    prof = cs.profile_steps(torch, lambda: tr.step(x, y), families=fams,
                            n=3)
    host = host_ops(lambda: tr.step(x, y))
    print(json.dumps({"arm": name, "step_ms_p50": sorted(r["step_ms"])[5],
                      "img_per_s": 256 * 10 / r["wall"],
                      "profile": prof, "host": host}), flush=True)
collectives.unbind_axes()
torch.distributed.destroy_process_group()
