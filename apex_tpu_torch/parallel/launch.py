"""Process launch — counterpart of ``apex_tpu/parallel/launch.py``.

The JAX runtime is a process a host; ``torch.distributed`` is a process a
device, as the reference's launcher is (apex/parallel/multiproc.py:12-35).
:func:`initialize` is ``dist.init_process_group``: NCCL for the card,
gloo for ``device="cpu"`` (or the ``backend`` the caller names: gloo over
CUDA tensors runs by the rules of ``collectives.collective_rules``). It
reads ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT`` from
the environment, or takes them and an ``init_method``.
:func:`multiproc` spawns ``world_size`` local processes of a script with
``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` set; the CLI is ``python -m
apex_tpu_torch.parallel.launch <world_size> script.py [args...]``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Optional

__all__ = ["initialize", "multiproc"]


def initialize(backend: Optional[str] = None, *, device=None,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, timeout=None) -> str:
    """Join the process group; returns its backend. On the card the
    process takes the card ``LOCAL_RANK`` (mod the cards it sees)."""
    import datetime

    import torch
    import torch.distributed as dist

    from apex_tpu_torch._device import resolve_device
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else int(world_size)
    if init_method is None:
        for k in ("MASTER_ADDR", "MASTER_PORT"):
            if k not in os.environ:
                raise RuntimeError(f"initialize: {k} is not set; set it or "
                                   f"pass init_method=")
        init_method = "env://"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return dist.get_backend()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multiproc(script: str, world_size: int, *script_args: str,
              log_dir: str = ".", timeout: Optional[float] = None) -> int:
    """Spawn ``world_size`` local processes of ``script``, each with
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and ``MASTER_ADDR`` /
    ``MASTER_PORT`` where the environment has none); rank 0 writes to this
    process's output, rank n to ``rank{n}.log`` in ``log_dir``. Returns
    the first nonzero exit status (a signal's negative code included), 0
    if all succeeded. With ``timeout`` (seconds from the start) the
    processes still running then are killed."""
    base = dict(os.environ)
    base.setdefault("MASTER_ADDR", "127.0.0.1")
    base.setdefault("MASTER_PORT", str(_free_port()))
    procs, logs = [], []
    for rank in range(world_size):
        env = dict(base, WORLD_SIZE=str(world_size), RANK=str(rank),
                   LOCAL_RANK=str(rank))
        argv = [sys.executable, script, *script_args]
        if rank == 0:
            p = subprocess.Popen(argv, env=env)
        else:
            out = open(os.path.join(log_dir, f"rank{rank}.log"), "w")
            logs.append(out)
            p = subprocess.Popen(argv, env=env, stdout=out, stderr=out)
        procs.append(p)
    deadline = None if timeout is None else time.monotonic() + timeout
    codes = []
    try:
        for p in procs:
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            try:
                codes.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                codes.append(p.wait())
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
        for f in logs:
            f.close()
    return next((rc for rc in codes if rc != 0), 0)


def _main(argv=None):
    """CLI: ``python -m apex_tpu_torch.parallel.launch <world_size>
    script.py [args...] [--log-dir DIR]``."""
    import argparse
    p = argparse.ArgumentParser(prog="apex_tpu_torch.parallel.launch")
    p.add_argument("world_size", type=int)
    p.add_argument("script")
    p.add_argument("script_args", nargs="*")
    p.add_argument("--log-dir", default=".")
    a = p.parse_args(argv)
    return multiproc(a.script, a.world_size, *a.script_args,
                     log_dir=a.log_dir)


if __name__ == "__main__":  # pragma: no cover - thin CLI
    raise SystemExit(_main())
