"""``python -m apex_tpu_torch.parallel.multiproc`` — the reference-named
alias of the local spawner (``launch.multiproc``)."""

from apex_tpu_torch.parallel.launch import _main, multiproc  # noqa: F401

if __name__ == "__main__":  # pragma: no cover - thin CLI
    raise SystemExit(_main())
