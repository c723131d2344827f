"""Device programs: the port's counterpart of ``jax.jit(...,
donate_argnums=...)`` in ``apex_tpu/serve/engine.py:784-822``.

A :class:`DeviceProgram` wraps one body of the serving engine (a prefill
chunk, a commit, a decode or speculative step). The body reads its host
inputs from a fixed :class:`Inputs` block and updates the engine's state
in place, so every call touches the same device addresses. On the card:

- the first call runs the body once eagerly on a side stream (which also
  builds the kernels at first use), then captures it into a
  ``torch.cuda.CUDAGraph``; every later call replays the graph. All the
  graphs of one engine share one memory pool (:func:`new_pool`).
  ``captures`` counts the captures, as JAX's ``_cache_size()`` counts
  compiles;
- a capture that fails raises: nothing runs the body eagerly in its
  place. Only inside :func:`eager` do the bodies run uncaptured on the
  card (the graph-against-eager checks), as ``dispatch.backend(
  "reference")`` forces the plain kernels;
- a replay launches the kernels without calling their Python wrappers, so
  the capture records each counted wrapper's launches (``launches``) and
  every replay adds them to the wrappers' ``.launches`` counts.

On the CPU a call runs the body eagerly and nothing else changes.
"""

from __future__ import annotations

import contextlib
import gc
import sys

import numpy as np
import torch

__all__ = ["DeviceProgram", "Inputs", "eager", "new_pool",
           "counted_wrappers"]

_state = {"eager": False}


@contextlib.contextmanager
def eager():
    """Run every program body uncaptured on the card (no capture, no
    replay) while the context is open; process-wide, as
    ``dispatch.backend``."""
    prev = _state["eager"]
    _state["eager"] = True
    try:
        yield
    finally:
        _state["eager"] = prev


def new_pool(device: torch.device):
    """One graph memory pool for all of an engine's programs (None on the
    CPU)."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


def counted_wrappers() -> list:
    """The kernel wrappers that count their launches (``.launches``) in
    the loaded ``apex_tpu_torch.ops`` modules."""
    seen = {}
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("apex_tpu_torch.ops."):
            continue
        for fn in vars(mod).values():
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int):
                seen[id(fn)] = fn
    return list(seen.values())


def _counts(fns) -> list:
    return [fn.launches for fn in fns]


_CONVERT = {torch.int64: lambda t: t,
            torch.int32: lambda t: t.to(torch.int32),
            torch.bool: lambda t: t != 0}


class Inputs:
    """A program's host inputs at fixed device addresses: ``layout`` maps a
    name to ``(shape, dtype)`` (int64, int32 or bool). All of them live in
    one int64 device buffer, filled by ONE host->device copy per
    :meth:`feed`; :meth:`get` gives the typed views, converted inside the
    body (so inside the graph). On the card the copy goes through pinned
    memory without blocking; the caching host allocator keeps each pinned
    snapshot alive until its copy has run, so the caller may mutate its
    arrays (the page table) right after."""

    def __init__(self, layout: dict, device: torch.device):
        self.layout = {n: (tuple(s), dt) for n, (s, dt) in layout.items()}
        for n, (_, dt) in self.layout.items():
            if dt not in _CONVERT:
                raise TypeError(f"input {n}: dtype {dt} is not int64, "
                                f"int32 or bool")
        self.device = device
        sizes = [int(np.prod(s)) for s, _ in self.layout.values()]
        self._buf = torch.zeros((sum(sizes),), dtype=torch.int64,
                                device=device)
        self._views, off = {}, 0
        for (n, (shape, _)), size in zip(self.layout.items(), sizes):
            self._views[n] = self._buf[off:off + size].view(shape)
            off += size
        self._host = np.zeros((sum(sizes),), np.int64)

    def feed(self, **arrays) -> None:
        """Fill every input (each array of its declared shape) with one
        copy."""
        if set(arrays) != set(self.layout):
            raise ValueError(f"inputs {sorted(arrays)} do not match the "
                             f"layout {sorted(self.layout)}")
        off = 0
        for n, (shape, _) in self.layout.items():
            a = np.asarray(arrays[n])
            if a.shape != shape:
                raise ValueError(f"input {n}: shape {a.shape}, the program "
                                 f"was built for {shape}")
            size = a.size
            self._host[off:off + size] = a.reshape(-1)
            off += size
        t = torch.from_numpy(self._host)
        if self.device.type == "cuda":
            self._buf.copy_(t.pin_memory(), non_blocking=True)
        else:
            self._buf.copy_(t)

    def get(self) -> dict:
        """The typed views (call inside the body)."""
        return {n: _CONVERT[dt](self._views[n])
                for n, (_, dt) in self.layout.items()}


class DeviceProgram:
    """One engine program (see the module docstring). ``body()`` takes no
    argument: it reads ``inputs`` (an :class:`Inputs`, possibly shared
    with another program) and the engine's fixed state, and returns one
    tensor (or None). ``prog(**arrays)`` feeds the inputs (when given)
    and runs; :meth:`fetch` copies the last output to the host."""

    def __init__(self, name: str, body, *, device: torch.device,
                 inputs: Inputs = None, pool=None):
        self.name = name
        self.body = body
        self.device = device
        self.inputs = inputs
        self.pool = pool
        self.captures = 0
        self.launches: dict = {}      # a replay's launches, by wrapper
        self.eager_launches: dict = {}   # the last eager call's, on the card
        self.pool_bytes = 0           # reserved memory the capture added
        self._fns = None
        self._replay_counts = []
        self._graph = None
        self._out = None
        self._last = None
        self._host = None

    def __call__(self, **arrays):
        if arrays:
            self.inputs.feed(**arrays)
        if self.device.type != "cuda":
            out = self.body()
        elif _state["eager"]:
            if self._fns is None:
                self._fns = counted_wrappers()
            before = _counts(self._fns)
            out = self.body()
            self.eager_launches = {
                fn.__name__: a - b for fn, a, b
                in zip(self._fns, _counts(self._fns), before) if a != b}
        elif self._graph is None:
            out = self._capture()
        else:
            self._graph.replay()
            for fn, n in self._replay_counts:
                fn.launches += n
            out = self._out
        self._last = out
        return out

    def _capture(self):
        """The eager first run on a side stream, then the capture. The
        wrappers' counts move during the capture though nothing launches:
        they are restored, and the difference is what a replay adds."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.body()
        cur.wait_stream(side)
        fns = counted_wrappers()
        before = _counts(fns)
        # what the capture's own entry does, first: then the reserved
        # memory's growth is the pool's
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                static = self.body()
        finally:
            after = _counts(fns)
            for fn, n in zip(fns, before):
                fn.launches = n
        self._replay_counts = [(fn, a - b) for fn, a, b
                               in zip(fns, after, before) if a != b]
        self.launches = {fn.__name__: n for fn, n in self._replay_counts}
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._graph, self._out = graph, static
        self.captures += 1
        return out

    def fetch(self) -> np.ndarray:
        """The last call's output on the host: on the card one copy into
        pinned memory and one wait on the stream (the call's only sync)."""
        out = self._last
        if self.device.type != "cuda":
            return out.numpy().copy()
        if self._host is None or self._host.shape != out.shape \
                or self._host.dtype != out.dtype:
            self._host = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)
        self._host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._host.numpy().copy()
