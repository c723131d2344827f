"""Device programs: the port's counterpart of ``jax.jit(...,
donate_argnums=...)`` in ``apex_tpu/serve/engine.py:784-822``.

A :class:`DeviceProgram` wraps one body of the serving engine (a prefill
chunk, a commit, a decode or speculative step). The body reads its host
inputs from a fixed :class:`Inputs` block and updates the engine's state
in place, so every call touches the same device addresses. On the card:

- the first call runs the body once eagerly on the capture stream (which
  also builds the kernels at first use), then captures it into a
  ``torch.cuda.CUDAGraph``; every later call replays the graph. All the
  graphs of one engine share one memory pool and one capture stream
  (:class:`GraphPool`), which no other engine's share.
  ``captures`` counts the captures, as JAX's ``_cache_size()`` counts
  compiles;
- a capture that fails raises: nothing runs the body eagerly in its
  place. Only inside :func:`eager` do the bodies run uncaptured on the
  card (the graph-against-eager checks), as ``dispatch.backend(
  "reference")`` forces the plain kernels;
- a replay launches the kernels without calling their Python wrappers, so
  the capture records each counted wrapper's launches (``launches``) and
  every replay adds them to the wrappers' ``.launches`` counts, under one
  lock: replicas replaying in several threads lose no count (``replays``
  counts a program's replays).

A fleet (the router's in-process replicas, ``serve/router.py``) runs
engines in threads on one card. :func:`join_fleet` admits an engine only
when all its programs are captured, and gives its thread a CUDA stream of
its own (:func:`fleet_member`). While any replica runs, no program may
capture (a capture synchronizes the card, collects garbage and empties
the allocator's cache under every other replica) or run eagerly: it
raises instead.

On the CPU a call runs the body eagerly and nothing else changes.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import threading

import numpy as np
import torch

__all__ = ["DeviceProgram", "Inputs", "GraphPool", "eager", "new_pool",
           "counted_wrappers", "join_fleet", "fleet_member",
           "fleet_running", "add_launches"]

_state = {"eager": False}
_fleet = {"running": 0}       # replica threads between join and leave
_fleet_mu = threading.Lock()
_launch_mu = threading.Lock()   # the wrappers' counts under replay


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


def join_fleet(engine):
    """Admit ``engine`` as a replica of a running fleet (called by
    ``EngineReplica.start`` in the starting thread) and count it running
    until its thread leaves (:func:`fleet_member`). On the card every
    program must be captured and no :func:`eager` context open, or this
    raises; the result is the replica's own stream, ordered after the
    starting thread's current stream (``warmup()``'s work and the pool
    reset). On the CPU the result is None."""
    dev = engine.device
    stream = None
    if dev.type == "cuda":
        missing = sorted(n for n, p in engine.programs.items()
                         if p._graph is None)
        if missing:
            raise RuntimeError(
                f"EngineReplica.start: the engine's programs {missing} are "
                f"not captured; call engine.warmup() before starting a "
                f"fleet (a capture while replicas run would stall them)")
        if _state["eager"]:
            raise RuntimeError(
                "EngineReplica.start inside programs.eager(): a fleet "
                "replays captured graphs only")
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
    with _fleet_mu:
        _fleet["running"] += 1
    return stream


@contextlib.contextmanager
def fleet_member(stream):
    """The replica thread's side of :func:`join_fleet`: its body runs on
    ``stream`` (None: as it is), and the replica leaves the fleet when
    the body ends, raised or not."""
    try:
        if stream is None:
            yield
        else:
            with torch.cuda.stream(stream):
                yield
    finally:
        with _fleet_mu:
            _fleet["running"] -= 1


def fleet_running() -> int:
    """The replicas running now, in this process."""
    return _fleet["running"]


def add_launches(counts) -> None:
    """Add each ``(wrapper, n)`` of ``counts`` to the wrapper's
    ``.launches`` under one lock (a replay's accounting)."""
    with _launch_mu:
        for fn, n in counts:
            fn.launches += n


class GraphPool:
    """What one engine's programs share on the card: a graph memory pool
    (``handle``) and a capture stream (``stream``). The stream is the
    engine's own because PyTorch gives a cuBLAS handle one workspace per
    stream, and a captured product keeps the workspace it was captured
    with: engines captured on one stream (``torch.cuda.graph``'s default)
    would share it, and two of them replaying at once on two streams
    would overwrite each other's products."""

    def __init__(self, device: torch.device):
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)


def new_pool(device: torch.device):
    """One :class:`GraphPool` for all of an engine's programs (None on the
    CPU)."""
    return GraphPool(device) if device.type == "cuda" else None


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
        self.replays = 0
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
        cuda = self.device.type == "cuda"
        if cuda and (_state["eager"] or self._graph is None) \
                and _fleet["running"]:
            what = "an eager call" if _state["eager"] else "a capture"
            raise RuntimeError(
                f"program {self.name}: {what} while {_fleet['running']} "
                f"replica(s) of a fleet run; warm every engine up "
                f"(warmup()) before the fleet starts")
        if arrays:
            self.inputs.feed(**arrays)
        if not cuda:
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
            self.replays += 1
            add_launches(self._replay_counts)
            out = self._out
        self._last = out
        return out

    def _capture(self):
        """The eager first run on the capture stream (the pool's, else a
        new one), then the capture there. The wrappers' counts move
        during the capture though nothing launches: they are restored,
        and the difference is what a replay adds."""
        cur = torch.cuda.current_stream(self.device)
        pool = self.pool.handle if self.pool is not None else None
        side = (self.pool.stream if self.pool is not None
                else torch.cuda.Stream(self.device))
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
            with torch.cuda.graph(graph, pool=pool, stream=side):
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
