"""One step body over static buffers: run eagerly, or captured once as a
CUDA graph and replayed.

The port's counterpart of the JAX package's ``jax.jit`` with donated
arguments.  No JAX module matches it one to one: there, an epoch
(``DTMEngine._fit_epoch_impl``, a ``lax.scan``), a train step and a
stacked flush are each one XLA executable, cached per shape by ``jit``.
Here a :class:`StepGraph` holds the static buffers of one body at one
shape, the ``torch.cuda.CUDAGraph`` captured from it and the graph's
private memory pool.  A replay is one launch where the eager body is a
chain of about a hundred.

The body is a plain function ``body(bufs)`` over a dict of tensors that
updates them in place (``copy_`` of the new program, PRNG state, stats
or answers into the buffers at its end).  Without capture (the CPU, and
the forced ``kernel_path="ref"`` path, whose plain sparse TA update reads
its group count on the host) :meth:`StepGraph.run` calls it eagerly; on
the card it replays the graph of the same function.  So a test that
holds the eager body against the JAX package also holds what the card
replays.

Before its capture the body runs once eagerly on clones of the state
buffers (the constant ones are shared, read-only): that loads every
kernel library and runs each ``cudaFuncSetAttribute`` outside the
capture, and leaves the live state as it was.  The capture uses
``capture_error_mode="thread_local"``, so a checkpoint writer or a
scheduler thread may use the device meanwhile.  A capture or replay that
fails raises; nothing runs the eager chain on the card instead.

Launch counts: the kernel wrappers count when they are called, which
under capture is once, with nothing launched.  A graph keeps the counts
of its capture and adds them to :func:`repro_torch.kernels.ops.
launch_counts` on every replay; the warm-up and the capture themselves
are set-up and leave the counts as they were.
"""
from __future__ import annotations

import gc
import threading
import time
import weakref
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.runtime.spans import span

Buffers = Dict[str, torch.Tensor]


class StepGraph:
    """A body over static buffers (``state``: written by the body;
    ``const``: read only), replayed as a CUDA graph when ``capture``.

    ``stage`` names the engine stage the graph stands for (the JAX
    ``cache_report`` key); ``registry`` (stage -> weak set) lets the
    engine list the graphs alive for a stage (``captured``: the ones
    whose CUDA graph exists).  ``warmup_ms``,
    ``capture_ms`` (capture and instantiation, after the allocator's
    cache is emptied as ``torch.cuda.graph`` empties it) and
    ``pool_bytes`` (the device memory the capture reserved: its private
    pool) are set when it is captured; ``replays`` counts its
    launches."""

    def __init__(self, stage: str, body: Callable[[Buffers], None],
                 state: Buffers, const: Optional[Buffers] = None,
                 capture: bool = False,
                 registry: Optional[Dict[str, "weakref.WeakSet"]] = None):
        self.stage = stage
        self.body = body
        self.state = state
        self.const = dict(const or {})
        self.bufs: Buffers = {**self.const, **state}
        self.capture = capture
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.capture_ms = self.warmup_ms = None
        self.pool_bytes = None
        # per role: weak references to the caller's objects the buffers
        # were last loaded from or handed out as (:meth:`holds`)
        self._marks: Dict[str, tuple] = {}
        # held by a caller across loading the buffers, running and
        # reading them out: the buffers are shared by every caller
        self.lock = threading.Lock()
        if registry is not None:
            registry.setdefault(stage, weakref.WeakSet()).add(self)

    @property
    def captured(self) -> bool:
        """Whether the CUDA graph of this body exists (captured)."""
        return self.graph is not None

    def _capture(self) -> None:
        with span("graph.capture"):
            self._capture_now()

    def _capture_now(self) -> None:
        saved = kops.launch_counts()
        t0 = time.perf_counter()
        clones = {k: v.clone() for k, v in self.state.items()}
        self.body({**self.const, **clones})
        torch.cuda.synchronize()  # dtmlint: disable=DTM003 (set-up, before a capture)
        del clones
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t2 = time.perf_counter()
        kops.set_launch_counts({k: 0 for k in saved})
        graph = torch.cuda.CUDAGraph()
        # a CUDA graph freed during the capture (a dead engine's, by the
        # cyclic collector, which runs in whichever thread allocates)
        # invalidates it: no collection runs until the capture ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            # as torch.cuda.graph, but the caller's stream comes back
            # even when the capture fails
            with torch.cuda.stream(torch.cuda.Stream()):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.body(self.bufs)
                finally:
                    graph.capture_end()
            self.launches = {k: v for k, v in kops.launch_counts().items()
                             if v}
        finally:
            if collecting:
                gc.enable()
            kops.set_launch_counts(saved)
        self.graph = graph
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t2) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved() - reserved

    def prepare(self) -> None:
        """Capture now (if this graph captures and has not yet): the
        warm-up and the capture synchronise the device, so a caller that
        guards against host syncs prepares first."""
        if self.capture and self.graph is None:
            self._capture()

    def mark(self, role: str, *objs) -> None:
        """Note that the buffers of ``role`` now hold ``objs``' values
        (loaded from them, or handed out as them)."""
        self._marks[role] = tuple(weakref.ref(o) for o in objs)

    def holds(self, role: str, *objs) -> bool:
        """Whether the buffers of ``role`` hold ``objs``' values: the very
        objects last marked (nothing else writes a graph's buffers)."""
        refs = self._marks.get(role)
        return refs is not None and len(refs) == len(objs) and all(
            r() is o for r, o in zip(refs, objs))

    def run(self, times: int = 1) -> None:
        """``times`` runs of the body: replays of the graph (captured at
        the first run), or eager calls.  A run writes the state buffers,
        so they no longer hold what role ``state`` was marked with (even
        when it raises part way)."""
        self._marks.pop("state", None)
        with span("graph.run"):
            if not self.capture:
                for _ in range(times):
                    self.body(self.bufs)
                return
            self.prepare()
            for _ in range(times):
                self.graph.replay()
            self.replays += times
            kops.add_launches(self.launches, times)
