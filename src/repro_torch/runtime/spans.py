"""Spans of the port's own layers, kept in memory while a torch profiler
is on.

``with span("session.encode"): ...`` times a stretch of the program.  A
span records only while a ``torch.profiler`` profile is active in the
process (``torch.autograd.profiler._is_profiler_enabled``, which every
thread reads the same); otherwise :func:`span` returns one shared object
whose ``__enter__``/``__exit__`` do nothing, so the cost off is a flag
read and two empty calls.  There is no other switch.

On, a span appends a record (name, the index of the span open around it
on the same thread, thread id, start and end) and adds to its name's
``calls``, ``total_s`` and ``self_s`` (the span less its child spans).
Start and end are ``time.time_ns()``, the clock of the profiler's raw
events (``kineto_results.events()``), so the records line up with the
device's kernels and copies in the same trace.  The records stop at
:data:`CAP`; later spans still add to the sums and count as ``dropped``.

A span opens no ``torch.profiler.record_function`` range: with CUDA
activity on, the profiler mirrors each range as a device-side annotation,
which a reduction of the trace would count as a device operation.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

CAP = 1 << 20       # records kept; the sums go on past it


class Record(NamedTuple):
    name: str
    parent: Optional[int]     # index of the enclosing span's record
    thread: int
    start_ns: int
    end_ns: Optional[int]     # None while the span is open


class _Off:
    """The span returned while no profiler is on: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        return False


OFF = _Off()


class Recorder:
    """The records and the table by name, under one lock, and each
    thread's stack of open spans."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self._records: List[list] = []
            self._table: Dict[str, list] = {}   # name -> [calls, ns, self ns]
            self.dropped = 0
            self.generation = getattr(self, "generation", 0) + 1

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def totals(self) -> Dict[str, dict]:
        """{name: {"calls", "total_s", "self_s"}}, a copy."""
        with self.lock:
            return {k: {"calls": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
                    for k, (c, t, s) in self._table.items()}

    def records(self) -> List[Record]:
        """Every record kept, in the order the spans opened, a copy."""
        with self.lock:
            return [Record(*r) for r in self._records]


class _Span:
    __slots__ = ("rec", "name", "index", "gen", "start", "child_ns")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        self.child_ns = 0
        self.start = time.time_ns()
        with rec.lock:
            self.gen = rec.generation
            # an enclosing span from before a reset() is no parent
            parent = (stack[-1].index if stack and stack[-1].gen == self.gen
                      else None)
            if len(rec._records) < rec.cap:
                self.index = len(rec._records)
                rec._records.append([self.name, parent,
                                     threading.get_ident(), self.start,
                                     None])
            else:
                self.index = None
                rec.dropped += 1
        stack.append(self)
        return self

    def __exit__(self, typ, val, tb):
        end = time.time_ns()
        rec = self.rec
        stack = rec.stack()
        stack.pop()
        dur = end - self.start
        if stack:
            stack[-1].child_ns += dur
        with rec.lock:
            if self.gen != rec.generation:
                return False          # reset() while the span was open
            if self.index is not None:
                rec._records[self.index][4] = end
            row = rec._table.get(self.name)
            if row is None:
                row = rec._table[self.name] = [0, 0, 0]
            row[0] += 1
            row[1] += dur
            row[2] += dur - self.child_ns
        return False


RECORDER = Recorder()


def span(name: str):
    """A context manager timing ``name``: recording while a torch
    profiler is on, the shared no-op :data:`OFF` otherwise."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(RECORDER, name)


def totals() -> Dict[str, dict]:
    """{name: {"calls", "total_s", "self_s"}} of every span closed since
    the last :func:`reset`."""
    return RECORDER.totals()


def records() -> List[Record]:
    """The spans' records since the last :func:`reset`."""
    return RECORDER.records()


def reset() -> None:
    RECORDER.reset()
