"""Data pipeline: deterministic seekable sources, host sharding and a
prefetching thread, the JAX package's ``data/pipeline.py``.

* :class:`Source` — sample = f(seed, epoch, index), so a run resumes on
  the exact batch after a checkpoint restore;
* :class:`HostShardIterator` — each process reads only its slice of the
  global batch: by default the rank and world size of the initialised
  ``torch.distributed`` group (0 and 1 without one), where JAX reads
  ``jax.process_index()`` / ``process_count()``;
* :class:`Prefetcher` — a background thread keeps ``depth`` items ready
  (input-side straggler mitigation); an error in the thread is raised to
  the consumer.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np


def _process() -> Tuple[int, int]:
    """(rank, world size) of the default process group, or (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass
class Source:
    """Deterministic seekable source: sample = f(seed, epoch, index)."""

    n: int
    make: Callable[[np.random.Generator, int], Tuple[np.ndarray, np.ndarray]]
    seed: int = 0

    def batch(self, epoch: int, start: int, size: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, start]))
        return self.make(rng, size)


class HostShardIterator:
    """Process-local slices of a global batch, deterministically.  The
    state (epoch, offset) goes into checkpoints, so training resumes on
    the exact next batch."""

    def __init__(self, source: Source, global_batch: int,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.source = source
        self.global_batch = global_batch
        rank, world = _process()
        self.pi = rank if process_index is None else process_index
        self.pc = world if process_count is None else process_count
        if global_batch % self.pc:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {self.pc} processes")
        self.local = global_batch // self.pc
        self.epoch = 0
        self.offset = 0

    def state(self) -> dict:
        return {"epoch": self.epoch, "offset": self.offset}

    def restore(self, st: dict):
        self.epoch, self.offset = int(st["epoch"]), int(st["offset"])

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self.offset + self.global_batch > self.source.n:
            self.epoch += 1
            self.offset = 0
        start = self.offset + self.pi * self.local
        batch = self.source.batch(self.epoch, start, self.local)
        self.offset += self.global_batch
        return batch


class Prefetcher:
    """A background thread that keeps up to ``depth`` transformed items
    ready; ``close`` stops it after the item in hand."""

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.transform = transform or (lambda x: x)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(self.transform(item))
        except Exception as e:  # raised again on the consumer side
            self.q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
