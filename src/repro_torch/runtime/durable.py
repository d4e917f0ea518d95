"""Durable tenant state for the streaming-learning serving stack.

A tenant's durable image is its TA states, its weights and its PRNG (the
include bitplane is rebuilt from the TA states on restore), written
through :mod:`repro_torch.checkpoint` in the JAX package's format: a
server that dies mid-stream cold-starts from the latest durable step of
every tenant and continues bit-identically.

Layout under ``root/``::

    manifest.json                      # roster: spec/SLA/seed per tenant
    tenants/<name>/step_XXXXXXXX/      # checkpoint dirs (atomic)

* :class:`DurableStore` — the on-disk layout: the manifest published
  through a tmp file and ``os.replace``, per-tenant step checkpoints.
* :class:`CheckpointWriter` — the background writer: the scheduler marks
  tenants dirty after each applied training step, and the writer saves
  the dirty set every ``interval_s``, off the driver.  A save that fails
  at the ``checkpoint`` boundary (injected, or a real I/O error) leaves
  the tenant dirty for the next sweep.
* :func:`restore_tenant` — one tenant from its latest durable step:
  ``engine.lower`` for the geometry, TA states and weights replaced,
  include bitplane rebuilt, PRNG restored.

Tensors are mutable here, where the JAX package's arrays are not: the
owner's ``snapshot_fn`` hands the writer copies taken under its lock, on
the device's one stream, so the writer reads them at leisure while the
driver goes on training or swapping bank slots.  The writer's copies to
the host run on the same stream, after everything launched before them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import threefry
from repro_torch.core.prng import PRNG

__all__ = ["DurableStore", "CheckpointWriter", "restore_tenant"]

_MANIFEST = "manifest.json"


class DurableStore:
    """On-disk durable state: roster manifest + per-tenant checkpoints.

    ``keep`` is the per-tenant retention (the newest ``keep`` steps; 0
    keeps all)."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(os.path.join(root, "tenants"), exist_ok=True)

    # ---- manifest ---------------------------------------------------------
    def write_manifest(self, manifest: dict) -> None:
        """Atomic publish (tmp + rename): a reader never sees a torn
        manifest, and a writer killed mid-dump leaves the old one."""
        final = os.path.join(self.root, _MANIFEST)
        tmp = final + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(tmp, final)

    def read_manifest(self) -> Optional[dict]:
        path = os.path.join(self.root, _MANIFEST)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    # ---- per-tenant checkpoints -------------------------------------------
    def tenant_dir(self, name: str) -> str:
        return os.path.join(self.root, "tenants", name)

    def save_tenant(self, name: str, step: int, tree) -> str:
        return ckpt.save(self.tenant_dir(name), step, tree, keep=self.keep)

    def latest_tenant_step(self, name: str) -> Optional[int]:
        return ckpt.latest_step(self.tenant_dir(name))

    def load_tenant(self, name: str, like) -> Optional[Tuple[int, dict]]:
        got = ckpt.restore_latest(self.tenant_dir(name), like)
        if got is None:
            return None
        step, tree, _ = got
        return step, tree


def restore_tenant(store: DurableStore, name: str, engine, spec,
                   seed: int = 0):
    """Rebuild one tenant from its latest durable step.

    Returns ``(program, prng, step)``, or ``None`` when the tenant has no
    durable state yet (the caller registers it fresh).  ``seed`` is the
    tenant's registration seed (the manifest records it): the structure
    is lowered from the threefry key ``PRNGKey(seed)``, as the JAX
    package lowers it, and a tenant without a checkpoint registers from
    the same seed, so it cold-starts to the JAX package's program."""
    program = engine.lower(spec, threefry.key(seed, engine.device))
    prng = PRNG.create(spec.tm_config(), seed + 1, device=engine.device)
    got = store.load_tenant(name, like={"ta": program.ta,
                                        "weights": program.weights,
                                        "prng": prng})
    if got is None:
        return None
    step, tree = got
    program = dataclasses.replace(program, ta=tree["ta"],
                                  weights=tree["weights"])
    # the TA states were replaced wholesale: rebuild the include bitplane
    # the train stages otherwise keep up themselves
    return engine.refresh_include(program), tree["prng"], step


class CheckpointWriter:
    """Background checkpointing: save a dirty-tenant set off the driver.

    ``snapshot_fn(name) -> (step, tree)`` is the owner's (the
    scheduler's): it copies the tenant's TA states, weights and PRNG
    under its lock, so the image is consistent and no later in-place
    write reaches it.

    Runs as a daemon thread (:meth:`start`, a sweep every
    ``interval_s``) or inline (:meth:`flush` with no thread running
    saves on the caller).  A failed save re-marks the tenant dirty:
    durability falls back to the previous step, never to a torn write.
    ``stats()["save_ms"]`` is each tenant's last save, host wall time
    from the fetch of its copies to the published directory."""

    def __init__(self, store: DurableStore,
                 snapshot_fn: Callable[[str], Tuple[int, dict]],
                 interval_s: float = 0.25, injector=None):
        self.store = store
        self.snapshot_fn = snapshot_fn
        self.interval_s = interval_s
        self.injector = injector
        self._dirty: set = set()
        self._cond = threading.Condition()
        self._busy = 0                 # saves in progress (flush barrier)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.saves = 0
        self.failures = 0
        self.last_saved: Dict[str, int] = {}
        self.save_ms: Dict[str, float] = {}   # wall ms of the last save
        self.last_error: Optional[str] = None

    # ---- dirty-set ingress (driver thread) ---------------------------------
    def mark_dirty(self, name: str) -> None:
        with self._cond:
            self._dirty.add(name)
            self._cond.notify_all()

    # ---- the sweep ---------------------------------------------------------
    def _drain(self) -> int:
        """Save every dirty tenant once; returns the number saved."""
        with self._cond:
            batch = sorted(self._dirty)
            self._dirty.clear()
            self._busy += 1
        done = 0
        try:
            for name in batch:
                step, tree = self.snapshot_fn(name)
                t0 = time.perf_counter()
                try:
                    if self.injector is not None:
                        self.injector.check("checkpoint")
                    self.store.save_tenant(name, step, tree)
                except (RuntimeError, OSError) as e:
                    # durability falls back to the previous step; the
                    # tenant stays dirty and the next sweep retries
                    with self._cond:
                        self.failures += 1
                        self.last_error = repr(e)
                        self._dirty.add(name)
                    continue
                with self._cond:
                    self.saves += 1
                    self.last_saved[name] = step
                    self.save_ms[name] = (time.perf_counter() - t0) * 1e3
                done += 1
        finally:
            with self._cond:
                self._busy -= 1
                self._cond.notify_all()
        return done

    def flush(self, timeout: Optional[float] = 30.0) -> None:
        """Synchronous barrier: every tenant dirty at call time is durable
        (or counted as a failure) when this returns.  Saves inline when
        the background thread is not running."""
        if self._thread is None:
            self._drain()
            return
        with self._cond:
            self._cond.notify_all()
            ok = self._cond.wait_for(
                lambda: not self._dirty and self._busy == 0, timeout)
        if not ok:
            raise TimeoutError("checkpoint writer did not drain in time")

    # ---- background thread -------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("checkpoint writer already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tm-ckpt-writer")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                if not self._dirty:
                    self._cond.wait(self.interval_s)
                    continue
            # coalesce a burst of marks into one sweep per interval
            self._stop.wait(self.interval_s)
            self._drain()
        self._drain()                  # final sweep: nothing dirty is lost

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise RuntimeError("checkpoint writer hung")
        self._thread = None

    def stats(self) -> dict:
        with self._cond:
            return {"saves": self.saves, "failures": self.failures,
                    "dirty": len(self._dirty),
                    "running": self._thread is not None,
                    "last_saved": dict(self.last_saved),
                    "save_ms": dict(self.save_ms),
                    "last_error": self.last_error}
