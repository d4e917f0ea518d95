"""Fault injection + recovery primitives for the DTM serving stack.

The durable streaming-learning layer (``repro_torch.launch.scheduler``
with a ``repro_torch.runtime.durable.DurableStore`` attached) claims it
survives failures at every stage of a request's life.  This module is
how that claim is *tested* and *enforced*.  Pure Python, the JAX
package's ``runtime/fault.py`` kept as the port's own copy:

* :class:`FaultInjector` / :class:`FaultPlan` — deterministic, API-driven
  failure injection at the four driver boundaries (``encode``, ``launch``,
  ``collect``, ``checkpoint``).  Faults fire at boundary ENTRY — before
  any device or filesystem mutation — so a retried call re-executes
  cleanly (the injection model mirrors a launch that never reached the
  device).  Injection is constructor-plumbed, never environment-driven:
  config resolves once (DTM002) and a test's failure schedule is explicit
  in the test.
* :class:`RetryPolicy` / :func:`with_retry` — bounded retry with
  (optional) exponential backoff for *transient* boundary failures; a
  non-transient :class:`InjectedFault` or exhausted budget re-raises to
  the caller, which fails the affected futures and enters degraded mode.
* :class:`StepMonitor` — per-flush wall-time EWMA; flags stragglers
  (flush > ``factor`` × EWMA after warmup) so the scheduler can surface
  heartbeat gaps in ``stats()`` without a separate watchdog thread.
  Straggler samples are folded in clamped so one pathological flush does
  not drag the baseline up and mask the next one.

Exercised by ``tests/test_torch_recovery.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Mapping, Optional, Sequence

__all__ = ["BOUNDARIES", "InjectedFault", "FaultPlan", "FaultInjector",
           "RetryPolicy", "with_retry", "StepMonitor"]


# the four driver boundaries a request crosses (encode on the driver
# thread, launch/collect on the device, checkpoint on the writer)
BOUNDARIES = ("encode", "launch", "collect", "checkpoint")


class InjectedFault(RuntimeError):
    """A scheduled failure fired at a driver boundary.

    ``transient`` faults model recoverable conditions (a launch the
    runtime can simply launch again) and are eligible for :func:`with_retry`;
    non-transient faults model hard errors and propagate immediately."""

    def __init__(self, boundary: str, index: int, transient: bool = True):
        super().__init__(f"injected {'transient' if transient else 'hard'} "
                         f"fault at {boundary!r} boundary (call #{index})")
        self.boundary = boundary
        self.index = index
        self.transient = transient


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic failure schedule: per boundary, WHICH calls fail.

    ``fail`` maps a boundary name to the 0-based call indices that raise
    (e.g. ``{"launch": (2, 3)}`` fails the 3rd and 4th launches);
    ``transient`` marks every scheduled fault retryable."""

    fail: Mapping[str, Sequence[int]] = dataclasses.field(
        default_factory=dict)
    transient: bool = True

    def __post_init__(self):
        unknown = set(self.fail) - set(BOUNDARIES)
        if unknown:
            raise ValueError(f"unknown fault boundaries: {sorted(unknown)}")


class FaultInjector:
    """Counts boundary crossings and raises per a :class:`FaultPlan`.

    One injector is shared by the scheduler and the checkpoint writer;
    ``check`` is called at every boundary entry (cheap: a dict bump).
    Thread safety relies on the GIL for the counter bump — exact
    interleaving across threads is not part of the injection contract
    (plans target per-boundary indices, and each boundary is crossed by
    exactly one thread)."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self.calls: Dict[str, int] = {b: 0 for b in BOUNDARIES}
        self.injected: Dict[str, int] = {b: 0 for b in BOUNDARIES}

    def check(self, boundary: str) -> None:
        """Cross ``boundary``: raise :class:`InjectedFault` if this call
        index is scheduled to fail, else return."""
        idx = self.calls[boundary]
        self.calls[boundary] = idx + 1
        if idx in tuple(self.plan.fail.get(boundary, ())):
            self.injected[boundary] += 1
            raise InjectedFault(boundary, idx, self.plan.transient)

    def stats(self) -> dict:
        return {"calls": dict(self.calls), "injected": dict(self.injected)}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry budget for transient boundary faults.

    ``retries`` is the number of RE-attempts after the first failure
    (``retries=3`` allows up to 4 invocations); ``backoff_s`` sleeps
    before each re-attempt, growing by ``multiplier``."""

    retries: int = 3
    backoff_s: float = 0.0
    multiplier: float = 2.0


def with_retry(fn: Callable, policy: RetryPolicy,
               on_retry: Optional[Callable[[int, BaseException],
                                           None]] = None):
    """Call ``fn()`` retrying transient :class:`InjectedFault` s under
    ``policy``.  Non-transient faults, other exceptions, and budget
    exhaustion re-raise; ``on_retry(attempt, exc)`` observes each
    re-attempt (the scheduler counts them)."""
    delay = policy.backoff_s
    for attempt in range(policy.retries + 1):
        try:
            return fn()
        except InjectedFault as e:
            if not e.transient or attempt == policy.retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if delay > 0:
                time.sleep(delay)
                delay *= policy.multiplier
    raise AssertionError("unreachable")


class StepMonitor:
    """Per-flush wall-time EWMA with straggler detection.

    ``record(dt)`` returns True when ``dt`` exceeds ``factor`` × the
    running EWMA after ``warmup`` samples (the heartbeat signal the
    scheduler surfaces in ``stats()``).  A straggler sample is folded in
    CLAMPED at ``factor`` × EWMA, so a single pathological flush cannot
    inflate the baseline and mask the next straggler."""

    def __init__(self, factor: float = 4.0, alpha: float = 0.2,
                 warmup: int = 5):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.n = 0
        self.stragglers = 0

    def record(self, dt: float) -> bool:
        """Returns True if this flush is a straggler."""
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = self.n > self.warmup and dt > self.factor * self.ewma
        if is_straggler:
            self.stragglers += 1
            dt = self.factor * self.ewma          # clamped fold-in
        self.ewma = self.alpha * dt + (1 - self.alpha) * self.ewma
        return is_straggler

    @property
    def mean(self) -> float:
        return float(self.ewma) if self.ewma is not None else 0.0

    def stats(self) -> dict:
        return {"ewma_s": self.mean, "samples": self.n,
                "stragglers": self.stragglers}
