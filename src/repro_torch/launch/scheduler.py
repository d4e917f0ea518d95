"""Continuous-batching scheduler over the resident bank, on one device.

Requesters feed per-tenant queues and ONE driver owns the device: the
thread started by :meth:`TMScheduler.start`, or the caller of
:meth:`TMScheduler.step` / :meth:`TMScheduler.drain` when run inline.
The JAX package's ``launch/scheduler.py``, ported:

* **SLA / priority queues** (:class:`SLAClass`): every tenant has an
  admission cap (``max_queue_depth``: :meth:`TMScheduler.submit` raises
  :class:`Backpressure` beyond it) and a latency target
  (``deadline_ms``).  The heads of the non-empty queues are served
  earliest-deadline-first, class ``priority`` breaking ties.
* **Continuous batching**: a cycle takes at most one request per tenant
  (a bank slot serves one request), up to ``max_batch_tenants``, after a
  ``max_wait_s`` formation window, and launches them through
  :meth:`TMServer.flush_async`.
* **Pipelining**: up to ``pipeline_depth`` :class:`PendingFlush` es stay
  in flight while the driver encodes and launches the next batch; a
  launch is collected (the one host sync) once it falls out of the
  window or the queues go idle.  Callers get :class:`TMFuture` s.
* **Dynamic bank membership**: with ``resident_slots`` set, that many
  tenants per family ride the stacked launch and the rest take the cold
  path; a per-tenant EWMA of arrival rate promotes and demotes them
  through :meth:`TMServer.swap_resident` / :meth:`TMServer.add_resident`.
* **Train-while-serve**: :meth:`TMScheduler.submit_train` puts training
  steps on the same cycle; a cycle applies its training requests first,
  and the flush's stale-slot rewrite serves inference off the fresh
  programs.  Per-tenant FIFO order holds, so the trajectory is
  bit-identical to sequential ``train``.  With a
  :class:`repro_torch.runtime.durable.DurableStore` attached
  (``api.serve(..., durable_dir=...)``) a background
  :class:`repro_torch.runtime.durable.CheckpointWriter` saves the
  tenants that trained; ``api.serve(None, durable_dir=...)`` cold-starts
  from the latest durable step of every tenant.
* **Faults**: a :class:`repro_torch.runtime.fault.FaultInjector` fires at
  the ``encode``/``launch``/``collect`` boundaries (the writer owns
  ``checkpoint``); transient faults are retried within ``cfg.retries``,
  exhaustion fails exactly the affected futures, and while recovery is
  in progress batch-class (``priority <= 0``) submits shed.  A
  :class:`repro_torch.runtime.fault.StepMonitor` flags straggling
  collects.
* **Auto-pause**: with ``cfg.pause_skip_threshold`` set, a tenant whose
  clause-skip EWMA says it has converged stops training (its train
  requests serve eval probes) and resumes on a probe-accuracy drop.
* **Pod mode** (a :class:`TMServer` whose ``pod_devices`` > 1): every
  rank runs a scheduler over its rank of the pod server and is handed
  the same requests in the same order per tenant, but its clock and
  the moment a request reaches it are its own, while every flush and
  membership move runs collectives.  So rank 0 of the tenants axis
  decides for all: each driver cycle opens with one broadcast of its
  batch (the tenants, in order, and each head's per-tenant submit
  number), whether its queues hold more, and whether its loop stops;
  each membership tick with one broadcast of its promotions.  The
  other ranks take those heads from their queues (waiting up to
  ``POD_SYNC_S`` for one to arrive) and follow.  Admission control
  is rank 0's: a request it shed is dropped on the other ranks when a
  later request of the tenant is batched, and its future there fails
  with :class:`Backpressure`.  ``drain`` and the loop end when rank 0's
  queues are empty; every rank calls ``start``, ``step``, ``drain`` and
  ``stop`` alike.  Fault retries stay each rank's own, so an
  injected fault schedule must be the same on every rank.

One stream: every device operation of the driver (encodes, bank slot
writes, flushes, training steps, collects) and of the checkpoint
writer (the snapshot copies and their fetches to the host) runs on the
device's current stream, which every thread of a process shares by
default.  That stream orders pipelined flushes against the slot writes
and the snapshot copies launched between them; nothing here makes a
side stream, and one that ever did would need ``record_stream`` or
events.  The driver syncs with the host only in ``collect`` and in a
training step's stats fetch.

Determinism: inference is pure and programs change only by training
requests, so scheduled answers are bit-identical to a synchronous
``enqueue`` + ``flush`` per request whatever the batching
(``tests/test_torch_scheduler.py``; train-while-serve and recovery in
``tests/test_torch_recovery.py``).

Inline::

    sched = TMScheduler(server)
    sched.register("t0", spec)
    fut = sched.submit("t0", x)
    sched.drain()
    fut.result()

or in a background thread::

    sched.start()
    futs = [sched.submit(name, x) for ...]
    sched.stop()                   # drains in-flight work first
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import broadcast
from repro_torch.launch.serve_tm import TMServer
from repro_torch.runtime.fault import (InjectedFault, RetryPolicy,
                                       StepMonitor, with_retry)


# pod mode: how long a rank waits for a request that rank 0 batched
POD_SYNC_S = 30.0


class Backpressure(RuntimeError):
    """Admission control rejected the request: the tenant's queue is at
    its SLA depth cap.  Callers shed load or retry later."""


# one condition shared by every TMFuture: completion is signalled by the
# per-future done flag (waiters re-check it in a loop, so cross-future
# wakeups are harmless), and sharing it makes future creation a plain
# allocation, where concurrent.futures.Future builds a private
# Condition and RLock per instance.
_FUTURE_COND = threading.Condition()


class TMFuture:
    """Minimal future for scheduler results: ``result(timeout)``,
    ``done()``, ``exception()``, ``add_done_callback(fn)``, the subset of
    the :class:`concurrent.futures.Future` surface the serving API
    promises.  Completion methods are driver-side only."""

    __slots__ = ("_done", "_result", "_exc", "_callbacks")

    def __init__(self):
        self._done = False
        self._result = None
        self._exc = None
        self._callbacks = []

    def done(self) -> bool:
        return self._done

    def _finish(self, result, exc) -> None:
        with _FUTURE_COND:
            self._result = result
            self._exc = exc
            self._done = True
            cbs = self._callbacks
            self._callbacks = []
            _FUTURE_COND.notify_all()
        for cb in cbs:
            cb(self)

    def set_result(self, result) -> None:
        self._finish(result, None)

    def set_exception(self, exc: BaseException) -> None:
        self._finish(None, exc)

    def add_done_callback(self, fn) -> None:
        with _FUTURE_COND:
            if not self._done:
                self._callbacks.append(fn)
                return
        fn(self)

    def _wait(self, timeout) -> None:
        if self._done:
            return
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with _FUTURE_COND:
            while not self._done:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("request still pending — is the "
                                       "driver running (start/drain)?")
                _FUTURE_COND.wait(remaining)

    def result(self, timeout: Optional[float] = None):
        self._wait(timeout)
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None):
        self._wait(timeout)
        return self._exc


@dataclasses.dataclass(frozen=True)
class SLAClass:
    """Per-tenant service class: admission cap + latency target.

    ``deadline_ms`` orders batch formation (earliest deadline first), so
    a shorter deadline IS higher effective priority under load;
    ``priority`` breaks deadline ties (higher first).  ``max_queue_depth``
    is the admission-control cap — submits beyond it raise
    :class:`Backpressure` instead of growing an unbounded backlog."""

    name: str = "standard"
    priority: int = 1
    deadline_ms: float = 50.0
    max_queue_depth: int = 64


GOLD = SLAClass("gold", priority=4, deadline_ms=5.0, max_queue_depth=256)
STANDARD = SLAClass()
BATCH = SLAClass("batch", priority=0, deadline_ms=1000.0,
                 max_queue_depth=1024)


@dataclasses.dataclass
class SchedulerConfig:
    """Policy knobs of the continuous-batching driver (the JAX package's;
    see the README's "Async serving")."""

    max_batch_tenants: int = 0        # per launch; 0 = whole roster
    max_wait_s: float = 0.002         # batch-formation window
    pipeline_depth: int = 1           # launches in flight before a sync
    resident_slots: Optional[int] = None   # per-family bank capacity
    ewma_alpha: float = 0.4           # arrival-rate smoothing
    membership_every: int = 16        # driver cycles per membership tick
    promote_margin: float = 1.5       # hot/cold QPS ratio to swap
    promote_min_qps: float = 1.0      # never promote below this rate
    min_dwell_ticks: int = 2          # anti-thrash: ticks between moves
    idle_wait_s: float = 0.02         # thread-mode idle poll
    # ---- durability + fault tolerance ----------------------------------------
    ckpt_interval_s: float = 0.25     # async checkpoint-writer sweep period
    retries: int = 3                  # transient-fault re-attempts / boundary
    retry_backoff_s: float = 0.0      # sleep before re-attempt (doubles)
    degrade_cooldown_s: float = 0.25  # batch-SLA shed window after a fault
    straggler_factor: float = 4.0     # flush-heartbeat threshold (EWMA x)
    # ---- drift / clause-skip auto-pause (None disables the feature) --------
    pause_skip_threshold: Optional[float] = None  # pause at skip EWMA >= this
    pause_min_steps: int = 8          # train steps before pause eligibility
    resume_acc_drop: float = 0.1      # probe-accuracy drop that auto-resumes
    drift_alpha: float = 0.3          # skip/accuracy EWMA smoothing


@dataclasses.dataclass
class _Request:
    tenant: str
    x: object
    encoded: bool
    t_submit: float
    deadline: float
    seq: int
    future: TMFuture
    y: object = None             # training labels (kind == "train")
    kind: str = "infer"          # "infer" | "train"
    tseq: int = 0                # the tenant's submit number (pod mode)


@dataclasses.dataclass
class _TenantState:
    sla: SLAClass
    queue: collections.deque
    arrivals: int = 0            # since the last membership tick
    submits: int = 0             # submit calls, shed ones included
    ewma_qps: float = 0.0
    completed: int = 0
    rejected: int = 0
    dwell: int = 10 ** 9         # ticks since last promote/demote
    last_latency_s: Optional[float] = None
    # ---- online-training stream state ----------------------------------------
    train_steps: int = 0         # applied training steps (durable cursor)
    skip_ewma: Optional[float] = None   # per-step Alg-6 skip fraction EWMA
    acc_ewma: Optional[float] = None    # training-accuracy proxy EWMA
    paused: bool = False         # converged: stream runs eval probes only
    paused_at_acc: float = 0.0   # accuracy EWMA captured at pause time
    probes: int = 0              # eval probes served while paused


class TMScheduler:
    """The device-owning driver: per-tenant SLA queues in front of a
    :class:`repro_torch.launch.serve_tm.TMServer`.

    All device work (encode, launch, fetch) happens on the driver — the
    thread started by :meth:`start`, or the caller of :meth:`step` /
    :meth:`drain` when running inline.  :meth:`submit` only enqueues
    host data (and may run on any thread)."""

    def __init__(self, server: TMServer,
                 config: Optional[SchedulerConfig] = None,
                 default_sla: SLAClass = STANDARD,
                 durable=None, injector=None):
        self.server = server
        self.cfg = config or SchedulerConfig()
        self.default_sla = default_sla
        self._tenants: Dict[str, _TenantState] = {}
        self._registered: Dict[bool, List[str]] = {False: [], True: []}
        self._cap_init: Dict[bool, bool] = {False: False, True: False}
        self._work = threading.Condition()
        self._in_flight: collections.deque = collections.deque()
        self._seq = 0
        self._cycles = 0
        self._t_last_tick = time.perf_counter()
        self.submitted = self.completed = self.rejected = 0
        self.launches = 0
        self.promotions = self.demotions = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # fault tolerance: injector is the deterministic failure schedule
        # (tests), retry the transient-fault budget, monitor the
        # per-flush heartbeat EWMA
        self.injector = injector
        self.retry = RetryPolicy(retries=self.cfg.retries,
                                 backoff_s=self.cfg.retry_backoff_s)
        self.monitor = StepMonitor(factor=self.cfg.straggler_factor)
        self.trains = 0              # applied training steps
        self.train_submitted = 0
        self.faults = 0              # boundary failures past the budget
        self.retries = 0             # transient re-attempts that succeeded
        self.failed = 0              # requests resolved with an exception
        self.degraded_rejections = 0
        self.pauses = self.resumes = 0
        self._recover_until = 0.0    # batch-SLA shed deadline (perf_counter)
        # pod mode (module docstring): rank 0 of the tenants axis leads
        self._pod = server.pod_devices > 1
        self._group = (server.mesh.get_group(server.tenants_axis)
                       if self._pod else None)
        self._follower = self._pod and dist.get_rank(self._group) != 0
        self._more = False           # rank 0 had requests left after a pick
        self._halt = False           # rank 0's loop stopped
        self._writer = None          # durable checkpoint writer
        if durable is not None:
            self.attach_durable(durable)
        # tenants already registered on the server are admitted under
        # the default SLA (re-class them with set_sla)
        for name, tenant in server.tenants.items():
            self._admit(name, tenant.spec.kind == "conv", None)

    # ---- tenant management ------------------------------------------------
    def register(self, name: str, spec, program=None, seed: int = 0,
                 sla: Optional[SLAClass] = None, prng=None,
                 steps: int = 0) -> None:
        """Admit a tenant: register with the server and place it in (or
        out of) the resident bank under the capacity policy.
        ``prng``/``steps`` resume a tenant mid-stream (durable restore)."""
        self.server.register(name, spec, program=program, seed=seed,
                             prng=prng, steps=steps)
        self._admit(name, spec.kind == "conv", sla)

    # ---- durability (async checkpoint writer) ------------------------------
    def attach_durable(self, store) -> None:
        """Attach a :class:`repro_torch.runtime.durable.DurableStore`:
        tenants are marked dirty after every applied training step and a
        background writer saves them every ``cfg.ckpt_interval_s`` (it
        starts with :meth:`start`; inline drivers call
        :meth:`checkpoint_now`)."""
        from repro_torch.runtime.durable import CheckpointWriter
        if self._writer is not None:
            raise RuntimeError("durable store already attached")
        self._writer = CheckpointWriter(
            store, self._snapshot, interval_s=self.cfg.ckpt_interval_s,
            injector=self.injector)
        if self._thread is not None:
            self._writer.start()

    def _snapshot(self, name: str):
        """Consistent durable image of one tenant: device copies of its
        TA states, weights and PRNG taken under the scheduler's and the
        server's locks (:meth:`TMServer.snapshot`).  Tensors are mutable
        here, so copies and not references: a later step, slot write or
        in-place update cannot reach what the writer saves."""
        with self._work:
            return self.server.snapshot(name)

    def checkpoint_now(self, timeout: Optional[float] = 30.0) -> None:
        """Synchronous durability barrier: every training step applied
        before this call is on disk (or counted as a writer failure)
        when it returns.  No-op without an attached store."""
        if self._writer is not None:
            self._writer.flush(timeout)

    def adopt(self, name: str, tm, sla: Optional[SLAClass] = None) -> None:
        """Admit a trained :class:`repro_torch.api.TM` estimator."""
        self.server.adopt(name, tm)
        self._admit(name, tm.spec.kind == "conv", sla)

    def _admit(self, name: str, conv: bool,
               sla: Optional[SLAClass]) -> None:
        with self._work:
            self._tenants[name] = _TenantState(sla or self.default_sla,
                                               collections.deque())
            if name not in self._registered[conv]:
                self._registered[conv].append(name)
        cap = self.cfg.resident_slots
        if cap is None:
            return
        # fill the bank in registration order until the capacity is
        # reached; later arrivals start swapped-out and the EWMA
        # membership loop promotes them from live traffic.  Never
        # clobber a membership the loop already re-decided.
        if not self._cap_init[conv]:
            self.server.set_resident(self._registered[conv][:cap],
                                     conv=conv)
            self._cap_init[conv] = True
        else:
            member = self.server.resident_names(conv)
            if name not in member and len(member) < cap:
                self.server.set_resident(member + [name], conv=conv)

    def sla_of(self, name: str) -> SLAClass:
        return self._tenants[name].sla

    def set_sla(self, name: str, sla: SLAClass) -> None:
        """Re-class an admitted tenant (e.g. after auto-admission)."""
        with self._work:
            self._tenants[name].sla = sla

    # ---- request ingress (any thread) -------------------------------------
    def submit(self, name: str, x, encoded: bool = False) -> TMFuture:
        """Enqueue one inference request; returns a :class:`TMFuture`
        resolving to the prediction array.  Raises
        :class:`Backpressure` when the tenant's queue is at its SLA
        depth cap (admission control), or — for ``priority <= 0``
        (batch-class) tenants — while fault recovery is in progress
        (graceful degradation: gold/standard traffic keeps flowing)."""
        return self._ingress(name, x, None, encoded, "infer")

    def submit_train(self, name: str, x, y,
                     encoded: bool = False) -> TMFuture:
        """Enqueue one online training step for tenant ``name`` — the
        train-while-serve stream.  The driver multiplexes it onto the
        same program-major cycle as inference (per-tenant FIFO order is
        preserved, so the result is bit-identical to sequential
        ``partial_fit``).  ``x`` must FILL the batch slot (padding a
        training batch would replicate feedback — accumulate first);
        the future resolves to the host-side training stats dict.
        Admission control matches :meth:`submit`."""
        return self._ingress(name, x, y, encoded, "train")

    def _ingress(self, name: str, x, y, encoded: bool,
                 kind: str) -> TMFuture:
        st = self._tenants[name]
        now = time.perf_counter()
        fut = TMFuture()
        with self._work:
            st.submits += 1
            # admission is rank 0's in pod mode
            if (not self._follower and st.sla.priority <= 0
                    and now < self._recover_until):
                st.rejected += 1
                self.rejected += 1
                self.degraded_rejections += 1
                raise Backpressure(
                    f"tenant {name!r} ({st.sla.name}) shed while fault "
                    "recovery is in progress — retry after the cooldown")
            if (not self._follower
                    and len(st.queue) >= st.sla.max_queue_depth):
                st.rejected += 1
                self.rejected += 1
                raise Backpressure(
                    f"tenant {name!r} queue at its SLA depth cap "
                    f"({st.sla.max_queue_depth})")
            self._seq += 1
            st.queue.append(_Request(
                tenant=name, x=x, encoded=encoded, t_submit=now,
                deadline=now + st.sla.deadline_ms / 1e3, seq=self._seq,
                future=fut, y=y, kind=kind, tseq=st.submits))
            st.arrivals += 1
            self.submitted += 1
            if kind == "train":
                self.train_submitted += 1
            if self._thread is not None:      # wake the idle driver
                self._work.notify()
        return fut

    # ---- the driver (one thread owns the device) ---------------------------
    def _queued(self) -> int:
        return sum(len(st.queue) for st in self._tenants.values())

    def _launch(self, force: bool) -> bool:
        """Form one program-major batch (≤ 1 request per tenant, EDF
        order, ``max_batch_tenants`` cap): apply its training requests
        inline (per-tenant FIFO order — bit-identical to the sequential
        path), then dispatch its inference requests un-synced."""
        batch = None if self._follower else self._pick(force)
        if self._pod:
            batch = self._agree(batch)
        if not batch:
            return False
        # device work OUTSIDE the lock: host encode of this batch
        # overlaps whatever launch is still in flight on the device.
        # Training first: a trained tenant's bank slot is dirty and the
        # flush below rescatters the fresh program (train-while-serve);
        # a tenant has at most ONE request in the cycle, so train/infer
        # ordering across tenants cannot reorder any tenant's stream.
        infers = []
        for req in batch:
            if req.kind == "train":
                self._run_train(req)
            else:
                infers.append(req)
        launched = []
        for req in infers:
            try:
                with_retry(lambda r=req: self._encode_one(r), self.retry,
                           on_retry=self._on_retry)
            except (InjectedFault, RuntimeError) as e:
                self._resolve_failed([req], e)
            else:
                launched.append(req)
        if launched:
            try:
                pf = with_retry(self._flush_once, self.retry,
                                on_retry=self._on_retry)
            except (InjectedFault, RuntimeError) as e:
                # abandon the encoded-but-unlaunched requests so they do
                # not ride (and pollute) the next cycle's flush
                self.server.abandon_pending()
                self._resolve_failed(launched, e)
            else:
                self._in_flight.append((pf, launched))
                self.launches += 1
        return True

    def _pick(self, force: bool) -> Optional[List[_Request]]:
        """This rank's next batch, popped from its queues (``None``: no
        launch this cycle)."""
        now = time.perf_counter()
        with self._work:
            heads = [(st.queue[0], st.sla.priority)
                     for st in self._tenants.values() if st.queue]
            if not heads:
                return None
            cap = self.cfg.max_batch_tenants or len(heads)
            if not force and len(heads) < cap:
                oldest = min(r.t_submit for r, _ in heads)
                if now - oldest < self.cfg.max_wait_s:
                    return None           # keep filling the batch window
            heads.sort(key=lambda h: (h[0].deadline, -h[1], h[0].seq))
            batch = [r for r, _ in heads[:cap]]
            for req in batch:
                self._tenants[req.tenant].queue.popleft()
        return batch

    # ---- pod mode: rank 0's decisions, broadcast ----------------------------
    def _bcast(self, msg: List[int]) -> List[int]:
        """Rank 0's ``msg`` (ints, the same length on every rank) on
        every rank of the tenants axis."""
        t = torch.tensor(msg, dtype=torch.int64,
                         device=self.server.engine.device)
        return broadcast(t, 0, self._group).tolist()  # dtmlint: disable=DTM003 (rank 0's decision, read by every rank)

    def _agree(self, batch: Optional[List[_Request]]
               ) -> Optional[List[_Request]]:
        """Rank 0's batch on every rank: it sends [tenants, halt, more,
        len, then (tenant index, submit number) for each request];
        the others take those requests from their own queues."""
        names = sorted(self._tenants)
        msg = [len(names), 0, 0, 0] + [-1] * (2 * len(names))
        if not self._follower:
            with self._work:
                more = bool(self._queued())
            msg[1:4] = [int(self._stop.is_set()), int(more),
                        len(batch or ())]
            for j, req in enumerate(batch or ()):
                msg[4 + 2 * j:6 + 2 * j] = [names.index(req.tenant),
                                            req.tseq]
        msg = self._bcast(msg)
        if msg[0] != len(names):
            raise RuntimeError(f"rank 0 serves {msg[0]} tenants and this "
                               f"rank {len(names)}: register the same "
                               "roster on every rank")
        self._halt, self._more = bool(msg[1]), bool(msg[2])
        if not self._follower:
            return batch
        return [self._take(names[msg[4 + 2 * j]], msg[5 + 2 * j])
                for j in range(msg[3])] or None

    def _take(self, name: str, tseq: int) -> _Request:
        """A follower's request ``tseq`` of tenant ``name``, which rank 0
        batched: popped once it has arrived; the heads before it, which
        rank 0 shed, fail with :class:`Backpressure`."""
        st = self._tenants[name]
        deadline = time.monotonic() + POD_SYNC_S
        shed = []
        try:
            with self._work:
                while not (st.queue and st.queue[-1].tseq >= tseq):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise RuntimeError(
                            f"no request {tseq} of tenant {name!r} reached "
                            f"this rank in {POD_SYNC_S} s; rank 0 "
                            "batched it: submit the same requests on every "
                            "rank")
                    self._work.wait(min(left, 0.01))
                while st.queue[0].tseq < tseq:
                    shed.append(st.queue.popleft())
                    st.rejected += 1
                    self.rejected += 1
                req = st.queue.popleft()
                if req.tseq != tseq:
                    raise RuntimeError(f"request {tseq} of tenant {name!r} "
                                       "is missing on this rank")
                return req
        finally:
            for r in shed:
                r.future.set_exception(Backpressure(
                    f"tenant {name!r}: rank 0 shed this request"))

    def _encode_one(self, req: _Request) -> None:
        if self.injector is not None:
            self.injector.check("encode")
        self.server.enqueue(req.tenant, req.x, encoded=req.encoded)

    def _flush_once(self):
        if self.injector is not None:
            self.injector.check("launch")
        return self.server.flush_async()

    def _on_retry(self, attempt: int, exc: BaseException) -> None:
        """A transient boundary fault was absorbed by the retry budget:
        count it and open the degradation window (recovery in progress —
        batch-class submits shed until it closes)."""
        with self._work:
            self.retries += 1
            self._recover_until = max(
                self._recover_until,
                time.perf_counter() + self.cfg.degrade_cooldown_s)

    def _resolve_failed(self, batch: List[_Request],
                        exc: BaseException) -> None:
        """Retry budget exhausted (or a hard fault): fail the affected
        futures and enter the recovery window."""
        with self._work:
            self.faults += 1
            self.failed += len(batch)
            self._recover_until = max(
                self._recover_until,
                time.perf_counter() + self.cfg.degrade_cooldown_s)
        for req in batch:
            req.future.set_exception(exc)

    def _resolve_oldest(self) -> int:
        pf, batch = self._in_flight.popleft()
        t0 = time.perf_counter()
        try:
            # collect is a pure fetch + decode — re-invoking it after a
            # fault at boundary entry is safe
            out = with_retry(lambda: self._collect_once(pf), self.retry,
                             on_retry=self._on_retry)
        except (InjectedFault, RuntimeError) as e:
            self._resolve_failed(batch, e)
            return len(batch)
        now = time.perf_counter()
        # per-flush heartbeat: the collect wall-time feeds the straggler
        # EWMA (stats() surfaces monitor.stragglers)
        self.monitor.record(now - t0)
        for req in batch:
            st = self._tenants[req.tenant]
            st.completed += 1
            self.completed += 1
            st.last_latency_s = now - req.t_submit
            req.future.set_result(out[req.tenant])
        return len(batch)

    def _collect_once(self, pf):
        if self.injector is not None:
            self.injector.check("collect")
        return self.server.collect(pf)

    # ---- the online-training stream (train-while-serve) --------------------
    def _run_train(self, req: _Request) -> None:
        """Execute one training request: apply the step (bounded retry on
        transient launch faults), or — when the tenant's stream is
        auto-paused — serve an eval probe that watches for drift."""
        st = self._tenants[req.tenant]
        try:
            if st.paused:
                result = self._probe(req, st)
            else:
                result = self._apply_train(req)
        except (InjectedFault, RuntimeError) as e:
            self._resolve_failed([req], e)
            return
        now = time.perf_counter()
        with self._work:
            st.completed += 1
            self.completed += 1
            st.last_latency_s = now - req.t_submit
        req.future.set_result(result)

    def _apply_train(self, req: _Request) -> dict:
        stats = with_retry(lambda: self._train_once(req), self.retry,
                           on_retry=self._on_retry)
        st = self._tenants[req.tenant]
        a = self.cfg.drift_alpha
        skip = 1.0 - stats["active_groups"] / max(stats["total_groups"], 1)
        acc = self._train_acc(req.tenant, stats)
        with self._work:
            st.train_steps += 1
            self.trains += 1
            st.skip_ewma = (skip if st.skip_ewma is None
                            else a * skip + (1 - a) * st.skip_ewma)
            st.acc_ewma = (acc if st.acc_ewma is None
                           else a * acc + (1 - a) * st.acc_ewma)
            thr = self.cfg.pause_skip_threshold
            if (thr is not None and not st.paused
                    and st.train_steps >= self.cfg.pause_min_steps
                    and st.skip_ewma >= thr):
                # converged: the clause-skip telemetry says almost no
                # group receives feedback — stop spending train launches
                st.paused = True
                st.paused_at_acc = st.acc_ewma
                self.pauses += 1
        if self._writer is not None:
            self._writer.mark_dirty(req.tenant)
        return dict(stats, applied=True, paused=False)

    def _train_once(self, req: _Request) -> dict:
        if self.injector is not None:
            self.injector.check("launch")
        return self.server.train(req.tenant, req.x, req.y,
                                 encoded=req.encoded)

    def _train_acc(self, name: str, stats: dict) -> float:
        """Training-accuracy proxy from the step's host stats: fraction
        correct for classification, 1 − mean |error| (vote-normalised)
        for regression."""
        bs = self.server.batch_slot
        is_reg, t = self.server._decode_info[name]
        if is_reg:
            return 1.0 - min(stats["abs_err"] / max(bs * t, 1), 1.0)
        return stats["correct"] / bs

    def _probe(self, req: _Request, st: _TenantState) -> dict:
        """Paused stream: run the batch as an EVAL probe (no state
        mutation), track the accuracy EWMA, and auto-resume — applying
        this very step — when accuracy regressed past the pause-time
        baseline (label drift)."""
        preds = np.asarray(
            self.server.predict(req.tenant, req.x, encoded=req.encoded))
        y = np.asarray(req.y)[:preds.shape[0]]
        is_reg, _ = self.server._decode_info[req.tenant]
        if is_reg:
            acc = 1.0 - min(float(np.abs(preds - y).mean()), 1.0)
        else:
            acc = float((preds == y).mean())
        a = self.cfg.drift_alpha
        resume = False
        with self._work:
            st.probes += 1
            st.acc_ewma = (acc if st.acc_ewma is None
                           else a * acc + (1 - a) * st.acc_ewma)
            if st.acc_ewma < st.paused_at_acc - self.cfg.resume_acc_drop:
                st.paused = False
                st.skip_ewma = None     # converged-state evidence is stale
                self.resumes += 1
                resume = True
        if resume:                      # drift detected: learn again, now
            return dict(self._apply_train(req), resumed=True)
        return {"applied": False, "paused": True, "probe_acc": acc}

    def step(self, force: bool = True) -> int:
        """One driver cycle: launch at most one stacked flush, then
        resolve any launch past the pipeline window (all of them when
        idle).  Returns the number of requests completed.  ``force=False``
        honours the ``max_wait_s`` batch-formation window (the thread
        loop's mode); ``force=True`` launches whatever is queued."""
        launched = self._launch(force)
        done = 0
        while self._in_flight and (
                len(self._in_flight) > self.cfg.pipeline_depth
                or (not launched and not (self._more if self._pod
                                          else self._queued()))):
            done += self._resolve_oldest()
        self._cycles += 1
        if (self.cfg.resident_slots is not None
                and self._cycles % self.cfg.membership_every == 0):
            self._membership_tick()
        return done

    def drain(self) -> int:
        """Run the driver inline until every queued and in-flight
        request has completed; returns the number completed."""
        done = 0
        if self._pod:         # until rank 0's queues are empty
            while True:
                done += self.step(force=True)
                if not (self._in_flight or self._more):
                    return done
        while self._queued() or self._in_flight:
            done += self.step(force=True)
        return done

    # ---- dynamic bank membership (EWMA promote / demote) -------------------
    def _membership_tick(self) -> None:
        now = time.perf_counter()
        dt = max(now - self._t_last_tick, 1e-9)
        self._t_last_tick = now
        a = self.cfg.ewma_alpha
        with self._work:
            for st in self._tenants.values():
                st.ewma_qps = a * (st.arrivals / dt) + (1 - a) * st.ewma_qps
                st.arrivals = 0
                st.dwell += 1
        moves = [] if self._follower else self._moves()
        if self._pod:         # rank 0's moves: [tenants, (hot, cold) x 2]
            names = sorted(self._tenants)
            msg = [len(names)] + [-1] * 4
            for j, (hot, cold) in enumerate(moves):
                msg[1 + 2 * j:3 + 2 * j] = [
                    names.index(hot), -1 if cold is None
                    else names.index(cold)]
            msg = self._bcast(msg)
            if msg[0] != len(names):
                raise RuntimeError(f"rank 0 serves {msg[0]} tenants and "
                                   f"this rank {len(names)}")
            moves = [(names[msg[1 + 2 * j]], None if msg[2 + 2 * j] < 0
                      else names[msg[2 + 2 * j]])
                     for j in range(2) if msg[1 + 2 * j] >= 0]
        for hot, cold in moves:
            if cold is None:
                self.server.add_resident(hot)
            else:
                self.server.swap_resident(cold, hot)
                self._tenants[cold].dwell = 0
                self.demotions += 1
            self._tenants[hot].dwell = 0
            self.promotions += 1

    def _moves(self) -> list:
        """This tick's membership moves, at most one a family: (hot,
        None) promotes ``hot`` into a free slot, (hot, cold) swaps it in
        for ``cold``."""
        moves = []
        for conv in (False, True):
            resident = [n for n in self.server.resident_names(conv)
                        if n in self._tenants]
            swapped = [n for n in self._registered[conv]
                       if n not in resident]
            if not swapped:
                continue
            hot = max(swapped, key=lambda n: self._tenants[n].ewma_qps)
            hs = self._tenants[hot]
            if (hs.ewma_qps < self.cfg.promote_min_qps
                    or hs.dwell < self.cfg.min_dwell_ticks):
                continue
            if self.cfg.resident_slots and (
                    len(resident) < self.cfg.resident_slots):
                moves.append((hot, None))
                continue
            if not resident:
                continue
            cold = min(resident, key=lambda n: self._tenants[n].ewma_qps)
            cs = self._tenants[cold]
            if (cs.dwell >= self.cfg.min_dwell_ticks
                    and hs.ewma_qps
                    > self.cfg.promote_margin * max(cs.ewma_qps, 1e-9)):
                moves.append((hot, cold))
        return moves

    # ---- background thread mode -------------------------------------------
    def start(self) -> None:
        """Start the background flush loop (the device-owning driver)
        and, when a durable store is attached, the async checkpoint
        writer."""
        if self._thread is not None:
            raise RuntimeError("scheduler already running")
        self._stop.clear()
        self._halt = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="tm-scheduler")
        self._thread.start()
        if self._writer is not None and not self._writer.running:
            self._writer.start()

    def _loop(self) -> None:
        poll = max(self.cfg.max_wait_s / 2, 1e-4)
        # pod mode: every rank steps in lockstep with rank 0, which
        # steps at least once an idle wait (a cycle with no batch) and
        # stops them all
        while not (self._halt if self._pod else self._stop.is_set()):
            with self._work:
                if (not self._follower and not self._queued()
                        and not self._in_flight):
                    self._work.wait(self.cfg.idle_wait_s)
                    if not self._pod:
                        continue
            before = self.launches
            done = self.step(force=False)
            if done == 0 and self.launches == before:
                # batch window still filling — don't spin
                time.sleep(poll)
        self.drain()

    def stop(self) -> None:
        """Stop the background loop; drains in-flight work first so no
        caller is left holding an unresolved Future, then stops the
        checkpoint writer (its final sweep makes every applied training
        step durable)."""
        if self._thread is not None:
            self._stop.set()
            with self._work:
                self._work.notify_all()
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError("scheduler thread hung")
            self._thread = None
        if self._writer is not None and self._writer.running:
            self._writer.stop()

    # ---- observability -----------------------------------------------------
    def stats(self) -> dict:
        """Operator snapshot: scheduler totals + per-tenant queue/SLA/
        rate state, with the server's own stats nested under
        ``server``.

        The whole snapshot is taken under ``self._work``: the driver
        thread mutates the counters and ``_in_flight`` between launches,
        so a field read outside the condition could tear against a
        concurrent flush.  ``server.stats()`` takes the server's own lock
        inside it (always in that order)."""
        with self._work:
            resident = set(self.server.resident_names())
            per_tenant = {
                n: {"queue_depth": len(st.queue),
                    "sla": st.sla.name,
                    "ewma_qps": round(st.ewma_qps, 3),
                    "resident": n in resident,
                    "completed": st.completed,
                    "rejected": st.rejected,
                    "last_latency_ms":
                        (None if st.last_latency_s is None
                         else round(st.last_latency_s * 1e3, 3)),
                    "train_steps": st.train_steps,
                    "paused": st.paused,
                    "probes": st.probes,
                    "skip_ewma": (None if st.skip_ewma is None
                                  else round(st.skip_ewma, 4)),
                    "acc_ewma": (None if st.acc_ewma is None
                                 else round(st.acc_ewma, 4))}
                for n, st in sorted(self._tenants.items())}
            return {"tenants": per_tenant,
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "rejected": self.rejected,
                    "launches": self.launches,
                    "in_flight": len(self._in_flight),
                    "promotions": self.promotions,
                    "demotions": self.demotions,
                    "running": self._thread is not None,
                    "trains": self.trains,
                    "train_submitted": self.train_submitted,
                    "faults": self.faults,
                    "retries": self.retries,
                    "failed": self.failed,
                    "degraded_rejections": self.degraded_rejections,
                    "recovering":
                        time.perf_counter() < self._recover_until,
                    "pauses": self.pauses,
                    "resumes": self.resumes,
                    "monitor": self.monitor.stats(),
                    "injector": (None if self.injector is None
                                 else self.injector.stats()),
                    "checkpoint": (None if self._writer is None
                                   else self._writer.stats()),
                    "server": self.server.stats()}
