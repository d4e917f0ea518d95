"""Multi-tenant DTM serving: one engine, N tenant programs, on one device
or over a ``tenants`` mesh axis.

The accelerator is built once and switching the hosted model is a memory
rewrite: the engine is the datapath, a :class:`DTMProgram` is the model.
Two request paths:

* :meth:`TMServer.predict` swaps to one tenant and serves its request
  (the edge path when the batch slot is <= 4 rows): on the card one
  replay of the engine's inference graph at the slot's shape
  (:meth:`DTMEngine.served_infer`), shared by every tenant.
* :meth:`TMServer.enqueue` queues requests; :meth:`TMServer.flush_async`
  runs the resident tenants of each stage family (flat, conv) with
  pending requests through ONE stacked :class:`ProgramBank` launch per
  kernel, and each pending tenant outside the resident roster through a
  single-program launch (the cold path, the same inference graph), and
  returns without waiting;
  :meth:`TMServer.collect` fetches and decodes (the only host-device sync
  of the path: flat banks decode on the device, conv banks and cold
  requests on the host).  :meth:`TMServer.flush` is the two in one.

Requests are padded to a fixed ``batch_slot`` by repeating their last row,
and the padding is dropped from the answers.

:meth:`TMServer.train` swaps to one tenant and applies one on-line
training step to its program (on-chip training on the same datapath;
on the card one replay of the engine's step graph at the slot's shape,
the graph ``TM.partial_fit`` replays); the tenant's bank slot is then
stale, and the next stacked flush writes the fresh program back into
it.  Each tenant keeps its own PRNG (made from ``seed + 1`` at
registration), step count, and a lifetime clause-skip fraction
(``skip_frac`` in :meth:`TMServer.stats`).

Bank membership is dynamic: :meth:`TMServer.set_resident` restricts a
family's bank roster, :meth:`TMServer.swap_resident` demotes one tenant
and promotes another into its slot (two in-place slot writes, no
restack), and :meth:`TMServer.add_resident` grows the roster (a restack
at the next flush).  A roster change that keeps the family's K and
shapes (``set_resident``, ``register``) keeps its bank and flush graph:
the next flush writes the new members into their slots in place; only a
new K stacks a new bank, which captures anew.  The scheduler
(:mod:`repro_torch.launch.scheduler`) drives these.  Every device
operation of the server runs on the device's current stream, the one
stream the scheduler and its checkpoint writer share: bank slot writes,
pipelined flushes and the writer's copies are ordered by it.
:meth:`TMServer.snapshot` copies a tenant's durable state under the
server's lock, so a later in-place write cannot reach the copy.

Pod mode (``mesh=`` with more than one device on ``tenants_axis``): the
banks are :class:`repro_torch.launch.pod.PodBank` s, the roster padded
to a multiple of the device count (pad slots replay the first tenant's
program and their answers are dropped), rank d serving its block of
slots and every rank getting every answer.  Every rank runs the same
server calls (SPMD); tenant records are replicated, bank slots live on
their owning rank.  :meth:`TMServer.routing_table` maps each tenant to
its (device, slot); ``swap_in`` writes on the owner, ``swap_out`` and
``unstack`` broadcast from it, and :meth:`TMServer.add_resident` fills a
pad slot in place before it restacks.

Locks: the server's ``_lock`` and a graph's ``lock`` are never held
together.  A train step or an inference runs under its graph's lock
alone, and the step's commit (program, PRNG, steps) runs under the
server's lock after the graph's lock is released; ``snapshot`` takes
only the server's lock.  So the scheduler's thread, the checkpoint
writer and a caller's thread cannot deadlock on them.

:func:`reconfig_benchmark` (``python -m repro_torch.launch.serve_tm
--smoke --out PATH``) times the reconfiguration claim: the five
``demo_specs`` kinds served and trained round-robin off one engine
(steady, swap-every-request and train-swap latency) against building a
fresh engine for one model (the resynthesis baseline), and asserts that
no stage holds more than one CUDA graph across the swaps.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import api
from repro_torch.api import TM, ProgramBank, TMSpec
from repro_torch.core.dtm import DTMEngine, DTMProgram
from repro_torch.core import threefry
from repro_torch.core.prng import PRNG
from repro_torch.launch import pod as _pod
from repro_torch.launch.pod import Route


@dataclasses.dataclass
class _Tenant:
    spec: TMSpec
    program: DTMProgram
    prng: PRNG
    steps: int = 0                # lifetime applied training steps


@dataclasses.dataclass
class PendingFlush:
    """One launched flush whose results are not fetched yet."""

    t0: float                       # flush_async entry time
    served: Dict[str, float]        # tenant -> enqueue time
    n_real: Dict[str, int]          # tenant -> un-padded batch
    # per launched family: (conv, bank slot order, then on the device
    # preds and votes [K, B] int32 (flat), or sums [K, B, H] and clauses
    # [K, B, R] (conv)): the bank's copies of its graph's outputs, which
    # the next flush's replay does not overwrite while this one is in
    # flight
    hot: List[Tuple[bool, List[str], torch.Tensor, torch.Tensor]]
    # per non-resident tenant: (name, sums [B, H], clauses [B, R])
    cold: List[Tuple[str, torch.Tensor, torch.Tensor]]


class TMServer:
    """One engine, N resident programs, swap-per-request and stacked
    serving.  ``batch_slot`` is the fixed request batch; requests are
    padded up to it.  ``mesh`` (a ``DeviceMesh``) with more than one
    device on ``tenants_axis`` serves the banks tenant-parallel (pod
    mode, module docstring)."""

    def __init__(self, engine: DTMEngine, batch_slot: int = 32, mesh=None,
                 tenants_axis: str = "tenants"):
        self.engine = engine
        self.batch_slot = batch_slot
        if mesh is not None:
            names = getattr(mesh, "mesh_dim_names", None)
            if names is None:
                raise TypeError(f"mesh must be a DeviceMesh (repro_torch."
                                f"launch.mesh), got {type(mesh).__name__}")
            if tenants_axis not in names:
                raise ValueError(f"mesh axes {tuple(names)} have no "
                                 f"{tenants_axis!r} axis")
        self.mesh = mesh
        self.tenants_axis = tenants_axis
        self.pod_devices = (_pod.mesh_axis_size(mesh, tenants_axis)
                            if mesh is not None else 1)
        self.tenants: Dict[str, _Tenant] = {}
        self.active: Optional[str] = None
        self.swaps = 0
        self.requests = 0
        self.stacked_launches = 0
        self.coalesced_requests = 0
        self.cold_requests = 0
        self.membership_swaps = 0
        self._pending: List[Tuple[str, torch.Tensor, int, float]] = []
        self._banks: Dict[bool, Tuple[List[str], ProgramBank]] = {}
        # per family: the bank of a roster that changed, kept until the
        # next flush, which reuses it at an unchanged K
        self._spare: Dict[bool, Tuple[List[str], ProgramBank]] = {}
        # per family: the resident roster in slot order (None: every
        # registered tenant)
        self._membership: Dict[bool, Optional[List[str]]] = {}
        self._decode_info: Dict[str, Tuple[bool, int]] = {}
        self._last_flush: Dict[str, float] = {}
        self._dirty: set = set()    # trained tenants whose bank slot is stale
        self._skip_acc: Dict[str, List[int]] = {}   # [active, total] groups
        # guards a tenant's (program, PRNG, steps) commit against
        # snapshot(), and the containers stats() reads
        self._lock = threading.RLock()

    # ---- tenant management ------------------------------------------------
    def register(self, name: str, spec: TMSpec,
                 program: Optional[DTMProgram] = None, seed: int = 0,
                 prng: Optional[PRNG] = None, steps: int = 0):
        """Admit a model: lower its spec (drawing the program from the
        threefry key ``PRNGKey(seed)``, the JAX server's program) or adopt an already-lowered ``program``.  ``prng`` and
        ``steps`` resume a tenant mid-stream; by default its PRNG is made
        from ``seed + 1`` and its step count starts at 0."""
        dev = self.engine.device
        if program is None:
            program = self.engine.lower(spec, threefry.key(seed, dev))
        prng = (PRNG.create(spec.tm_config(), seed + 1, device=dev)
                if prng is None else prng.to(dev))
        self._put(name, _Tenant(spec, program.to(dev), prng, steps))

    def adopt(self, name: str, tm: TM):
        """Admit a trained :class:`repro_torch.api.TM` (same tile geometry
        as this server's engine)."""
        if tm.engine.tile != self.engine.tile:
            raise ValueError("tile geometry mismatch: the estimator's "
                             f"{tm.engine.tile} vs {self.engine.tile}")
        dev = self.engine.device
        self._put(name, _Tenant(tm.spec, tm.program.to(dev),
                                tm.prng.to(dev)))

    def _put(self, name: str, tenant: _Tenant) -> None:
        with self._lock:
            if name in self.tenants:        # its old family loses it
                self._retire(self._is_conv(name))
                # a new model under an old name: a kept bank's slot of it
                # is stale
                self._dirty.add(name)
            self.tenants[name] = tenant
            # the family's roster changed: rebuilt at its next flush
            self._retire(tenant.spec.kind == "conv")
            self._decode_info[name] = (tenant.spec.kind == "regression",
                                       int(tenant.spec.tm_config().T))
            # a (re-)registered tenant is a new model: skip accounting anew
            self._skip_acc.pop(name, None)

    def _retire(self, conv: bool) -> None:
        """The family's roster changed: its bank is rebuilt at the next
        flush, from this one when K and the shapes stay."""
        bank = self._banks.pop(conv, None)
        if bank is not None:
            self._spare[conv] = bank

    def _swap_to(self, name: str) -> _Tenant:
        tenant = self.tenants[name]
        if self.active != name:
            self.swaps += 1
            self.active = name
        return tenant

    def _encode_request(self, tenant: _Tenant, x, encoded: bool
                        ) -> Tuple[torch.Tensor, int]:
        """Pad a request to the batch slot and encode it (unless it came
        as packed engine literals: [n, W], or [n, P, W] for conv)."""
        n = len(x)
        if not 0 < n <= self.batch_slot:
            raise ValueError(f"request of {n} rows; batch_slot is "
                             f"{self.batch_slot}")
        if encoded:
            lits = torch.as_tensor(x, device=self.engine.device)
        else:
            lits = self.engine.encode(tenant.spec, np.asarray(x))
        if n < self.batch_slot:
            lits = torch.cat([lits, lits[-1:].expand(
                self.batch_slot - n, *lits.shape[1:])])
        return lits, n

    def _decode(self, name: str, preds: np.ndarray, votes: np.ndarray
                ) -> np.ndarray:
        is_reg, t = self._decode_info[name]
        if is_reg:
            return votes.astype(np.float32) / t
        return preds

    # ---- request paths ----------------------------------------------------
    def predict(self, name: str, x, encoded: bool = False) -> np.ndarray:
        """Swap to tenant ``name`` and serve one request (one replay of
        the engine's inference graph on the card)."""
        tenant = self._swap_to(name)
        self.requests += 1
        lits, n = self._encode_request(tenant, x, encoded)
        sums, cl = self.engine.served_infer(tenant.spec, tenant.program,
                                            lits)
        return self._decode_one(name, sums, cl)[:n]

    def _decode_one(self, name: str, sums: torch.Tensor, cl: torch.Tensor
                    ) -> np.ndarray:
        """One tenant's [B] answers from its engine outputs (fetched)."""
        is_reg, t = self._decode_info[name]
        # the fetch of the answers a request returns
        if is_reg:
            votes = cl.sum(dim=-1).clamp(0, t)
            return self._decode(name, None,
                                votes.cpu().numpy())  # dtmlint: disable=DTM003 (the answer)
        return torch.argmax(sums, dim=-1).cpu().numpy()  # dtmlint: disable=DTM003 (the answer)

    def train(self, name: str, x, y, encoded: bool = False) -> dict:
        """Swap to tenant ``name`` and apply one training step to its
        program: one replay of the engine's step graph at the slot's
        shape (:meth:`DTMEngine._session_step`, under the graph's lock
        only), then the commit under the server's lock.  A training
        request fills the batch slot (padding would repeat the last
        example's feedback).  ``encoded=True`` takes packed engine
        literals and encoded labels.  Returns the step's stats as host
        ints (one fetch)."""
        tenant = self._swap_to(name)
        self.requests += 1
        if len(x) != self.batch_slot:
            raise ValueError(f"training request has {len(x)} examples; "
                             f"batch_slot is {self.batch_slot}")
        if encoded:
            lits = torch.as_tensor(x, device=self.engine.device)
            lab = torch.as_tensor(y, device=self.engine.device)
        else:
            lits = self.engine.encode(tenant.spec, np.asarray(x))
            lab = tenant.spec.encode_labels(np.asarray(y)).to(
                self.engine.device)
        program, prng, stats = self.engine._session_step(
            tenant.spec.kind == "conv", tenant.program, tenant.prng, lits,
            lab.to(torch.int32))
        row = torch.stack(list(stats.values()))
        host = dict(zip(stats, row.tolist()))  # dtmlint: disable=DTM003 (the one fetch)
        with self._lock:
            tenant.program, tenant.prng = program, prng
            tenant.steps += 1
            self._dirty.add(name)    # its bank slot is stale until a flush
            acc = self._skip_acc.setdefault(name, [0, 0])
            acc[0] += host["active_groups"]
            acc[1] += host["total_groups"]
        return host

    def snapshot(self, name: str) -> Tuple[int, dict]:
        """``(steps, {"ta", "weights", "prng"})`` of one tenant, copied on
        the device under the server's lock: a consistent image that no
        later training step, bank slot write or in-place update reaches
        (the durable writer's input)."""
        with self._lock:
            t = self.tenants[name]
            return t.steps, {"ta": t.program.ta.clone(),
                             "weights": t.program.weights.clone(),
                             "prng": t.prng.map(torch.clone)}

    def skip_frac(self, name: str) -> Optional[float]:
        """Lifetime clause-skip fraction of a tenant's on-line training
        (``None`` before it trained)."""
        acc = self._skip_acc.get(name)
        if acc is None or acc[1] == 0:
            return None
        return 1.0 - acc[0] / acc[1]

    def _is_conv(self, name: str) -> bool:
        return self.tenants[name].spec.kind == "conv"

    # ---- bank membership ----------------------------------------------------
    def _group_names(self, conv: bool) -> List[str]:
        member = self._membership.get(conv)
        if member is not None:
            return [n for n in member if n in self.tenants]
        return sorted(n for n in self.tenants if self._is_conv(n) == conv)

    def resident_names(self, conv: Optional[bool] = None) -> List[str]:
        """The tenants the stacked bank launch serves (one family, or
        both): the membership if one was set, else every tenant."""
        fams = (False, True) if conv is None else (conv,)
        return [n for c in fams for n in self._group_names(c)]

    def set_resident(self, names: Sequence[str], conv: bool = False) -> None:
        """Restrict one family's bank roster to ``names`` (slot order).
        The others stay registered; their requests take the cold path
        until :meth:`swap_resident` or :meth:`add_resident` promotes
        them."""
        names = list(names)
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate resident names {names}")
        for n in names:
            if self._is_conv(n) != conv:
                raise ValueError(f"{n!r} is not of the "
                                 f"{'conv' if conv else 'flat'} family")
        with self._lock:
            self._membership[conv] = names
            self._retire(conv)

    def _member(self, conv: bool) -> List[str]:
        member = self._membership.get(conv)
        if member is None:
            raise ValueError("set_resident() first")
        return member

    def swap_resident(self, out_name: str, in_name: str) -> Optional[Route]:
        """Demote ``out_name`` (its program is read back from its slot)
        and promote ``in_name`` into that slot: two in-place slot
        operations, no restack.  Returns the slot's :class:`Route`, or
        ``None`` when the bank was not built yet (only the roster
        changed)."""
        conv = self._is_conv(in_name)
        if self._is_conv(out_name) != conv:
            raise ValueError("swap_resident stays within one family")
        member = self._member(conv)
        if out_name not in member or in_name in member:
            raise ValueError(f"cannot swap {out_name!r} out for {in_name!r}"
                             f" in the roster {member}")
        self.membership_swaps += 1
        if conv not in self._banks:
            with self._lock:
                member[member.index(out_name)] = in_name
            return None
        names, bank = self._bank_for(conv)      # rewrites stale slots
        idx = names.index(out_name)
        self.tenants[out_name].program = bank.swap_out(idx)
        bank.swap_in(idx, self.tenants[in_name].program)
        with self._lock:
            names[idx] = in_name
            member[member.index(out_name)] = in_name
            self._dirty.discard(in_name)
        return _pod.routing_table(names, self.pod_devices, conv)[in_name]

    def add_resident(self, in_name: str) -> Optional[Route]:
        """Promote ``in_name`` without demoting anyone: in pod mode into
        the first pad slot of a built bank, in place (one routed
        ``swap_in``; returns its :class:`Route`), else the roster grows
        and the bank restacks at the next flush (returns ``None``)."""
        conv = self._is_conv(in_name)
        member = self._member(conv)
        if in_name in member:
            raise ValueError(f"{in_name!r} is resident already")
        self.membership_swaps += 1
        if self.pod_devices > 1 and conv in self._banks:
            names, bank = self._bank_for(conv)
            pad = _pod.first_pad_slot(names)
            if pad is not None:
                bank.swap_in(pad, self.tenants[in_name].program)
                with self._lock:
                    names[pad] = in_name
                    member.append(in_name)
                    self._dirty.discard(in_name)
                return _pod.routing_table(names, self.pod_devices,
                                          conv)[in_name]
        with self._lock:
            member.append(in_name)
            self._retire(conv)
        return None

    def _bank_for(self, conv: bool) -> Tuple[List[str], ProgramBank]:
        """The resident bank of a family (flat or conv), built once per
        roster; slots of tenants trained since are rewritten first.  A
        new roster of the last one's K and shapes takes over its bank
        (and so its flush graph): the slots whose tenant changed are
        rewritten in place.  Another K stacks a new bank, and the old
        one goes with its graphs.  Pod mode stacks a
        :class:`repro_torch.launch.pod.PodBank` of the padded roster
        anew."""
        if conv not in self._banks and self.pod_devices > 1:
            names = self._group_names(conv)
            self._spare.pop(conv, None)
            padded = _pod.pad_roster(names, self.pod_devices)
            bank = _pod.pod_stack(
                [self.tenants[n if n is not None else names[0]].program
                 for n in padded], self.engine, self.mesh,
                axis=self.tenants_axis, conv=conv)
            self._banks[conv] = (padded, bank)
            self._dirty -= set(names)
        if conv not in self._banks:
            names = self._group_names(conv)
            old_names, bank = self._spare.pop(conv, (None, None))
            if bank is None or not self._fits(bank, names):
                bank = None         # the old bank and its graphs go first
                bank = api.stack([self.tenants[n].program for n in names],
                                 self.engine, conv=conv)
                old_names = names
                self._dirty -= set(names)
            for k, n in enumerate(names):
                if old_names[k] != n:
                    bank.swap_in(k, self.tenants[n].program)
                    self._dirty.discard(n)
            self._banks[conv] = (names, bank)
        names, bank = self._banks[conv]
        for n in sorted(self._dirty & set(names)):
            bank.swap_in(names.index(n), self.tenants[n].program)
        self._dirty -= set(names)
        return names, bank

    def _fits(self, bank: ProgramBank, names: List[str]) -> bool:
        """Whether ``names``' programs fit ``bank``'s slots: K, and every
        leaf's shape and dtype."""
        slot = [(t.shape[1:], t.dtype) for t in bank.progs.leaves()]
        return bank.k == len(names) and all(
            [(t.shape, t.dtype) for t in self.tenants[n].program.leaves()]
            == slot for n in names)

    # ---- stacked serving ------------------------------------------------------
    def enqueue(self, name: str, x, encoded: bool = False) -> None:
        """Queue an inference request for the next stacked flush."""
        lits, n = self._encode_request(self.tenants[name], x, encoded)
        self._pending.append((name, lits, n, time.perf_counter()))

    def abandon_pending(self) -> int:
        """Drop every enqueued, unlaunched request (fault recovery: the
        scheduler failed their futures, and their literals must not ride
        the next flush).  Returns the number dropped."""
        n = len(self._pending)
        self._pending = []
        return n

    def flush_async(self) -> Optional[PendingFlush]:
        """Launch the pending requests and return without fetching
        (``None`` when nothing is pending: no bank build, no launch).
        One stacked bank launch per family with resident requests (on the
        card one replay of the bank's flush graph, each tenant's literals
        copied into its slot of the graph's static buffer first; idle
        slots replay a pending tenant's literals and their outputs are
        dropped), one single-program launch per non-resident tenant (the
        cold path: one replay of the engine's inference graph, whose
        answers are copies a later flush does not overwrite while this
        one is in flight).  A tenant that queued twice is served its last
        request.  Everything runs on the current stream, after the slot
        writes of ``swap_in`` and ``swap_resident``."""
        if not self._pending:
            return None
        pending, self._pending = self._pending, []
        t0 = time.perf_counter()
        by_name = {}
        for name, lits, n, t_enq in pending:
            by_name[name] = (lits, n, t_enq)
            self.requests += 1
        hot, cold, claimed = [], [], set()
        for conv in (False, True):
            req = [n for n in self._group_names(conv) if n in by_name]
            if not req:
                continue
            claimed.update(req)
            names, bank = self._bank_for(conv)
            filler = by_name[req[0]][0]
            lits = [by_name[n][0] if n in by_name else filler for n in names]
            out = bank.infer(lits) if conv else bank.predict(lits)
            hot.append((conv, list(names), *out))
            self.stacked_launches += 1
            self.coalesced_requests += len(req)
        for name in by_name:
            if name in claimed:
                continue
            tenant = self.tenants[name]
            sums, cl = self.engine.served_infer(tenant.spec, tenant.program,
                                                by_name[name][0])
            self.cold_requests += 1
            cold.append((name, sums, cl))
        return PendingFlush(t0=t0,
                            served={n: v[2] for n, v in by_name.items()},
                            n_real={n: v[1] for n, v in by_name.items()},
                            hot=hot, cold=cold)

    def collect(self, pf: Optional[PendingFlush]) -> Dict[str, np.ndarray]:
        """Fetch and decode a :class:`PendingFlush`; records each served
        tenant's enqueue-to-answer latency.  Returns {tenant: prediction}."""
        if pf is None:
            return {}
        out = {}
        for conv, names, a, b in pf.hot:
            if conv:      # sums [K, B, H]: argmax on the host
                preds = np.argmax(a.cpu().numpy(), axis=-1)
                votes = None
            else:
                preds, votes = a.cpu().numpy(), b.cpu().numpy()
            for k, name in enumerate(names):
                if name in pf.n_real:
                    n = pf.n_real[name]
                    out[name] = self._decode(
                        name, preds[k], None if conv else votes[k])[:n]
        for name, sums, cl in pf.cold:
            out[name] = self._decode_one(name, sums, cl)[:pf.n_real[name]]
        t_done = time.perf_counter()
        with self._lock:
            for name, t_enq in pf.served.items():
                self._last_flush[name] = t_done - t_enq
        return out

    def flush(self) -> Dict[str, np.ndarray]:
        """``collect(flush_async())``: serve every pending request."""
        return self.collect(self.flush_async())

    # ---- bank slots --------------------------------------------------------
    def unstack(self, conv: bool = False) -> Dict[str, DTMProgram]:
        """Read every slot of a family's bank (flat, or ``conv``) back to
        its tenant and return the programs."""
        names, bank = self._bank_for(conv)
        progs = {}
        for k, name in enumerate(names):
            if name is None:          # a pod roster's pad slot
                continue
            progs[name] = bank.swap_out(k)
            self.tenants[name].program = progs[name]
        return progs

    def routing_table(self) -> Dict[str, Route]:
        """Tenant -> :class:`Route` (device, slot) over both families'
        banks (built if need be): contiguous blocks of slots a device in
        pod mode, device 0 on one device."""
        table: Dict[str, Route] = {}
        for conv in (False, True):
            if not self._group_names(conv):
                continue
            names, _ = self._bank_for(conv)
            table.update(_pod.routing_table(names, self.pod_devices, conv))
        return table

    def swap_in(self, name: str, program: DTMProgram) -> int:
        """Replace a tenant's program and write it into its bank slot (on
        the owning rank in pod mode); returns the slot index (its route's
        ``index`` in its family's bank)."""
        names, bank = self._bank_for(self._is_conv(name))
        k = names.index(name)
        program = program.to(self.engine.device)
        self.tenants[name].program = program
        bank.swap_in(k, program)
        self._dirty.discard(name)
        return k

    def swap_out(self, name: str) -> DTMProgram:
        """A copy of a tenant's program read from its bank slot."""
        names, bank = self._bank_for(self._is_conv(name))
        prog = bank.swap_out(names.index(name))
        self.tenants[name].program = prog
        return prog

    def program_nbytes(self, name: str) -> int:
        """Bytes of one tenant's program: what a swap moves."""
        return self.tenants[name].program.nbytes

    def stats(self) -> dict:
        with self._lock:
            resident = self.resident_names()
            names = sorted(self.tenants)
            return {"tenants": names, "requests": self.requests,
                    "swaps": self.swaps, "cache": self.engine.cache_report(),
                    "pod_devices": self.pod_devices,
                    "stacked_launches": self.stacked_launches,
                    "coalesced_requests": self.coalesced_requests,
                    "queue_depth": len(self._pending),
                    "resident_tenants": len(resident),
                    "swapped_tenants": len(names) - len(resident),
                    "resident": sorted(resident),
                    "cold_requests": self.cold_requests,
                    "membership_swaps": self.membership_swaps,
                    "last_flush_latency_s": dict(sorted(
                        self._last_flush.items())),
                    "program_nbytes": {n: self.program_nbytes(n)
                                       for n in names},
                    "skip_frac": {n: self.skip_frac(n) for n in names}}


# ---------------------------------------------------------------------------
# demo roster
# ---------------------------------------------------------------------------

def demo_specs(small: bool = True) -> Dict[str, TMSpec]:
    """One spec per TM kind: the five-variant multi-tenant roster."""
    rng = np.random.default_rng(0)
    f, c = (32, 24) if small else (256, 128)
    calib = rng.standard_normal((64, 8)).astype(np.float32)
    return {
        "cotm": TMSpec.coalesced(features=f, classes=4, clauses=c, T=16,
                                 s=4.0),
        "vanilla": TMSpec.vanilla(features=f, classes=4,
                                  clauses=max(c // 4, 4), T=16, s=4.0),
        "conv": TMSpec.conv(img_h=8, img_w=8, patch=3, classes=3,
                            clauses=c, T=12, s=3.0),
        "regression": TMSpec.regression(features=f, clauses=c, T=64, s=3.0),
        "head": TMSpec.head(calib, classes=3, therm_bits=4,
                            clauses=c, T=16, s=4.0),
    }


def demo_batch(spec: TMSpec, batch: int, seed: int = 1) -> np.ndarray:
    """A request of ``batch`` rows for ``spec`` from ``seed``."""
    rng = np.random.default_rng(seed)
    if spec.kind == "conv":
        return (rng.random((batch, spec.img_h, spec.img_w)) < 0.3
                ).astype(np.int8)
    if spec.kind == "head":
        return rng.standard_normal(
            (batch, spec.thresholds.shape[0])).astype(np.float32)
    return (rng.random((batch, spec.features)) < 0.5).astype(np.int8)


# ---------------------------------------------------------------------------
# reconfiguration-latency benchmark
# ---------------------------------------------------------------------------

def _block(device: torch.device) -> None:
    # the benchmark's timing fence, not the serving path
    if device.type == "cuda":
        torch.cuda.synchronize()  # dtmlint: disable=DTM003 (a timing fence)


def reconfig_benchmark(device=None, batch_slot: int = 32, rounds: int = 8,
                       small: bool = True, out: str = "BENCH_reconfig.json",
                       autotune: str = "seed", autotune_cache=None) -> dict:
    """Serve all five TM kinds round-robin off one engine and time it (on
    the card unless ``device`` says otherwise; host clock, fenced by a
    synchronise).  The report has the JAX package's keys, with
    ``device`` (the card's name, or ``cpu``) for its ``backend``; it is
    written to ``out``.  Raises when a stage holds more than one graph."""
    specs = demo_specs(small)
    tile = api.tile_for(*specs.values())
    engine = api.compile(tile, device=device, autotune=autotune,
                         autotune_cache=autotune_cache)
    dev = engine.device
    server = TMServer(engine, batch_slot=batch_slot)
    for name, spec in specs.items():
        server.register(name, spec)
    batches = {n: demo_batch(s, batch_slot) for n, s in specs.items()}
    names = sorted(specs)

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        _block(dev)
        return time.perf_counter() - t0

    # the first request per tenant: its stage's graph is captured
    compile_s = {n: timed(lambda n=n: server.predict(n, batches[n]))
                 for n in names}

    steady_us = {}
    for name in names:
        server.predict(name, batches[name])                 # make resident
        steady_us[name] = timed(lambda name=name: [
            server.predict(name, batches[name])
            for _ in range(rounds)]) / rounds * 1e6

    swap_us = timed(lambda: [server.predict(n, batches[n])
                             for _ in range(rounds) for n in names]
                    ) / (rounds * len(names)) * 1e6

    labels = {n: (np.zeros(batch_slot, np.float32)
                  if specs[n].kind == "regression"
                  else np.zeros(batch_slot, np.int32)) for n in names}
    train_compile_s = {n: timed(lambda n=n: server.train(
        n, batches[n], labels[n])) for n in names}
    train_swap_us = timed(lambda: [server.train(n, batches[n], labels[n])
                                   for _ in range(rounds) for n in names]
                          ) / (rounds * len(names)) * 1e6

    # the no-DTM baseline: a fresh engine ("resynthesis") per model switch
    spec0 = specs["cotm"]

    def resynthesise():
        fresh = api.compile(tile, device=device, autotune=autotune,
                            autotune_cache=autotune_cache)
        prog = fresh.lower(spec0, threefry.key(0, dev))
        fresh.served_infer(spec0, prog, fresh.encode(spec0,
                                                     batches["cotm"]))
    resynthesis_s = timed(resynthesise)

    cache = engine.cache_report()
    if any(v > 1 for v in cache.values() if isinstance(v, int)):
        raise RuntimeError(f"a stage recaptured across swaps: {cache}")
    mean_steady = float(np.mean(list(steady_us.values())))
    report = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "tile": dataclasses.asdict(tile),
        "batch_slot": batch_slot,
        "n_models": len(names),
        "rounds": rounds,
        "engine_compile_s": compile_s,
        "train_compile_s": train_compile_s,
        "steady_us": steady_us,
        "swap_us": swap_us,
        "swap_overhead_us": swap_us - mean_steady,
        "train_swap_us": train_swap_us,
        "resynthesis_baseline_s": resynthesis_s,
        "speedup_vs_resynthesis": resynthesis_s * 1e6 / max(swap_us, 1e-9),
        "server": server.stats(),
    }
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=reconfig_benchmark.__doc__
                                 .splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny models and few rounds")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    ap.add_argument("--batch-slot", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--autotune", default="seed")
    ap.add_argument("--autotune-cache", default=None)
    ap.add_argument("--out", default="BENCH_reconfig.json")
    args = ap.parse_args(argv)
    rounds = args.rounds if args.rounds is not None else (
        4 if args.smoke else 16)
    rep = reconfig_benchmark(device=args.device, batch_slot=args.batch_slot,
                             rounds=rounds, small=args.smoke, out=args.out,
                             autotune=args.autotune,
                             autotune_cache=args.autotune_cache)
    steady = float(np.mean(list(rep["steady_us"].values())))
    print(f"device={rep['device']}  tenants={rep['n_models']}  "
          f"requests={rep['server']['requests']}  "
          f"swaps={rep['server']['swaps']}")
    print(f"steady latency      : {steady:10.1f} us/req")
    print(f"swap-every-request  : {rep['swap_us']:10.1f} us/req "
          f"(overhead {rep['swap_overhead_us']:+.1f} us)")
    print(f"train swap          : {rep['train_swap_us']:10.1f} us/step")
    print(f"resynthesis baseline: "
          f"{rep['resynthesis_baseline_s'] * 1e6:10.1f} us "
          f"({rep['speedup_vs_resynthesis']:.0f}x a hot swap)")
    print(f"cache entries       : {rep['server']['cache']} "
          "(every stage <= 1 graph across swaps)")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
