"""Multi-tenant DTM serving on one device: one engine, N tenant programs.

The accelerator is built once and switching the hosted model is a memory
rewrite: the engine is the datapath, a :class:`DTMProgram` is the model.
Two request paths:

* :meth:`TMServer.predict` swaps to one tenant and serves its request
  (the edge path when the batch slot is <= 4 rows).
* :meth:`TMServer.enqueue` queues requests; :meth:`TMServer.flush_async`
  runs every tenant through ONE stacked :class:`ProgramBank` launch per
  kernel and returns without waiting; :meth:`TMServer.collect` fetches and
  decodes (the only host-device sync of the path).  :meth:`TMServer.flush`
  is the two in one.

Requests are padded to a fixed ``batch_slot`` by repeating their last row,
and the padding is dropped from the answers.

:meth:`TMServer.train` swaps to one tenant and applies one on-line
training step to its program (on-chip training on the same datapath);
the tenant's bank slot is then stale, and the next stacked flush writes
the fresh program back into it.  Each tenant keeps its own PRNG and step
count, and a lifetime clause-skip fraction (``skip_frac`` in
:meth:`TMServer.stats`).  Single device; the conv kind, bank membership
and the scheduler come in later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import api
from repro_torch.api import ProgramBank, TMSpec
from repro_torch.core.dtm import DTMEngine, DTMProgram
from repro_torch.core.prng import PRNG


@dataclasses.dataclass
class _Tenant:
    spec: TMSpec
    program: DTMProgram
    prng: Optional[PRNG] = None   # made from seed + 1 at the first train
    seed: int = 0
    steps: int = 0                # lifetime applied training steps


@dataclasses.dataclass
class PendingFlush:
    """One launched stacked flush whose results are not fetched yet."""

    t0: float                       # flush_async entry time
    served: Dict[str, float]        # tenant -> enqueue time
    n_real: Dict[str, int]          # tenant -> un-padded batch
    names: List[str]                # bank slot order
    preds: torch.Tensor             # [K, B] int32, on the device
    votes: torch.Tensor             # [K, B] int32, on the device


class TMServer:
    """One engine, N resident programs, swap-per-request and stacked
    serving.  ``batch_slot`` is the fixed request batch; requests are
    padded up to it."""

    def __init__(self, engine: DTMEngine, batch_slot: int = 32):
        self.engine = engine
        self.batch_slot = batch_slot
        self.tenants: Dict[str, _Tenant] = {}
        self.active: Optional[str] = None
        self.swaps = 0
        self.requests = 0
        self.stacked_launches = 0
        self.coalesced_requests = 0
        self._pending: List[Tuple[str, torch.Tensor, int, float]] = []
        self._bank: Optional[Tuple[List[str], ProgramBank]] = None
        self._last_flush: Dict[str, float] = {}
        self._dirty: set = set()    # trained tenants whose bank slot is stale
        self._skip_acc: Dict[str, List[int]] = {}   # [active, total] groups

    # ---- tenant management ------------------------------------------------
    def register(self, name: str, spec: TMSpec,
                 program: Optional[DTMProgram] = None, seed: int = 0,
                 prng: Optional[PRNG] = None, steps: int = 0):
        """Admit a model: lower its spec (drawing the program from
        ``seed``) or adopt an already-lowered ``program``.  ``prng`` and
        ``steps`` resume a tenant mid-stream; by default its PRNG is made
        from ``seed + 1`` when it first trains."""
        if spec.kind == "conv":
            raise NotImplementedError("the conv kind is not ported yet")
        if program is None:
            program = self.engine.lower(
                spec, torch.Generator().manual_seed(seed))
        if prng is not None:
            prng = prng.to(self.engine.device)
        self.tenants[name] = _Tenant(spec, program.to(self.engine.device),
                                     prng, seed, steps)
        self._bank = None           # roster changed: restack on next flush
        self._skip_acc.pop(name, None)

    def _swap_to(self, name: str) -> _Tenant:
        tenant = self.tenants[name]
        if self.active != name:
            self.swaps += 1
            self.active = name
        return tenant

    def _encode_request(self, tenant: _Tenant, x, encoded: bool
                        ) -> Tuple[torch.Tensor, int]:
        """Pad a request to the batch slot and encode it (unless it came
        as packed engine literals [n, W])."""
        n = len(x)
        if not 0 < n <= self.batch_slot:
            raise ValueError(f"request of {n} rows; batch_slot is "
                             f"{self.batch_slot}")
        if encoded:
            lits = torch.as_tensor(x, device=self.engine.device)
        else:
            lits = self.engine.encode(tenant.spec, np.asarray(x))
        if n < self.batch_slot:
            lits = torch.cat([lits, lits[-1:].expand(self.batch_slot - n, -1)])
        return lits, n

    def _decode(self, name: str, preds: np.ndarray, votes: np.ndarray
                ) -> np.ndarray:
        spec = self.tenants[name].spec
        if spec.kind == "regression":
            return votes.astype(np.float32) / spec.tm_config().T
        return preds

    # ---- request paths ----------------------------------------------------
    def predict(self, name: str, x, encoded: bool = False) -> np.ndarray:
        """Swap to tenant ``name`` and serve one request."""
        tenant = self._swap_to(name)
        self.requests += 1
        lits, n = self._encode_request(tenant, x, encoded)
        sums, cl = self.engine.infer_fn(tenant.spec)(tenant.program, lits)
        if tenant.spec.kind == "regression":
            t = tenant.spec.tm_config().T
            votes = cl.sum(dim=-1).clamp(0, t).cpu().numpy()
            return self._decode(name, None, votes)[:n]
        return torch.argmax(sums, dim=-1).cpu().numpy()[:n]

    def train(self, name: str, x, y, encoded: bool = False) -> dict:
        """Swap to tenant ``name`` and apply one training step to its
        program.  A training request fills the batch slot (padding would
        repeat the last example's feedback).  ``encoded=True`` takes
        packed engine literals and encoded labels.  Returns the step's
        stats as host ints (one fetch)."""
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
        if tenant.prng is None:
            tenant.prng = PRNG.create(tenant.spec.tm_config(),
                                      tenant.seed + 1,
                                      device=self.engine.device)
        step = self.engine.train_fn(tenant.spec)
        tenant.program, tenant.prng, stats = step(tenant.program,
                                                  tenant.prng, lits, lab)
        self._dirty.add(name)       # its bank slot is stale until a flush
        tenant.steps += 1
        host = dict(zip(stats, torch.stack(list(stats.values())).tolist()))
        acc = self._skip_acc.setdefault(name, [0, 0])
        acc[0] += host["active_groups"]
        acc[1] += host["total_groups"]
        return host

    def skip_frac(self, name: str) -> Optional[float]:
        """Lifetime clause-skip fraction of a tenant's on-line training
        (``None`` before it trained)."""
        acc = self._skip_acc.get(name)
        if acc is None or acc[1] == 0:
            return None
        return 1.0 - acc[0] / acc[1]

    def _bank_for(self) -> Tuple[List[str], ProgramBank]:
        """The resident bank over every tenant, built once per roster;
        slots of tenants trained since are rewritten first."""
        if self._bank is None:
            names = sorted(self.tenants)
            self._bank = (names, api.stack(
                [self.tenants[n].program for n in names], self.engine))
            self._dirty.clear()
        names, bank = self._bank
        for n in sorted(self._dirty):
            bank.swap_in(names.index(n), self.tenants[n].program)
        self._dirty.clear()
        return self._bank

    def enqueue(self, name: str, x, encoded: bool = False) -> None:
        """Queue an inference request for the next stacked flush."""
        lits, n = self._encode_request(self.tenants[name], x, encoded)
        self._pending.append((name, lits, n, time.perf_counter()))

    def flush_async(self) -> Optional[PendingFlush]:
        """Launch every pending request in one stacked bank launch and
        return without fetching (``None`` when nothing is pending).  Idle
        slots replay a pending tenant's literals; their outputs are
        dropped.  A tenant that queued twice is served its last request."""
        if not self._pending:
            return None
        pending, self._pending = self._pending, []
        t0 = time.perf_counter()
        by_name = {}
        for name, lits, n, t_enq in pending:
            by_name[name] = (lits, n, t_enq)
            self.requests += 1
        names, bank = self._bank_for()
        filler = next(iter(by_name.values()))[0]
        lits = [by_name[n][0] if n in by_name else filler for n in names]
        preds, votes = bank.predict(lits)
        self.stacked_launches += 1
        self.coalesced_requests += len(by_name)
        return PendingFlush(t0=t0,
                            served={n: v[2] for n, v in by_name.items()},
                            n_real={n: v[1] for n, v in by_name.items()},
                            names=list(names), preds=preds, votes=votes)

    def collect(self, pf: Optional[PendingFlush]) -> Dict[str, np.ndarray]:
        """Fetch and decode a :class:`PendingFlush`; records each served
        tenant's enqueue-to-answer latency.  Returns {tenant: prediction}."""
        if pf is None:
            return {}
        preds, votes = pf.preds.cpu().numpy(), pf.votes.cpu().numpy()
        out = {}
        for k, name in enumerate(pf.names):
            if name in pf.n_real:
                n = pf.n_real[name]
                out[name] = self._decode(name, preds[k], votes[k])[:n]
        t_done = time.perf_counter()
        for name, t_enq in pf.served.items():
            self._last_flush[name] = t_done - t_enq
        return out

    def flush(self) -> Dict[str, np.ndarray]:
        """``collect(flush_async())``: serve every pending request."""
        return self.collect(self.flush_async())

    # ---- bank slots --------------------------------------------------------
    def unstack(self) -> Dict[str, DTMProgram]:
        """Read every bank slot back to its tenant and return the programs."""
        names, bank = self._bank_for()
        progs = {}
        for k, name in enumerate(names):
            progs[name] = bank.swap_out(k)
            self.tenants[name].program = progs[name]
        return progs

    def swap_in(self, name: str, program: DTMProgram) -> int:
        """Replace a tenant's program and write it into its bank slot;
        returns the slot index."""
        names, bank = self._bank_for()
        k = names.index(name)
        program = program.to(self.engine.device)
        self.tenants[name].program = program
        bank.swap_in(k, program)
        self._dirty.discard(name)
        return k

    def swap_out(self, name: str) -> DTMProgram:
        """A copy of a tenant's program read from its bank slot."""
        names, bank = self._bank_for()
        prog = bank.swap_out(names.index(name))
        self.tenants[name].program = prog
        return prog

    def program_nbytes(self, name: str) -> int:
        """Bytes of one tenant's program: what a swap moves."""
        return self.tenants[name].program.nbytes

    def stats(self) -> dict:
        return {"tenants": sorted(self.tenants), "requests": self.requests,
                "swaps": self.swaps, "cache": self.engine.cache_report(),
                "stacked_launches": self.stacked_launches,
                "coalesced_requests": self.coalesced_requests,
                "queue_depth": len(self._pending),
                "last_flush_latency_s": dict(sorted(
                    self._last_flush.items())),
                "program_nbytes": {n: self.program_nbytes(n)
                                   for n in sorted(self.tenants)},
                "skip_frac": {n: self.skip_frac(n)
                              for n in sorted(self.tenants)}}
