"""Pod-scale TM execution on ``torch.distributed``: tenant-parallel banks
and clause-sharded machines over a device mesh.

The paper's single-device story is run-time reconfiguration: one built
datapath, many models, a swap is a memory rewrite.  This module carries
it over a mesh of devices, the JAX package's ``launch/pod.py`` with one
process per device (SPMD) in place of its single controller: every rank
runs the same calls with the same replicated inputs (programs, literals,
labels, PRNGs) and gets what the JAX controller gets.  A mesh is a
``DeviceMesh`` (:mod:`repro_torch.launch.mesh`); its caller starts the
process group.  :func:`repro_torch.api.plan_for` chooses between the two
shardings, both through the engine's own stage bodies:

* **tenant-parallel** (:class:`PodBank`, axis ``tenants``) — a stacked
  bank's K slots in contiguous blocks of K/D, one block a rank: each rank
  holds a device-local :class:`repro_torch.api.ProgramBank` of its slots
  and runs it with no collective (on the card one replay of the bank's
  graph); only the answers are gathered, in global slot order, so every
  rank returns every slot's.  ``swap_in`` writes on the owning rank,
  ``swap_out`` and ``unstack`` broadcast from it.

* **clause-sharded** (:class:`ShardedTM`, axis ``clauses``) — one
  machine's clause rows over the ranks (TA ``[r_loc, L]``, include
  ``[r_loc, W]``, weight columns ``[H, r_loc]``); clause evaluation and
  the TA update stay on the rank and only the ``[B, H]`` class sums
  (with the Alg-6 stat gathers) cross.  Results equal the single-device
  engine's bit for bit (the invariants over
  :meth:`repro_torch.core.dtm.DTMEngine._shard_window`, whose window is
  :func:`repro_torch.core.collectives.row_window`'s).  Each stage is a
  step graph (the JAX package jits its ``shard_map`` bodies): one replay
  on the card over an NCCL group, collectives included; gloo collectives
  cannot be captured, so over gloo the same body runs eagerly.

Run it on the CPU with ``gloo`` ranks (the tests start them:
``torch.multiprocessing`` and a ``file://`` init), on the cards with
``nccl``, one rank a card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.api import ProgramBank
from repro_torch.core.collectives import broadcast, gather_dim, row_window
from repro_torch.core.dtm import (FIELDS, INFER_LEAVES, STAT_KEYS,
                                  DTMEngine, DTMProgram, _sig, _prng_sig,
                                  prng_like, store_step)
from repro_torch.core.graph import StepGraph
from repro_torch.core.prng import PRNG
from .mesh import mesh_axis_size

# ---------------------------------------------------------------------------
# program partition specs (clause sharding)
# ---------------------------------------------------------------------------

_CLAUSE_DIMS = {"ta": 0, "weights": 1, "cl_mask": 0, "inc": 0}


def program_specs(axis: str = "clauses") -> Dict[str, Optional[tuple]]:
    """How a clause-sharded program lies over ``axis`` (the JAX
    PartitionSpecs): per leaf ``(axis, dim)`` for the leaves split along
    ``dim`` (the clause rows of ``ta``, ``cl_mask`` and ``inc``, the
    clause columns of ``weights``), ``None`` for the replicated ones."""
    return {f: (axis, _CLAUSE_DIMS[f]) if f in _CLAUSE_DIMS else None
            for f in FIELDS}


def shard_program(prog: DTMProgram, mesh,
                  axis: str = "clauses") -> DTMProgram:
    """This rank's window of a lowered program (:func:`program_specs`):
    copies of its rows of the clause-indexed leaves, the replicated
    leaves as they are.  The padded R must split evenly over the axis."""
    _, row0, r_loc = row_window(prog.ta.shape[0], mesh.get_group(axis),
                                axis)
    out = {}
    for f in FIELDS:
        t = getattr(prog, f)
        dim = _CLAUSE_DIMS.get(f)
        out[f] = t if dim is None else t.narrow(dim, row0, r_loc).clone()
    return DTMProgram(**out)


def gather_program(prog: DTMProgram, mesh,
                   axis: str = "clauses") -> DTMProgram:
    """The whole program on every rank from each rank's window (the JAX
    ``gather_program``: one all-gather per clause-indexed leaf)."""
    group = mesh.get_group(axis)
    return DTMProgram(**{
        f: (getattr(prog, f) if f not in _CLAUSE_DIMS else
            gather_dim(getattr(prog, f), group, _CLAUSE_DIMS[f]))
        for f in FIELDS})


# ---------------------------------------------------------------------------
# ShardedTM: one machine, clause rows spread over the mesh
# ---------------------------------------------------------------------------

class ShardedTM:
    """Clause-sharded train and infer of ONE program over ``axis``.

    The engine's ``_*_sharded_impl`` bodies on every rank; literals,
    labels and the PRNG replicated, the program as :meth:`shard` lays it
    out.  :meth:`infer` returns the class sums and the clause matrix
    ``[B, R]`` in global row order (gathered); :meth:`train_step` the
    rank's window of the new program, the PRNG and the global stats.

    Each stage runs as one step graph a stage and shape (stages
    ``infer_sharded``, ``train_sharded`` and their ``_conv`` forms,
    listed by ``engine.graph_report()``), held here: captured on the card
    when the axis's group is NCCL (every rank warms up and captures at
    the same call), run eagerly over gloo.  A capture that fails raises;
    nothing runs the eager chain in its place."""

    def __init__(self, engine: DTMEngine, mesh, axis: str = "clauses",
                 conv: bool = False):
        self.engine = engine
        self.mesh = mesh
        self.axis = axis
        self.conv = conv
        self.group = mesh.get_group(axis)
        self.shards = row_window(engine.R, self.group, axis)[0]
        self.capture = dist.get_backend(self.group) == "nccl"
        self._graphs: Dict[tuple, StepGraph] = {}

    def shard(self, prog: DTMProgram) -> DTMProgram:
        return shard_program(prog, self.mesh, self.axis)

    def gather(self, prog: DTMProgram) -> DTMProgram:
        return gather_program(prog, self.mesh, self.axis)

    def _graph(self, stage: str, key: tuple, make) -> StepGraph:
        key = (stage, *key)
        graph = self._graphs.get(key)
        if graph is None:
            body, state, const = make()
            graph = self.engine.step_graph(stage, body, state, const,
                                           capture=self.capture)
            self._graphs[key] = graph
        return graph

    def _infer_graph(self, prog: DTMProgram, plits: torch.Tensor
                     ) -> StepGraph:
        eng, group, axis = self.engine, self.group, self.axis
        stage = "infer_conv_sharded" if self.conv else "infer_sharded"
        impl = (eng._infer_conv_sharded_impl if self.conv
                else eng._infer_sharded_impl)

        def make():
            # read-only: the window's INFER_LEAVES (never the TA states)
            # and the literals; state: the answers
            const = {f: getattr(prog, f).clone(
                memory_format=torch.contiguous_format) for f in INFER_LEAVES}
            const["plits"] = plits.clone(memory_format=torch.contiguous_format)
            B, dev = plits.shape[0], eng.device
            state = {"sums": torch.zeros((B, eng.H), dtype=torch.int32,
                                         device=dev),
                     "cl": torch.zeros((B, eng.R), dtype=torch.int32,
                                       device=dev)}

            def body(b):
                p = DTMProgram(**{f: b[f] if f in INFER_LEAVES else None
                                  for f in FIELDS})
                sums, cl = impl(p, b["plits"], group, axis=axis)
                b["sums"].copy_(sums)
                b["cl"].copy_(gather_dim(cl, group, 1))
            return body, state, const

        B = plits.shape[0]
        eng.resolve_plans(B * plits.shape[1] if self.conv else B)
        return self._graph(stage, (_sig(getattr(prog, f) for f in
                                        INFER_LEAVES), _sig((plits,))), make)

    def infer(self, prog: DTMProgram, plits: torch.Tensor):
        """(sums [B, H], clause [B, R]): the contract of ``engine.infer``
        (``infer_conv`` for a conv machine), as copies."""
        graph = self._infer_graph(prog, plits)
        leaves = tuple(getattr(prog, f) for f in INFER_LEAVES)
        with graph.lock:
            if not graph.holds("prog", prog, *leaves):
                for f, t in zip(INFER_LEAVES, leaves):
                    graph.const[f].copy_(t)
                graph.mark("prog", prog, *leaves)
            graph.const["plits"].copy_(plits)
            graph.run()
            return graph.state["sums"].clone(), graph.state["cl"].clone()

    def _train_graph(self, prog: DTMProgram, prng: PRNG,
                     plits: torch.Tensor, labels: torch.Tensor
                     ) -> StepGraph:
        eng, group, axis = self.engine, self.group, self.axis
        stage = "train_conv_sharded" if self.conv else "train_sharded"
        impl = (eng._train_conv_sharded_impl if self.conv
                else eng._train_sharded_impl)

        def make():
            def own(t):
                return t.clone(memory_format=torch.contiguous_format)
            state = {f: own(getattr(prog, f)) for f in FIELDS}
            prng_buf = prng.map(own)
            n_r = len(prng_buf.leaves())
            state.update({f"prng{i}": t
                          for i, t in enumerate(prng_buf.leaves())})
            state["stats"] = torch.zeros(len(STAT_KEYS), dtype=torch.int32,
                                         device=eng.device)
            const = {"plits": own(plits),
                     "labels": own(labels).to(torch.int32)}

            def body(b):
                p = DTMProgram(*(b[f] for f in FIELDS))
                r = prng_like(prng_buf, [b[f"prng{i}"] for i in range(n_r)])
                new, new_r, stats = impl(p, r, b["plits"], b["labels"],
                                         group, axis=axis)
                b["stats"].copy_(store_step(b, new, new_r, stats))
            return body, state, const

        B = plits.shape[0]
        if self.conv:
            eng.resolve_plans(B * plits.shape[1])
        else:
            eng.resolve_plans(B, training=True)
        return self._graph(stage, (_sig(prog.leaves()), _prng_sig(prng),
                                   _sig((plits, labels))), make)

    def train_step(self, prog: DTMProgram, prng: PRNG, plits: torch.Tensor,
                   labels: torch.Tensor):
        """The contract of ``engine.train_step`` / ``train_conv`` on the
        rank's window: (window of the new program, PRNG, stats: int32 0-d
        tensors keyed by ``STAT_KEYS``), all copies."""
        graph = self._train_graph(prog, prng, plits, labels)
        eng = self.engine
        with graph.lock:
            eng._load_state(graph, prog, prng)
            graph.const["plits"].copy_(plits)
            graph.const["labels"].copy_(labels)
            graph.run()
            new, new_prng = eng._unload_state(graph, prog, prng)
            row = graph.state["stats"].clone()
        return new, new_prng, {k: row[i] for i, k in enumerate(STAT_KEYS)}


# ---------------------------------------------------------------------------
# PodBank: tenant-parallel stacked serving over a ``tenants`` axis
# ---------------------------------------------------------------------------

class PodBank:
    """A bank of K slots over a ``tenants`` axis of D ranks, with the
    serving interface of :class:`repro_torch.api.ProgramBank` (``k``,
    ``conv``, ``infer``, ``predict``, ``train``, ``swap_in``,
    ``swap_out``, ``unstack``, ``nbytes``) over global slots: rank d
    holds slots ``[d·K/D, (d+1)·K/D)`` as a device-local ProgramBank
    (``local``, which alone holds program and PRNG tensors) and runs it
    with no collective, as a single-device bank (its flush and train
    graphs replay on the card); :meth:`infer`, :meth:`predict` and
    :meth:`train` then gather every rank's answers in global slot order.
    Built by :func:`pod_stack`; K must be a multiple of D (pad the
    roster: :class:`repro_torch.launch.serve_tm.TMServer` does).
    :meth:`swap_in` writes on the owning rank, and :meth:`swap_out` /
    :meth:`unstack` broadcast from it, so every rank gets the
    program."""

    def __init__(self, engine: DTMEngine, local: ProgramBank, k: int,
                 mesh, axis: str = "tenants"):
        self.mesh = mesh
        self.axis = axis
        self.devices = mesh_axis_size(mesh, axis)
        if k % self.devices:
            raise ValueError(f"bank slots ({k}) must be a multiple of the "
                             f"'{axis}' axis size ({self.devices}) — pad "
                             f"the roster")
        self.engine = engine
        self.local = local
        self.k = k
        self.conv = local.conv
        self.group = mesh.get_group(axis)
        self.spd = k // self.devices          # slots a rank
        self.rank = dist.get_rank(self.group)

    def _slice(self, lits):
        """This rank's slots' literals of a bank's [K, ...] or K list."""
        lo = self.rank * self.spd
        if isinstance(lits, torch.Tensor):
            return lits[lo:lo + self.spd]
        return list(lits)[lo:lo + self.spd]

    def _gather(self, outs) -> tuple:
        # every rank's [K/D, ...] answers, joined in global slot order
        return tuple(gather_dim(o, self.group, 0) for o in outs)

    def infer(self, lits):
        """lits [K, B, W] (conv: [K, B, P, W]) or K arrays -> (sums
        [K, B, H], clause [K, B, R]) on every rank."""
        return self._gather(self.local.infer(self._slice(lits)))

    def predict(self, lits):
        """Flat banks: (preds [K, B], votes [K, B]) on every rank."""
        return self._gather(self.local.predict(self._slice(lits)))

    def train(self, lits, labels) -> dict:
        """One stacked train step of every slot (the local bank's, in
        place); returns the stats, [K] per key, on every rank."""
        if isinstance(labels, (list, tuple)):
            labels = torch.stack([torch.as_tensor(t) for t in labels])
        labels = torch.as_tensor(labels).to(device=self.engine.device,
                                            dtype=torch.int32)
        stats = self.local.train(self._slice(lits), self._slice(labels))
        keys = list(stats)
        joined = gather_dim(torch.stack([stats[k] for k in keys], dim=1),
                            self.group, 0)
        return {k: joined[:, i] for i, k in enumerate(keys)}

    def owner(self, k: int) -> tuple:
        """(rank along the axis, local slot) of global slot ``k``."""
        if not 0 <= k < self.k:
            raise IndexError(f"slot {k} of a {self.k}-slot bank")
        return k // self.spd, k % self.spd

    def swap_in(self, k: int, program: DTMProgram) -> None:
        """Overwrite global slot ``k`` (on its owning rank)."""
        dev, slot = self.owner(k)
        if dev == self.rank:
            self.local.swap_in(slot, program)

    def swap_out(self, k: int) -> DTMProgram:
        """Global slot ``k`` as a program (a copy) on every rank,
        broadcast from its owner."""
        dev, slot = self.owner(k)
        mine = self.local.swap_out(slot if dev == self.rank else 0)
        return mine.map(lambda t: broadcast(t, dev, self.group))

    def unstack(self) -> List[DTMProgram]:
        return [self.swap_out(i) for i in range(self.k)]

    @property
    def nbytes(self) -> int:
        """Bytes of the rank's slots."""
        return self.local.nbytes


def pod_stack(programs: Sequence[DTMProgram], engine: DTMEngine, mesh,
              axis: str = "tenants", conv: bool = False,
              prngs: Optional[Sequence[PRNG]] = None) -> PodBank:
    """:func:`repro_torch.api.stack` over a ``tenants`` axis: every rank
    passes all K programs (and PRNGs) and stacks its block of K/D."""
    programs = list(programs)
    devices = mesh_axis_size(mesh, axis)
    if len(programs) % devices:
        raise ValueError(f"bank slots ({len(programs)}) must be a multiple "
                         f"of the '{axis}' axis size ({devices}) — pad the "
                         f"roster")
    spd = len(programs) // devices
    lo = dist.get_rank(mesh.get_group(axis)) * spd
    local = api.stack(programs[lo:lo + spd], engine, conv=conv,
                      prngs=None if prngs is None
                      else list(prngs)[lo:lo + spd])
    return PodBank(engine, local, len(programs), mesh, axis)


# ---------------------------------------------------------------------------
# Route: the TMServer routing-table entry (tenant -> device, slot)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Route:
    """Where one tenant's program lives: bank slot ``index`` (the global
    stacked row) = device ``device`` (its position along the tenants
    axis) × slots a device + ``slot`` (the device-local row); ``conv``
    names the family's bank."""

    device: int
    slot: int
    index: int
    conv: bool


def routing_table(names: Sequence[Optional[str]], devices: int,
                  conv: bool) -> Dict[str, Route]:
    """Tenant -> :class:`Route` of one padded bank roster (``None``
    entries are pad slots and get no route): contiguous blocks of
    ``len(names) / devices`` slots a device."""
    spd = len(names) // max(devices, 1)
    return {name: Route(device=k // spd, slot=k % spd, index=k, conv=conv)
            for k, name in enumerate(names) if name is not None}


def pad_roster(names: List[str], devices: int) -> List[Optional[str]]:
    """A roster padded with ``None`` to a multiple of the device count
    (pad slots replay a real program; their answers are dropped)."""
    return list(names) + [None] * ((-len(names)) % max(devices, 1))


def first_pad_slot(names: Sequence[Optional[str]]) -> Optional[int]:
    """The first pad slot of a padded roster, or ``None`` when it is
    full: a promotion fills it in place (one routed ``swap_in``) before
    paying a restack."""
    for k, name in enumerate(names):
        if name is None:
            return k
    return None
