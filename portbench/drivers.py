"""The drivers that a traffic file names: how a cell's load reaches the
program, how its window is timed and how its outputs are judged.

``fit``          closed loop of ``TM.fit(x, y, epochs, batch)`` passes
                 over the configuration's training rows, from each of
                 ``programs`` initial programs in turn.
``partial_fit``  closed loop of ``TM.partial_fit`` on ``batch`` rows at a
                 time, passes of ``pass_rows`` rows.
``serve``        ``api.serve``'s scheduler, driven inline by the client's
                 one thread, under a closed loop of ``outstanding``
                 requests a tenant.

Every training pass starts from an initial program and PRNG drawn from
the seed, so each pass from one of them does the same work.  A driver records its counters for the
per-layer readers and keeps what it needs to be judged by the reference
after the window (:meth:`judge`).

What a driver takes from the configuration file:

``models``     one entry a model (training: exactly one), every key that
               ``api.TMSpec`` has as a field passed to it (:func:`spec_of`),
               e.g. ``kind: "conv"`` with ``img_h``, ``img_w``, ``patch``;
               other keys are ignored.
``data``       a task a model (``portbench/data.py``); its ``shape``
               ([h, w]), where stated, makes the rows images [n, h, w]
               for ``fit``, ``partial_fit`` and the serving pools.
``engine``     the engine's flags and the geometry it must have
               (:func:`check_geometry`: L, R, H, W, and P where stated).
``reference``  the plain reference module (``portbench/run.py``,
               :func:`portbench.run.reference`): ``KINDS``,
               ``bool_features(model)`` (sizes the initial and firing
               programs and the judged snapshots), ``has_weights(model)``
               (whether a program carries class weights),
               ``motif_literals(model, task, features)`` (where the firing
               program's included features lie among the literals),
               ``model_at``, ``rows_of``, ``held_ta``, ``weight_matrix``,
               ``Cluster`` (``create(seed, lanes, bits, device)``,
               ``lanes``, ``master``, ``cycles``), ``train_step(model,
               engine, ta, weights, cluster, x, y)`` on the rows as the
               program takes them, and ``predict(model, ta, weights, x,
               device)``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from portbench import data
from portbench.trace import Tracer

STATS_CHUNK = 4096   # partial_fit steps whose stats are summed together
CLOSED_GUESS_PER_S = 8192   # a closed loop's first log size, requests/s
PENDING, ANSWERED, FAILED = 0, 1, 2   # a request's state


class AnswerLog:
    """Each request of a serving window (tenant, first pool row, rows) and
    its answer and time, in flat numpy buffers that grow by doubling.
    A request's done-callback, which runs inside the scheduler's
    ``step`` on the client's own thread, only stamps the time and queues
    the future; the client takes it from there (:meth:`take`), records
    the answer and sends what follows.  The harness keeps no Python
    object a request, so the collector's work during the window stays
    the program's own."""

    def __init__(self, cap: int, max_rows: int):
        self.n = self.left = 0
        self.ready = collections.deque()
        self.tenant = np.zeros(cap, np.int16)
        self.off = np.zeros(cap, np.int64)
        self.size = np.zeros(cap, np.int32)
        self.state = np.zeros(cap, np.int8)
        self.done = np.full(cap, np.nan)
        self.ans = np.full((cap, max_rows), -1, np.int16)

    def add(self, tenant: int, off: int, size: int) -> int:
        """Log a request; its index."""
        if self.n == len(self.tenant):
            for f in ("tenant", "off", "size", "state", "done", "ans"):
                a = getattr(self, f)
                grown = np.full((2 * len(a), *a.shape[1:]),
                                np.nan if f == "done" else
                                (-1 if f == "ans" else 0), a.dtype)
                grown[:len(a)] = a
                setattr(self, f, grown)
        k, self.n = self.n, self.n + 1
        self.left += 1
        self.tenant[k], self.off[k], self.size[k] = tenant, off, size
        return k

    def watch(self, k: int, fut) -> None:
        """Stamp request ``k``'s time when ``fut`` resolves, and queue it."""
        put = self.ready.append
        fut.add_done_callback(
            lambda f: put((k, time.perf_counter(), f)))

    def take(self):
        """The next resolved request, recorded: its index, or ``None``
        when none has resolved."""
        if not self.ready:
            return None
        k, t, fut = self.ready.popleft()
        self.done[k] = t
        exc = fut.exception()
        if exc is None:
            res = fut.result()
            self.ans[k, :len(res)] = res
            self.state[k] = ANSWERED
        else:
            self.state[k] = FAILED
        self.left -= 1
        return k

    def close(self) -> None:
        """Record every request that has resolved."""
        while self.take() is not None:
            pass


def spec_of(api, model: dict):
    """The program's model specification of a configuration's model: every
    key of the entry that ``api.TMSpec`` has as a field."""
    fields = {f.name for f in dataclasses.fields(api.TMSpec)}
    return api.TMSpec.from_dict({k: v for k, v in model.items()
                                 if k in fields})


def check_geometry(engine, want: dict) -> None:
    """The engine has every geometry key the configuration states: L, R,
    H and W always, the patch slots P where stated."""
    got = {"L": engine.L, "R": engine.R, "H": engine.H,
           "W": engine.tile.packed_words()}
    if "P" in want:
        got["P"] = engine.P
    for k, v in got.items():
        if want[k] != v:
            raise RuntimeError(f"engine {k}={v}, the configuration states "
                               f"{want[k]}")


class Driver:
    """What every driver has: the cell's configuration, traffic, seeds and
    device, the tracer of a traced run and the counters it reports."""

    def __init__(self, cell):
        self.cell = cell
        self.cfg, self.traffic = cell.config, cell.traffic
        self.ref = cell.ref
        self.dev = torch.device(cell.device)
        ss = np.random.SeedSequence([int(cell.seed)])
        self.seeds = [int(s) for s in ss.generate_state(8)]
        self.counters: dict = {}
        self.phases: dict = {}       # seconds of each set-up phase
        self._t = time.perf_counter()

    def begin(self, t_start: float) -> None:
        """Open the set-up's phases: the process so far (imports, the
        card) is the first."""
        self._t = t_start
        self.phase("imports and card")

    def phase(self, name: str) -> None:
        """Close the set-up phase ``name``: its seconds since the last."""
        self.sync()
        t = time.perf_counter()
        self.phases[name] = t - self._t
        self._t = t

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class _Train(Driver):
    """Shared set-up and judgement of the training drivers.  ``EARLY``:
    whether set-up drives the check steps of phase 0 (the window's call
    at the window's shapes from the initial program)."""

    EARLY = True

    def setup(self, api) -> None:
        (self.name, self.model), = self.cfg["models"].items()
        task = self.cfg["data"][self.name]
        self.x, self.y = data.make_bool_dataset(
            task, self.cfg["train_rows"], self.seeds[0])
        self.x = data.shaped(task, self.x)
        self.phase("data")
        eng_cfg = self.cfg["engine"]
        self.spec = spec_of(api, self.model)
        self.engine = api.compile(
            api.tile_for(self.spec), device=self.dev,
            skip=eng_cfg["skip"], ta_prng=eng_cfg["ta_prng"],
            autotune=eng_cfg["autotune"],
            autotune_cache=self.cell.cache_dir / "autotune.json")
        check_geometry(self.engine, eng_cfg)
        self.prng_seed = self.seeds[1] & 0x7FFFFFFF
        self.tm = api.TM(self.spec, engine=self.engine, seed=self.prng_seed)
        self.ta0, self.w0 = data.initial_program(
            self.model, np.random.default_rng(self.seeds[2]), self.ref)
        self.prog0 = self.engine.lower(self.spec, ta=self.ta0,
                                       weights=self.w0)
        self.prng0 = self.tm.prng
        self.phase("engine and program")
        self.snaps = [[], []]          # the check steps of each phase
        if self.EARLY:
            self.reset()
            self.check_steps()
            self.phase("check steps")
        self.reset()
        self.warm()
        self.phase("warm-up")

    def reset(self) -> None:
        self.tm.program, self.tm.prng = self.prog0, self.prng0

    def _state(self) -> dict:
        p = self.tm.program
        return {"ta": p.ta.cpu(), "inc": p.inc.cpu(),
                "weights": p.weights.cpu(),
                "prng": [t.cpu() for t in self.tm.prng.leaves()]}

    def snapshot(self, stats: dict, phase: int = 0) -> None:
        self.snaps[phase].append(dict(self._state(), stats=stats))

    def check_late(self) -> None:
        """After the window: ``check_steps`` more steps, by the window's
        own call on new rows, from the state the window left (a trained
        one, in which clauses fire and weights move)."""
        self.start2 = self._state()
        self.check_steps(phase=1)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.tm = self.engine = self.prog0 = self.prng0 = None
        self.slots = None

    def check_rows(self, k: int):
        raise NotImplementedError

    def judge(self, drop: int = 0, fault=None) -> dict:
        """The reference follows the check steps from the benchmark's
        initial program and the PRNG's seed; every leaf and stat the
        program gave after each step is compared with it.  ``drop``: the
        control (the reference one bit narrower in the program's place);
        ``fault``: a fault planted in the reference put in the program's
        place (``unchanged``, ``half_batch``)."""
        want, got = [], []
        for phase in (0, 1):
            want += [self._as_snap(s)
                     for s in self._ref_states(self.dev, 0, None, phase)]
            if drop or fault:
                got += [self._as_snap(s) for s in
                        self._ref_states(self.dev, drop, fault, phase)]
            else:
                got += [self._as_snap(s) for s in self.snaps[phase]]
        out = dict.fromkeys(("ta_mismatch", "include_mismatch",
                             "weight_mismatch", "prng_mismatch",
                             "stats_mismatch"), 0)
        for w, g in zip(want, got):
            out["ta_mismatch"] += int((w["ta"] != g["ta"]).sum())
            out["include_mismatch"] += int((w["include"] != g["include"]).sum())
            out["weight_mismatch"] += int((w["weights"] != g["weights"]).sum())
            out["prng_mismatch"] += sum(int((a != b).sum())
                                        for a, b in zip(w["prng"], g["prng"]))
            out["stats_mismatch"] += sum(abs(w["stats"][k] - g["stats"][k])
                                         for k in w["stats"])
        return out

    def _ref_states(self, dev, drop: int, fault, phase: int = 0):
        """The reference's states after each check step of ``phase``:
        phase 0 from the benchmark's initial program and the PRNG's seed,
        phase 1 from the program's own state at the window's close (the
        reference cannot follow the window's thousands of steps)."""
        ref = self.ref
        m = ref.model_at(self.model, drop)
        eng = self.cfg["engine"]
        if phase == 0:
            ta0, w0 = self.ta0, self.w0
            prng = ref.Cluster.create(self.prng_seed + 1, eng["prng_lanes"],
                                      m["lfsr_bits"], dev)
        else:
            start = self._as_snap(dict(self.start2, stats={}))
            ta0, w0 = start["ta"], start["weights"]
            lanes, master, cycles = start["prng"]
            prng = ref.Cluster(lanes.to(dev), int(master), int(cycles))
        ta = ref.held_ta(m, ta0, dev)
        w = (ref.weight_matrix(m, w0, dev)
             if ref.has_weights(m) else None)
        first = phase * self.traffic["check_steps"]
        states = []
        for k in range(first, first + len(self.snaps[phase])):
            ta, w, stats = _ref_step(ref, m, eng, ta, w, prng,
                                     *self.check_rows(k), fault)
            states.append({"ta": ta, "weights": w, "stats": stats,
                           "prng": [prng.lanes, prng.master, prng.cycles],
                           "model": m})
        return states

    def _as_snap(self, s: dict) -> dict:
        """A snapshot in the model's layout: TA [rows, 2f], include bits
        [rows, 2f], weights [classes, clauses] (or nothing), PRNG words,
        stats; from the program's padded leaves or from the reference."""
        m = self.model
        rows, f = self.ref.rows_of(m), self.ref.bool_features(m)
        if "inc" in s:                                   # the program's
            half = self.cfg["engine"]["L"] // 2
            ta = s["ta"].to(torch.int64)[:rows]
            ta = torch.cat([ta[:, :f], ta[:, half:half + f]], dim=1)
            shifts = torch.arange(32, dtype=torch.int32)
            bits = ((s["inc"][:rows, :, None] >> shifts) & 1).reshape(
                rows, -1).to(torch.int64)
            inc = torch.cat([bits[:, :f], bits[:, half:half + f]], dim=1)
            w = (s["weights"][:m["classes"], :m["clauses"]].to(torch.int64)
                 if self.ref.has_weights(m) else torch.zeros(1))
            lanes, master, cycles = s["prng"]
            prng = [lanes.to(torch.int64), torch.tensor([int(master)]),
                    torch.tensor([int(cycles)])]
            stats = {k: int(v) for k, v in s["stats"].items()}
            return {"ta": ta, "include": inc, "weights": w, "prng": prng,
                    "stats": stats}
        mm = s["model"]
        ta = s["ta"].cpu()
        inc = (ta >= (1 << (mm["ta_bits"] - 1))).to(torch.int64)
        w = (s["weights"].cpu().to(torch.int64)
             if self.ref.has_weights(m) else torch.zeros(1))
        lanes, master, cycles = s["prng"]
        prng = [lanes.cpu(), torch.tensor([master]), torch.tensor([cycles])]
        return {"ta": ta, "include": inc, "weights": w, "prng": prng,
                "stats": {k: int(v) for k, v in s["stats"].items()}}


def _ref_step(ref, m, eng, ta, w, prng, xb, yb, fault):
    """One step of the reference module ``ref``, with ``fault``
    (``unchanged``, ``half_batch``) planted in it."""
    xb = torch.as_tensor(xb, device=ta.device)
    yb = torch.as_tensor(yb, device=ta.device)
    if fault == "half_batch" and len(xb) > 1:
        h = len(xb) // 2
        xb, yb = torch.cat([xb[:h], xb[:h]]), torch.cat([yb[:h], yb[:h]])
    new_ta, new_w, stats = ref.train_step(m, eng, ta, w, prng, xb, yb)
    if fault == "unchanged":
        return ta, w, stats
    return new_ta, new_w, stats


REC_KEYS = ("selected_clauses", "active_groups", "total_groups", "train_acc")


class Fit(_Train):
    """``TM.fit`` passes of ``epochs`` epochs of ``batch`` rows, each from
    one of ``programs`` initial programs (a traffic key; without it, 1),
    in turn.  A program comes with its PRNG seed and its epoch order, all
    drawn from the run's seed; the first is the one every training
    driver draws.  A pass's work is set by the trajectory it trains
    (the clause groups that get feedback), which every part of the seed
    moves, so a run that trains several averages that out of its rate.
    The check is one more epoch after the window, through the window's
    own epoch graph (the staged rows and the plan's shape key it), from
    the first program with its first epoch's order; the reference
    follows every step of it.  Every pass's records must equal those of
    the first pass from the same program, and each first epoch of the
    first program the check's."""

    EARLY = False

    def setup(self, api) -> None:
        self.api = api
        super().setup(api)

    def plan(self) -> np.ndarray:
        """The first epoch's batches [steps, batch] of the first
        program's passes: one ``rng.permutation`` of the rows a epoch, as
        ``TM.fit`` states."""
        b = self.traffic["batch"]
        n = len(self.x) - len(self.x) % b
        rng = np.random.default_rng(self.seeds[4])
        return rng.permutation(len(self.x))[:n].reshape(-1, b)

    def one_pass(self, epochs=None, k: int = 0) -> list:
        """A pass from program ``k``'s initial state."""
        prog, prng, order = self.slots[k]
        self.tm.program, self.tm.prng = prog, prng
        return self.tm.fit(self.x, self.y,
                           epochs=epochs or self.traffic["epochs"],
                           batch=self.traffic["batch"],
                           rng=np.random.default_rng(order))

    def warm(self) -> None:
        """The window's programs, then a pass of the first, which builds
        the epoch graph that they all replay (one shape)."""
        self.slots = [(self.prog0, self.prng0, self.seeds[4])]
        more = self.traffic.get("programs", 1) - 1
        ss = np.random.SeedSequence([int(self.cell.seed), 1])
        for prng_seed, prog_seed, order in ss.generate_state(
                3 * more).reshape(-1, 3):
            ta, w = data.initial_program(
                self.model, np.random.default_rng(int(prog_seed)), self.ref)
            prng = self.api.TM(self.spec, engine=self.engine,
                               seed=int(prng_seed) & 0x7FFFFFFF).prng
            self.slots.append((self.engine.lower(self.spec, ta=ta,
                                                 weights=w),
                               prng, int(order)))
        self.one_pass()

    def check_late(self) -> None:
        rec, = self.one_pass(epochs=1)
        self.check_rec = rec
        self.snapshot({"selected": rec["selected_clauses"],
                       "active_groups": rec["active_groups"],
                       "total_groups": rec["total_groups"],
                       "correct": round(rec["train_acc"] * self.plan().size)},
                      phase=1)

    def _ref_states(self, dev, drop: int, fault, phase: int = 0):
        """The reference's state after the check epoch (phase 1), from the
        benchmark's initial program and the PRNG's seed, with the epoch's
        stats summed; phase 0 has no steps."""
        if phase == 0:
            return []
        ref = self.ref
        m = ref.model_at(self.model, drop)
        eng = self.cfg["engine"]
        prng = ref.Cluster.create(self.prng_seed + 1, eng["prng_lanes"],
                                  m["lfsr_bits"], dev)
        ta = ref.held_ta(m, self.ta0, dev)
        w = (ref.weight_matrix(m, self.w0, dev)
             if ref.has_weights(m) else None)
        x = torch.as_tensor(self.x, device=dev)
        y = torch.as_tensor(self.y, device=dev)
        plan = torch.as_tensor(self.plan(), device=dev)
        tot = {}
        for rows in plan:
            ta, w, stats = _ref_step(ref, m, eng, ta, w, prng, x[rows],
                                     y[rows], fault)
            for k, v in stats.items():
                tot[k] = tot.get(k, 0) + v
        return [{"ta": ta, "weights": w, "stats": tot,
                 "prng": [prng.lanes, prng.master, prng.cycles], "model": m}]

    def judge(self, drop: int = 0, fault=None) -> dict:
        """The state and stats after the check epoch against the
        reference's; and ``pass_mismatch``: the window's records that
        differ from those of the first pass from the same program, or, of
        the first program, whose first epoch differs from the check
        epoch's (the program's own, whatever stands in its place for the
        state)."""
        out = super().judge(drop, fault)
        firsts, bad = {}, 0
        for k, recs in self.pass_recs:
            first = firsts.setdefault(k, recs)
            bad += sum(r[key] != f[key] for r, f in zip(recs, first)
                       for key in REC_KEYS)
            if k == 0:
                bad += sum(recs[0][key] != self.check_rec[key]
                           for key in REC_KEYS)
        out["pass_mismatch"] = int(bad)
        return out

    def window(self, seconds: float, tracer: Tracer | None) -> dict:
        b, epochs = self.traffic["batch"], self.traffic["epochs"]
        steps_pass = epochs * (len(self.x) // b)
        self.pass_recs = []
        t0 = time.perf_counter()
        while True:
            k = len(self.pass_recs) % len(self.slots)
            self.pass_recs.append((k, self.one_pass(k=k)))
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        t = time.perf_counter() - t0
        passes = len(self.pass_recs)
        recs = [r for _, p in self.pass_recs for r in p]
        steps = passes * steps_pass
        self.counters.update(
            window_s=t, steps=steps, rows=steps * b, batch=b, passes=passes,
            programs=len(self.slots),
            selected=sum(r["selected_clauses"] for r in recs),
            active_groups=sum(r["active_groups"] for r in recs),
            total_groups=sum(r["total_groups"] for r in recs))
        self.check_late()
        if tracer is not None:           # one more pass, profiled
            with tracer.stretch():
                hist = self.one_pass()
            tracer.note(steps=steps_pass, selected=sum(
                r["selected_clauses"] for r in hist))
        return {self.traffic.get("rate", "train_rows_per_s"): steps * b / t}


class PartialFit(_Train):
    """``TM.partial_fit`` on ``batch`` rows at a time, in passes of
    ``pass_rows`` rows of the training set from the initial program."""

    def check_rows(self, k: int):
        b = self.traffic["batch"]
        return self.x[k * b:(k + 1) * b], self.y[k * b:(k + 1) * b]

    def check_steps(self, phase: int = 0) -> None:
        n = self.traffic["check_steps"]
        for k in range(phase * n, (phase + 1) * n):
            stats = self.tm.partial_fit(*self.check_rows(k))
            self.snapshot({key: int(stats[key]) for key in
                           ("selected", "active_groups", "total_groups",
                            "correct")}, phase)

    def warm(self) -> None:
        """Warm the step: a few steps at the window's batch shape."""
        for k in range(8):
            self.tm.partial_fit(*self.check_rows(k))

    def window(self, seconds: float, tracer: Tracer | None) -> dict:
        b, n = self.traffic["batch"], self.traffic["pass_rows"] // \
            self.traffic["batch"]
        fit = self.tm.partial_fit
        x, y = self.x, self.y
        keys = ("selected", "active_groups", "total_groups")
        stats, sums, steps = [], [], 0
        t0 = time.perf_counter()
        done = False
        while not done:
            self.reset()
            for k in range(n):
                st = fit(x[k * b:(k + 1) * b], y[k * b:(k + 1) * b])
                stats.extend(st[key] for key in keys)
                steps += 1
                if steps % STATS_CHUNK == 0:
                    # one sum a chunk: the harness keeps few objects alive
                    sums.append(torch.stack(stats).view(-1, 3).sum(dim=0))
                    stats = []
                if time.perf_counter() - t0 >= seconds:
                    done = True
                    break
        self.sync()
        t = time.perf_counter() - t0
        if stats:
            sums.append(torch.stack(stats).view(-1, 3).sum(dim=0))
        tot = dict(zip(keys, torch.stack(sums).sum(dim=0).tolist()))
        self.counters.update(window_s=t, steps=steps, rows=steps * b,
                             batch=b, **tot)
        self.check_late()
        if tracer is not None:           # the first steps of a pass, profiled
            k_n = self.traffic["trace_steps"]
            self.reset()
            with tracer.stretch():
                st = [fit(x[k * b:(k + 1) * b], y[k * b:(k + 1) * b])
                      for k in range(k_n)]
            tracer.note(steps=k_n, selected=int(
                torch.stack([s["selected"] for s in st]).sum()))
        return {self.traffic.get("rate", "train_rows_per_s"): steps * b / t}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class Serve(Driver):
    """``api.serve`` of the configuration's roster, in thread mode."""

    def setup(self, api) -> None:
        from repro_torch.launch.scheduler import SchedulerConfig
        from repro_torch.launch import scheduler as sched_mod
        self.names = list(self.cfg["models"])
        slas = {"gold": sched_mod.GOLD, "standard": sched_mod.STANDARD,
                "batch": sched_mod.BATCH}
        tr = self.traffic
        self.specs = {n: spec_of(api, m) for n, m in self.cfg["models"].items()}
        pool = tr["pool_rows"]
        rng = np.random.default_rng(self.seeds[0])
        self.pools, self.progs = {}, {}
        for i, name in enumerate(self.names):
            task = self.cfg["data"][name]
            self.pools[name] = data.shaped(task, data.make_bool_dataset(
                task, pool, self.seeds[1] + i)[0])
            self.progs[name] = data.firing_program(
                self.cfg["models"][name], task, rng, self.ref)
        self.phase("data and programs")
        eng = self.cfg["engine"]
        sla_of = {n: slas[tr["sla"].get(n, "standard")] for n in self.names}
        self.sched = api.serve(
            self.specs, batch_slot=eng["batch_slot"], device=self.dev,
            config=SchedulerConfig(**tr.get("scheduler", {})), slas=sla_of,
            skip=eng["skip"], ta_prng=eng["ta_prng"],
            autotune=eng["autotune"],
            autotune_cache=self.cell.cache_dir / "autotune.json",
            seed=self.seeds[2] & 0x7FFFFFFF)
        self.server = self.sched.server
        self.engine = self.server.engine
        check_geometry(self.engine, eng)
        for name in self.names:
            ta, w = self.progs[name]
            self.sched.register(name, self.specs[name],
                                program=self.engine.lower(self.specs[name],
                                                          ta=ta, weights=w),
                                sla=sla_of[name])
        # no scheduler thread: the client's one thread calls ``step``, so
        # no second thread takes the interpreter from it
        self.phase("stack")
        self.warm()
        self.phase("warm-up")

    def warm(self) -> None:
        """Every tenant at each request size class through the scheduler,
        waited for."""
        r = self.traffic["rows"]
        sizes = sorted({r["min"], r["max"]} | ({1} if r["one_p"] else set()))
        for _ in range(3):
            futs = [self.sched.submit(n, self.pools[n][:s])
                    for s in sizes for n in self.names]
            self.sched.drain()
            for f in futs:
                f.result(timeout=0)

    def release(self) -> None:
        self.sched = self.server = self.engine = None

    def window(self, seconds: float, tracer: Tracer | None) -> dict:
        if tracer is not None:
            self._wrap(tracer)
        before = self.sched.stats()
        out = self._closed(seconds, tracer)
        after = self.sched.stats()
        for k in ("completed", "launches", "rejected", "failed", "submitted"):
            self.counters[k] = after[k] - before[k]
        for k in ("stacked_launches", "coalesced_requests", "cold_requests"):
            self.counters[k] = after["server"][k] - before["server"][k]
        return out

    def _trace_window(self, seconds: float):
        """(start, length) of the profiled stretch: the window's last
        ``trace_seconds``, so that reading the profile delays nothing of
        the window."""
        trd = min(self.traffic.get("trace_seconds", 2.0), 0.6 * seconds)
        return seconds - trd, trd

    def _closed(self, seconds: float, tracer) -> dict:
        rng = np.random.default_rng(self.seeds[3])
        tr = self.traffic
        r = tr["rows"]
        names, pools = self.names, self.pools
        submit, step = self.sched.submit, self.sched.step
        pool = tr["pool_rows"]
        per = tr["outstanding"]
        log = self.log = AnswerLog(
            int(seconds * CLOSED_GUESS_PER_S) + per * len(names), r["max"])

        def send(t):
            s = 1 if rng.random() < r["one_p"] else int(
                rng.integers(r["min"], r["max"] + 1))
            off = int(rng.integers(0, pool - s + 1))
            k = log.add(t, off, s)
            log.watch(k, submit(names[t], pools[names[t]][off:off + s]))

        t0 = time.perf_counter()
        t_end = t0 + seconds
        for t in range(len(names)):
            for _ in range(per):
                send(t)
        tr0, _ = self._trace_window(seconds)
        t_trace = t0 + tr0 if tracer is not None else t_end
        # the process's CPU time each second beside its rows: a host-bound
        # loop that keeps its core busy shows here how its speed drifts
        cpu, t_mark = [time.process_time()], t0 + 1.0
        while True:           # the client: a cycle, its answers, resends
            now = time.perf_counter()
            if now >= t_mark:
                cpu.append(time.process_time())
                t_mark += 1.0
            if now >= t_trace and t_trace < t_end:
                tracer.start()
                n_tr, t_trace = log.n, t_end
            if now >= t_end:
                break
            step(force=False)
            while (k := log.take()) is not None:
                if time.perf_counter() < t_end:
                    send(int(log.tenant[k]))
        if tracer is not None:
            tracer.stop()
            tracer.note(requests=log.n - n_tr)
        self.sched.drain()               # answers still due, for judging
        log.close()
        n = log.n
        served = (log.state[:n] == ANSWERED) & (log.done[:n] < t_end)
        rows = log.size[:n][served]
        when = log.done[:n][served] - t0
        per_s = np.histogram(when, bins=np.arange(math.ceil(seconds) + 1),
                             weights=rows)[0]
        by = {name: int(rows[log.tenant[:n][served] == t].sum())
              for t, name in enumerate(names)}
        self.counters.update(window_s=seconds, requests=int(served.sum()),
                             rows=int(rows.sum()), samples=int(served.sum()),
                             window_rows_by_tenant=by,
                             rows_each_second=per_s.astype(int).tolist(),
                             cpu_ms_each_second=np.round(
                                 np.diff(cpu) * 1e3).astype(int).tolist())
        return {"served_rows_per_s": float(rows.sum()) / seconds}

    def _wrap(self, tracer: Tracer) -> None:
        """Spans around the calls into each layer, put on the instances of
        a traced run, and the host time of every ``DTMEngine.encode``."""
        enc = {"calls": 0, "s": 0.0}
        self.counters["encode"] = enc
        engine, server, sched = self.engine, self.server, self.sched
        encode = engine.encode

        def timed_encode(spec, x):
            t = time.perf_counter()
            with tracer.span("server.encode"):
                out = encode(spec, x)
            enc["s"] += time.perf_counter() - t
            enc["calls"] += 1
            return out
        engine.encode = timed_encode
        tracer.wrap(server, "flush_async", "server.flush_async")
        tracer.wrap(server, "collect", "server.collect")
        tracer.wrap(sched, "_launch", "scheduler.launch")
        tracer.wrap(sched, "submit", "client.submit")

    def judge(self, drop: int = 0, fault=None) -> dict:
        """Every answer of the window against the reference's answer for
        the same rows; a due answer that never came is missing."""
        dev = self.dev
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        want = {}
        for name in self.names:
            m = self.ref.model_at(self.cfg["models"][name], drop)
            ta, w = self.progs[name]
            want[name] = self.ref.predict(m, ta, w, self.pools[name],
                                          dev).cpu()
        log, n = self.log, self.log.n
        state, size = log.state[:n], log.size[:n]
        ans = log.ans[:n].astype(np.int64)
        cols = np.arange(ans.shape[1])
        real = cols[None, :] < size[:, None]
        wrong = 0
        for t, name in enumerate(self.names):
            k = np.flatnonzero((state == ANSWERED) & (log.tenant[:n] == t))
            if not len(k):
                continue
            rows = np.minimum(log.off[:n][k, None] + cols[None, :],
                              len(want[name]) - 1)
            ref_ans = want[name].numpy()[rows]
            got = ans[k]
            if fault == "altered":
                got = (got + 1) % self.cfg["models"][name]["classes"]
            wrong += int(((got != ref_ans) & real[k]).sum())
        missing = int((state == PENDING).sum())
        return {"wrong_answers": wrong, "missing_answers": missing}


DRIVERS = {"fit": Fit, "partial_fit": PartialFit, "serve": Serve}
