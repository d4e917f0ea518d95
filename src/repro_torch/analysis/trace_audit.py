"""Trace-contract audit of the port (``audit`` command): the runtime half
of "reconfiguration without resynthesis", machine-checked.

The port's counterpart of ``repro/analysis/trace_audit.py``.  It runs the
JAX audit's scenario (the five ``serve_tm.demo_specs`` kinds through the
session, program-bank and scheduler paths) on one engine and asserts:

* every stage keeps at most one CUDA graph alive (``cache_report()``
  counts the graphs per stage; the scenario uses one shape a stage), as
  the JAX audit asserts a jit cache size of at most 1;
* ``session.dispatches == epochs`` (one round trip an epoch);
* on the card, no host synchronisation inside the guarded sections: the
  epochs run under ``fit_epochs(sync_guard=True)`` and the inference
  replays and flushes under ``torch.cuda.set_sync_debug_mode("error")``
  (each graph captured by a first call before the guard);

then diffs the ``cache_report()["path_per_stage"]`` dispatch tables
against the port's committed golden, ``baseline.json`` beside this
module, keyed by leg ``device|force|skip|prng|autotune`` (the engine's
arguments).  A change of which kernel a stage dispatches to must update
the golden explicitly (``--update``), never silently.

:func:`jax_equivalent` maps a CPU leg's entry onto the JAX golden
(``ANALYSIS_baseline.json``, recorded on JAX's ``ref`` backend, where
every clause path other than ``packed_vpu`` and ``mxu_popcount`` reads
``ref``).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Sequence

__all__ = ["AuditError", "AuditReport", "leg_key", "run_audit",
           "compare_to_golden", "jax_equivalent", "default_baseline_path",
           "main"]

EPOCHS = 2
STAGE_BATCH = 64        # staged rows per tenant (fit batch 16 -> 4 steps)
SERVE_BATCH = 8         # scheduler request batch (= batch_slot)
JAX_KEPT = ("packed_vpu", "mxu_popcount")   # clause paths JAX's ref keeps
PORT_ONLY = ("conv_ta",)   # kernels of stages that JAX runs as jnp


class AuditError(AssertionError):
    """A trace-contract invariant failed or the golden diverged."""


@dataclasses.dataclass
class AuditReport:
    leg: str
    session_paths: Dict[str, str]
    serving_paths: Dict[str, str]
    session_caches: Dict[str, int]
    serving_caches: Dict[str, int]

    def golden_entry(self) -> dict:
        return {"session_paths": dict(sorted(self.session_paths.items())),
                "serving_paths": dict(sorted(self.serving_paths.items()))}


def default_baseline_path() -> pathlib.Path:
    """The port's golden: ``baseline.json`` beside this module."""
    return pathlib.Path(__file__).resolve().parent / "baseline.json"


def leg_key(engine) -> str:
    """The leg an engine runs as: every argument that can move a dispatch
    decision."""
    return (f"{engine.device.type}|force={engine.kernel_path or 'auto'}"
            f"|skip={int(engine.skip)}|prng={engine.ta_prng}"
            f"|autotune={engine.autotune}")


def jax_equivalent(entry: dict) -> dict:
    """A golden entry as JAX's ``ref`` backend records it: clause paths
    other than ``packed_vpu`` and ``mxu_popcount`` read ``ref``; the TA
    (``*_ta``) and PRNG (``*_prng``) entries are unchanged; entries of
    :data:`PORT_ONLY` kernels (the conv TA stage's) are dropped."""
    def rename(stage, path):
        if stage.endswith(("_ta", "_prng")) or path in JAX_KEPT:
            return path
        return "ref"
    return {table: {s: rename(s, p) for s, p in paths.items()
                    if p not in PORT_ONLY}
            for table, paths in entry.items()}


def _demo_labels(spec, n: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    if spec.kind == "regression":
        return rng.random(n).astype(np.float32)
    classes = spec.tm_config().classes
    return rng.integers(0, max(classes, 1), n).astype(np.int32)


def _check_caches(caches: Dict[str, int], where: str,
                  errors: List[str]) -> None:
    for stage, size in caches.items():
        if isinstance(size, int) and size > 1:
            errors.append(f"{where}: stage {stage} has {size} CUDA graphs "
                          "alive (> 1: something recaptured)")


def run_audit(device=None, kernel_path: Optional[str] = None,
              skip: bool = True, ta_prng: str = "inkernel",
              autotune: str = "seed", autotune_cache=None,
              update: bool = False,
              baseline: Optional[pathlib.Path] = None,
              epochs: int = EPOCHS) -> AuditReport:
    """Run the audit on ``device`` (the card unless the caller asks for the
    CPU; raises without one) with the engine arguments given; raises
    :class:`AuditError` on any violation.  ``update=True`` rewrites this
    leg's entry in the golden instead of diffing against it."""
    import torch

    from repro_torch import api
    from repro_torch.core import threefry
    from repro_torch.core.device import resolve_device
    from repro_torch.core.dtm import _sync_guard
    from repro_torch.launch.scheduler import SchedulerConfig
    from repro_torch.launch.serve_tm import demo_batch, demo_specs

    device = resolve_device(device)
    knobs = dict(device=device, kernel_path=kernel_path, skip=skip,
                 ta_prng=ta_prng, autotune=autotune,
                 autotune_cache=autotune_cache)
    specs = demo_specs(small=True)
    names = sorted(specs)
    errors: List[str] = []

    # ---- set-up: compile, lower, stage (outside the guards) -------------
    engine = api.compile(api.tile_for(*specs.values()), **knobs)
    dev = engine.device
    sessions, infer_lits, bank_lits = {}, {}, {}
    for i, name in enumerate(names):
        spec = specs[name]
        prog = engine.lower(spec, threefry.key(i, dev))
        x = demo_batch(spec, STAGE_BATCH, seed=10 + i)
        y = _demo_labels(spec, STAGE_BATCH, seed=20 + i)
        s = engine.bind(prog, x, y, spec=spec, seed=i)
        sessions[name] = s
        infer_lits[name] = s._lits[:32].clone()
        bank_lits[name] = s._lits[:SERVE_BATCH].clone()

    # ---- session path: epochs (guarded inside fit_epochs), inference ----
    for name in names:
        s = sessions[name]
        s.fit_epochs(epochs, batch=16, sync_guard=True)
        if s.dispatches != epochs:
            errors.append(f"session[{name}]: {s.dispatches} dispatches for "
                          f"{epochs} epochs (contract: one an epoch)")

    flat = [n for n in names if specs[n].kind != "conv"]
    conv = [n for n in names if specs[n].kind == "conv"]
    bank = api.stack([sessions[n].program for n in flat], engine)
    cbank = (api.stack([sessions[n].program for n in conv], engine,
                       conv=True) if conv else None)

    def serve_session():
        for name in names:
            engine.served_infer(specs[name], sessions[name].program,
                                infer_lits[name])
        bank.infer(torch.stack([bank_lits[n] for n in flat]))
        if cbank is not None:
            cbank.infer(torch.stack([bank_lits[n] for n in conv]))

    serve_session()                 # the first calls capture
    with _sync_guard(dev, True):
        serve_session()             # replays: launches only

    session_report = engine.cache_report()
    _check_caches(session_report, "session-engine", errors)

    # ---- scheduler path: its own serve() stack, driven inline -----------
    sched = api.serve(dict(specs), batch_slot=SERVE_BATCH, device=device,
                      config=SchedulerConfig(max_wait_s=0.0,
                                             pipeline_depth=2),
                      **{k: v for k, v in knobs.items() if k != "device"})
    serve_eng = sched.server.engine
    req_lits = {r: {n: serve_eng.encode(specs[n], demo_batch(
        specs[n], SERVE_BATCH, seed=seed)) for n in names}
        for r, seed in enumerate((30, 40))}
    train_reqs = {}
    for i, n in enumerate(names):
        x = demo_batch(specs[n], SERVE_BATCH, seed=50 + i)
        y = _demo_labels(specs[n], SERVE_BATCH, 60 + i)
        train_reqs[n] = (serve_eng.encode(specs[n], x),
                         specs[n].encode_labels(y))
    for r in (0, 1):                 # the second round must not recapture
        futs = [(n, sched.submit(n, req_lits[r][n], encoded=True))
                for n in names]
        sched.drain()
        for n, f in futs:
            out = f.result(timeout=120)
            if out.shape[0] != SERVE_BATCH:
                errors.append(f"scheduler[{n}]: bad result shape "
                              f"{tuple(out.shape)}")
    for n in names:
        sched.server.train(n, *train_reqs[n], encoded=True)

    serving_report = sched.server.stats()["cache"]
    _check_caches(serving_report, "serving-engine", errors)

    report = AuditReport(
        leg=leg_key(engine),
        session_paths=dict(session_report["path_per_stage"]),
        serving_paths=dict(serving_report["path_per_stage"]),
        session_caches={k: v for k, v in session_report.items()
                        if isinstance(v, int)},
        serving_caches={k: v for k, v in serving_report.items()
                        if isinstance(v, int)})
    if errors:
        raise AuditError("trace-contract audit failed:\n  "
                         + "\n  ".join(errors))
    compare_to_golden(report, baseline or default_baseline_path(),
                      update=update)
    return report


def compare_to_golden(report: AuditReport, path: pathlib.Path,
                      update: bool = False) -> None:
    """Diff (or, with ``update``, rewrite) this leg's golden entry."""
    path = pathlib.Path(path)
    golden = json.loads(path.read_text()) if path.exists() else {}
    if update:
        golden.setdefault("legs", {})[report.leg] = report.golden_entry()
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(golden, indent=1, sort_keys=True) + "\n")
        tmp.replace(path)
        return
    entry = golden.get("legs", {}).get(report.leg)
    if entry is None:
        raise AuditError(
            f"no golden entry for leg {report.leg!r} in {path}: run the "
            "audit with --update on this leg and commit")
    diffs = _diff(entry, report.golden_entry())
    if diffs:
        raise AuditError(
            f"dispatch tables diverged from {path.name} for leg "
            f"{report.leg!r}:\n  " + "\n  ".join(diffs)
            + "\n  (intentional? rerun with --update and commit)")


def _diff(golden: dict, fresh: dict) -> List[str]:
    out = []
    for table in sorted(set(golden) | set(fresh)):
        g, f = golden.get(table, {}), fresh.get(table, {})
        for stage in sorted(set(g) | set(f)):
            if g.get(stage) != f.get(stage):
                out.append(f"{table}.{stage}: golden={g.get(stage)!r} "
                           f"fresh={f.get(stage)!r}")
    return out


def main(argv: Sequence[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis audit",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu (the plain "
                    "versions)")
    ap.add_argument("--kernel-path", default=None)
    ap.add_argument("--skip", type=int, choices=(0, 1), default=1)
    ap.add_argument("--ta-prng", default="inkernel")
    ap.add_argument("--autotune", default="seed")
    ap.add_argument("--autotune-cache", default=None)
    ap.add_argument("--update", action="store_true",
                    help="rewrite this leg's golden entry")
    ap.add_argument("--baseline", type=pathlib.Path, default=None)
    ns = ap.parse_args(list(argv))
    try:
        report = run_audit(ns.device, ns.kernel_path, bool(ns.skip),
                           ns.ta_prng, ns.autotune, ns.autotune_cache,
                           update=ns.update, baseline=ns.baseline)
    except AuditError as e:
        print(e)
        return 1
    verb = "updated" if ns.update else "matched"
    print(f"trace audit: leg {report.leg!r} {verb} "
          f"({len(report.session_paths)} session + "
          f"{len(report.serving_paths)} serving dispatch entries, every "
          "stage <= 1 graph, dispatches == epochs)")
    return 0
