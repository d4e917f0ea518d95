"""The dispatcher's plan cache: which kernel each stage runs, per shape.

The port's counterpart of ``repro/kernels/autotune.py``.  ``select_path``
and ``select_ta_path`` (:mod:`repro_torch.kernels.ops`) consult a PLAN
for (device kind, stage, batch bucket, engine shape) before their
heuristics.  The mode is an argument (the JAX package's
``REPRO_AUTOTUNE``; engines take it as ``autotune=``):

* ``off``     — the heuristics alone;
* ``seed``    — (default) plans from the card's cost model
  (:func:`repro_torch.launch.tm_perf.packed_eval_costs` on
  :data:`repro_torch.launch.mesh.H100`): nothing is timed or written, the
  same answer on every host.  A measured plan already in the cache file
  of this device kind takes precedence;
* ``measure`` — the candidates of a stage are timed through the ops
  wrappers on the engine's device with synthetic inputs at the padded
  shape (one warm-up, then the median of :data:`MEASURE_ITERS` runs under
  CUDA events, the device held by a sleep kernel while the host enqueues
  each run, so device time; the host clock on the CPU), and the fastest
  is kept in
  memory and in the cache file, which later processes read in any mode
  but ``off``.  A candidate that fails raises: no kernel is skipped.

The cache file is an argument (the JAX package's
``REPRO_AUTOTUNE_CACHE``; engines take it as ``autotune_cache=``),
by default ``~/.cache/repro_torch/autotune_<kind>.json``, where the kind
is ``torch.cuda.get_device_name()`` with spaces as ``_``, or ``cpu``.
It is written to a temporary path and moved into place; on a read-only
home the plans stay in memory.  Keys are the JAX package's
(``stage/b<bucket>/L..xR..xH..``, next-power-of-2 batch buckets).

A plan is ``{"path", "tiles", "source"}``, and a measured one also holds
``us`` (the path's median µs at its own geometry), ``candidates_us`` (µs
by path, then by launch geometry, :func:`geometry_key`) and ``rejected``
(the candidates :mod:`repro_torch.analysis.kernel_check` refused, with
why; they are not timed).  ``tiles`` is the launch geometry of the plan's
path: the one its wrapper computes for the bucket under ``seed``, the
fastest one timed under ``measure``; :func:`planned_tiles` returns it.

``measure`` sweeps launch geometries as the JAX package sweeps its Pallas
tile sets (``EVAL_TILES``): the edge, tile and fused wrappers take a
``geometry`` override, and :func:`geometries` gives each eval stage's
packed leg three (the wrapper's own and two around it: ``warps`` of the
tile kernel, ``lanes`` and ``warps`` of the edge kernel) and the fused
train leg the cluster sizes that even out its clause tiles where the
wrapper's leaves a block two (R = 4224); every other leg runs its own
geometry.  As in the JAX package, the engine's launches do not read
``tiles``: they launch with the wrapper's own geometry.  So the path is
chosen by each path's time at its own geometry, and the sweep's best
geometry of that path is only recorded, as ``tiles``.

Plans are resolved before a CUDA graph's warm-up (the engine's
``resolve_plans``); a lookup that would time while the current stream is
capturing raises.  The plan state is shared by every engine of the
process and guarded by a lock.
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

MODES = ("off", "seed", "measure")

# dispatch stages with plans: inference clause eval, training front half,
# TA update (the SKIP dimension).
STAGES = ("eval", "train", "ta")

MEASURE_ITERS = 5
SLEEP_CYCLES = 1_000_000     # ~0.5 ms at 1.98 GHz: longer than a host enqueue

# the plan state, per cache file: plans read from the file (absent = not
# read yet) and plans measured in this process
_LOCK = threading.RLock()
_DISK: Dict[str, dict] = {}
_MEM: Dict[str, dict] = {}


def check_mode(mode: str) -> str:
    """``mode`` if it is one of :data:`MODES`; raises ``ValueError``."""
    if mode not in MODES:
        raise ValueError(f"autotune mode {mode!r} not recognised; use one "
                         f"of {MODES}")
    return mode


def device_kind(device=None) -> str:
    """The cache namespace of a device: its CUDA name with spaces as
    ``_``, or ``cpu``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev).replace(" ", "_")


def cache_path(device=None, cache=None) -> pathlib.Path:
    """The cache file: ``cache`` when given, else the default under the
    home directory for this device kind."""
    if cache is not None:
        return pathlib.Path(cache)
    return (pathlib.Path.home() / ".cache" / "repro_torch"
            / f"autotune_{device_kind(device)}.json")


def clear_cache() -> None:
    """Drop the in-process plan state (the files stay as they are)."""
    with _LOCK:
        _DISK.clear()
        _MEM.clear()


def _bucket(batch) -> int:
    """Next-power-of-2 batch bucket; 0 = unknown (throughput default)."""
    if batch is None:
        return 0
    b = 1
    while b < batch:
        b *= 2
    return b


def plan_key(stage: str, batch, shape) -> str:
    L, R, H = shape
    return f"{stage}/b{_bucket(batch)}/L{L}xR{R}xH{H}"


def _disk_plans(path: pathlib.Path) -> dict:
    name = str(path)
    if name not in _DISK:
        try:
            _DISK[name] = json.loads(path.read_text())
        except (OSError, ValueError):
            _DISK[name] = {}
    return _DISK[name]


def _persist(path: pathlib.Path, key: str, plan: dict) -> None:
    plans = dict(_disk_plans(path))
    plans[key] = plan
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp.write_text(json.dumps(plans, indent=1, sort_keys=True))
        os.replace(tmp, path)
    except OSError:
        pass        # read-only home: the plan stays in memory only
    _DISK[str(path)] = plans


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def lookup(stage: str, batch, shape, lanes: int = 1, mode: str = "seed",
           cache=None, device=None) -> Optional[dict]:
    """The plan for (stage, batch bucket, shape) under ``mode``, or None
    (no plan: the caller's heuristics decide).  Measured plans (this
    process or the cache file) outrank the seed.  ``lanes`` (the bank
    width of the launch) is taken as the JAX package takes it: plans are
    per program."""
    if check_mode(mode) == "off" or shape is None:
        return None
    if stage not in STAGES:
        raise ValueError(f"unknown autotune stage {stage!r}; use {STAGES}")
    dev = torch.device("cuda" if device is None else device)
    path = cache_path(dev, cache)
    key = plan_key(stage, batch, shape)
    with _LOCK:
        plan = (_MEM.get(str(path), {}).get(key)
                or _disk_plans(path).get(key))
        if plan is not None:
            return plan
        if mode == "seed":
            return seed_plan(stage, batch, shape)
        if _capturing(dev):
            raise RuntimeError(
                f"autotune would time {key} during a CUDA graph capture; "
                "resolve the plan before the graph's warm-up")
        plan = measure_plan(stage, batch, shape, dev)
        _MEM.setdefault(str(path), {})[key] = plan
        _persist(path, key, plan)
        return plan


def planned_path(stage: str, batch, shape, lanes: int = 1,
                 mode: str = "seed", cache=None, device=None
                 ) -> Optional[str]:
    plan = lookup(stage, batch, shape, lanes, mode, cache, device)
    return None if plan is None else plan["path"]


def planned_tiles(stage: str, batch, shape, lanes: int = 1,
                  mode: str = "seed", cache=None, device=None
                  ) -> Optional[dict]:
    """The plan's launch geometry (``tiles``), or None where there is no
    plan (``off``; the ``ta`` stage under ``seed``), as the JAX package's
    ``planned_tiles``."""
    plan = lookup(stage, batch, shape, lanes, mode, cache, device)
    return None if plan is None else plan.get("tiles")


def tiles(path: str, batch, shape, sms: int = 0,
          geometry: Optional[dict] = None) -> dict:
    """The launch geometry of ``path``'s wrapper for one program at the
    bucket of ``batch`` on ``sms`` SMs (default: the H100's): the one it
    computes, or with ``geometry``'s keys put in (what the wrapper
    launches when given that override; only the edge, tile and fused
    wrappers take one)."""
    from repro_torch.launch.mesh import H100
    from . import ops
    from .clause_eval import clause_split
    from .fused_step import fused_split
    from .packed_clause import edge_geometry, tile_warps
    from .ta_update import sparse_blocks
    L, R, _ = shape
    B = max(_bucket(batch), 1)
    W = -(-L // 32)
    sms = sms or H100.sms
    g = dict(geometry or {})
    if path == ops.PATH_PACKED:
        lanes, rows, warps, grid = edge_geometry(B, R, W, sms, **g)
        return {"lanes": lanes, "rows_per_warp": rows, "warps": warps,
                "grid": list(grid)}
    if path == ops.PATH_PACKED_MXU:
        return {"warps": g.get("warps") or tile_warps(1, B, R, sms)}
    if path == ops.PATH_FUSED:
        return {"cluster": g.get("cluster") or fused_split(R)}
    if g:
        raise ValueError(f"path {path!r} takes no geometry override")
    if path == ops.PATH_MXU:
        splits, cps = clause_split(1, B, R, L, sms)
        return {"splits": splits, "chunks_per_split": cps}
    if path in (ops.TA_DENSE, ops.TA_COMPACT):
        return {"blocks": sparse_blocks(-(-R // ops.GROUP), R, W, sms)}
    raise ValueError(f"no tiles for path {path!r}")


def geometry_key(geometry: dict) -> str:
    """A geometry override as a ``candidates_us`` key: ``k=v`` pairs in
    key order, joined by commas; ``own`` for no override."""
    return ",".join(f"{k}={v}" for k, v in sorted(geometry.items())) \
        or "own"


def geometries(stage: str, path: str, batch, shape, sms: int = 0) -> list:
    """The launch geometries ``measure`` times for ``path`` in ``stage``:
    the wrapper's own first (the override that names it), then, for the
    eval stage's packed legs, two around it (the tile kernel: the other
    two of 1, 2 and 4 warps; the edge kernel: twice the lanes a row, or
    half at 32, and half the warps, or 2 at 1), and for the fused train
    leg the cluster sizes ceil(tiles / 2) and ceil(tiles / 3) where the
    wrapper's cluster leaves a block more than one clause tile.  Every
    other leg: its own only, the empty override (the dense clause and TA
    wrappers take none)."""
    from . import ops
    from .fused_step import MAX_CLUSTER, TILE
    own_tiles = tiles(path, batch, shape, sms)
    if path == ops.PATH_PACKED:
        lanes, warps = own_tiles["lanes"], own_tiles["warps"]
        own = {"lanes": lanes, "warps": warps}
        if stage != "eval":
            return [own]
        return [own,
                {"lanes": lanes * 2 if lanes < 32 else lanes // 2,
                 "warps": warps},
                {"lanes": lanes, "warps": warps // 2 if warps > 1 else 2}]
    if path == ops.PATH_PACKED_MXU:
        w0 = own_tiles["warps"]
        rest = [w for w in (1, 2, 4) if w != w0]
        out = [{"warps": w0}]
        return out + ([{"warps": w} for w in rest] if stage == "eval"
                      else [])
    if path == ops.PATH_FUSED:
        cs = own_tiles["cluster"]
        n_tiles = -(-shape[1] // TILE)
        out = [{"cluster": cs}]
        if n_tiles > cs:
            for m in (2, 3):
                alt = -(-n_tiles // m)
                if alt != cs and 1 <= alt <= MAX_CLUSTER and \
                        {"cluster": alt} not in out:
                    out.append({"cluster": alt})
        return out
    return [{}]


def launch_plans(stage: str, path: str, batch, shape, geometry: dict,
                 sms: int = 0) -> list:
    """The :mod:`repro_torch.analysis.kernel_check` plans of the launches
    a candidate makes (the kernel whose geometry it sets, and any other
    kernel of its leg at its own geometry), for one program."""
    from repro_torch.analysis import kernel_check as kc
    from repro_torch.launch.mesh import H100
    from . import ops
    L, R, H = shape
    B = max(_bucket(batch), 1)
    W = -(-L // 32)
    sms = sms or H100.sms
    if stage == "ta":
        kernel = ("ta_update_sparse" if path == ops.TA_COMPACT
                  else "ta_update")
        return [kc.plan_ta(kernel, 1, 2 * B, L, R, sms)]
    if path == ops.PATH_PACKED:
        plans = [kc.plan_edge(1, B, R, W, sms, geometry)]
    elif path == ops.PATH_PACKED_MXU:
        plans = [kc.plan_tile(1, B, R, W, sms, geometry=geometry)]
    elif path == ops.PATH_MXU:
        plans = [kc.plan_clause_eval(1, B, L, R, sms)]
    elif path == ops.PATH_FUSED:
        return [kc.plan_fused(1, B, R, W, H, geometry)]
    else:
        raise ValueError(f"no launch plans for path {path!r}")
    if stage == "train":        # the separate front half's class sums
        plans.append(kc.plan_class_sum(1, B, R, H, sms))
    return plans


# ---------------------------------------------------------------------------
# seed mode: the card's cost model decides, nothing is timed or written
# ---------------------------------------------------------------------------

def seed_plan(stage: str, batch, shape) -> Optional[dict]:
    """The JAX package's ``_seed_plan`` on the H100 model: the edge kernel
    at and below ``PACKED_MAX_BATCH``; above it the model's ``winner``
    for eval and ``fused`` for train; no plan for ``ta``."""
    from repro_torch.launch import tm_perf
    from . import ops
    L, R, H = shape
    B = _bucket(batch) or 256          # unknown batch: throughput regime
    edge = batch is not None and batch <= ops.PACKED_MAX_BATCH
    if stage == "eval":
        path = (ops.PATH_PACKED if edge
                else tm_perf.packed_eval_costs(B, L, R)["winner"])
    elif stage == "train":
        path = ops.PATH_PACKED if edge else ops.PATH_FUSED
    elif stage == "ta":
        return None                    # select_ta_path's heuristics hold
    else:
        raise ValueError(f"unknown autotune stage {stage!r}; use {STAGES}")
    return {"path": path, "tiles": tiles(path, batch, shape),
            "source": "seed"}


# ---------------------------------------------------------------------------
# measure mode: time the candidates on the device, keep the fastest
# ---------------------------------------------------------------------------

def _time_us(fn: Callable[[], object], device: torch.device) -> float:
    """Median µs of ``fn`` after one warm-up: CUDA events around each run
    on the card, the host clock on the CPU.  On the card a sleep kernel
    holds the device while the host enqueues the run, so the events time
    the device's work, not the wrappers' host path; a run whose enqueue
    outlasted the sleep (the start event already passed when the host
    returns) is taken again with a sleep twice as long."""
    fn()
    ts = []
    cycles = SLEEP_CYCLES
    for _ in range(MEASURE_ITERS):
        if device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
            continue
        while True:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            fn()
            late = start.query()     # the device waited on the host
            end.record()
            end.synchronize()  # dtmlint: disable=DTM003 (measure's timing, never in a capture)
            if not late or cycles >= SLEEP_CYCLES << 6:
                break
            cycles *= 2
        ts.append(start.elapsed_time(end) * 1e3)
    return float(np.median(ts))


def candidates(stage: str, batch, shape, device, sms: int = 0) -> list:
    """What a ``measure`` plan times for ``stage``: ``(path, geometry,
    thunk)`` for each path and each of its :func:`geometries`, where the
    thunk runs the candidate's ops wrappers, with that geometry, on
    synthetic inputs at the padded shape and the bucket's batch, on
    ``device``."""
    from repro_torch.core.booleanize import pack_literals
    from . import ops, ref
    L, R, H = shape
    B = max(_bucket(batch), 1)
    dev = torch.device(device)
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)

    lits = t(rng.integers(0, 2, (1, B, L)), torch.int8)
    inc = t(rng.integers(0, 2, (1, R, L)), torch.int8)
    plits = pack_literals(lits.to(torch.int32))
    pinc = pack_literals(inc.to(torch.int32))
    if stage == "eval":
        legs = {
            ops.PATH_PACKED: lambda g: ops.packed_clause_eval(
                plits, pinc, eval_mode=True, n_bits=L, geometry=g),
            ops.PATH_PACKED_MXU: lambda g: ops.packed_clause_tile(
                plits, pinc, eval_mode=True, n_bits=L, geometry=g),
            ops.PATH_MXU: lambda g: ops.clause_eval(lits, inc,
                                                    eval_mode=True)}
    elif stage == "train":
        lab = t(rng.integers(0, H, (1, B)))
        rest = (t(rng.integers(-4, 5, (1, H, R))), lab, (lab + 1) % H,
                t(rng.integers(0, 1 << 16, (1, 2, B, R))),
                t(np.ones((1, R))), t(np.ones((1, H))), t([32]), t([0]))
        legs = {
            ops.PATH_PACKED: lambda g: ops.packed_step_op(
                plits, pinc, *rest, n_bits=L),
            ops.PATH_FUSED: lambda g: ops.fused_step_op(
                plits, pinc, *rest, n_bits=L, geometry=g),
            ops.PATH_MXU: lambda g: ops.unfused_step_op(lits, inc, *rest)}
    elif stage == "ta":
        ta = t(rng.integers(0, 256, (1, R, L)), torch.uint8)
        lit2 = torch.cat([plits, plits], dim=1)
        cl = t(rng.integers(0, 2, (1, 2 * B, R)))
        t1 = t(rng.random((1, 2 * B, R)) < 0.25)
        t2 = t(rng.random((1, 2 * B, R)) < 0.25)
        l_mask = t(np.ones((1, L)))
        ta_inc = ref.pack_include(ta, t([256]))
        kw = dict(seed=t([1]), p_ta=t([1 << 13]), boost=t([0], torch.bool),
                  n_states=t([256]))
        legs = {
            ops.TA_COMPACT: lambda g: ops.ta_update_compact_op(
                ta, lit2, cl, t1, t2, l_mask, ta_inc, **kw),
            ops.TA_DENSE: lambda g: ops.ta_update_op(
                ta, lit2, cl, t1, t2, l_mask, **kw)}
    else:
        raise ValueError(f"unknown autotune stage {stage!r}; use {STAGES}")
    return [(path, g, (lambda fn=fn, g=g: fn(g)))
            for path, fn in legs.items()
            for g in geometries(stage, path, batch, shape, sms)]


def measure_plan(stage: str, batch, shape, device) -> dict:
    """Check every candidate ``(path, geometry)`` of ``stage`` with
    :func:`repro_torch.analysis.kernel_check.check_plan`, time the ones
    that pass on ``device`` and return a plan: the path fastest at its
    own geometry (the one the engine launches, as launches do not read
    ``tiles``) with that time as ``us``, the path's fastest timed
    geometry as ``tiles``, each candidate's µs by path and geometry, and
    the refused candidates with their violations.  A candidate that
    raises propagates.  The timing launches are not counted in
    ``ops.launch_counts()``."""
    from repro_torch.analysis.kernel_check import check_plan
    from . import ops
    dev = torch.device(device)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 0)
    times: Dict[str, Dict[str, float]] = {}
    rejected: Dict[str, Dict[str, str]] = {}
    own: Dict[str, str] = {}            # path -> its own geometry's key
    timed = {}                          # (path, key) -> geometry
    saved = ops.launch_counts()
    try:
        for path, geom, fn in candidates(stage, batch, shape, dev, sms):
            key = geometry_key(geom)
            own.setdefault(path, key)   # geometries() puts it first
            bad = [v.render() for lp in launch_plans(stage, path, batch,
                                                      shape, geom, sms)
                   for v in check_plan(lp)]
            if bad:
                rejected.setdefault(path, {})[key] = "; ".join(bad)
                continue
            times.setdefault(path, {})[key] = _time_us(fn, dev)
            timed[path, key] = geom
    finally:
        ops.set_launch_counts(saved)
    runs = {p: times[p][k] for p, k in own.items() if (p, k) in timed}
    if not runs:
        raise RuntimeError(f"autotune: the launch checker refused every "
                           f"{stage} path's own geometry: {rejected}")
    path = min(runs, key=runs.get)
    best = min(times[path], key=times[path].get)
    return {"path": path,
            "tiles": tiles(path, batch, shape, sms, timed[path, best]),
            "us": runs[path], "candidates_us": times, "rejected": rejected,
            "source": "measure"}
