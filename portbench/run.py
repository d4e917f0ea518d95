"""The benchmark of ``repro_torch`` on NVIDIA cards: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration is the file the manifest names, its
traffic ``portbench/traffic/<traffic>.json`` (read by the driver the file
names, ``portbench/drivers.py``), and each per-layer metric a reader
``portbench/metrics/<metric>.py``.  A new cell, configuration, mix or
metric is new files and manifest entries; nothing here changes.

A configuration file may name its plain reference,
``"reference": "portbench/<file>.py"`` (without the key,
``portbench/tm_reference.py``), loaded by path as the metric readers are.
A reference module declares ``KINDS``, the model kinds it judges, and
``bool_features(model)``, the Boolean features a clause sees; the
harness calls its ``has_weights``, ``motif_literals``, ``model_at``,
``rows_of``, ``held_ta``, ``weight_matrix``, ``Cluster``, ``train_step``
and ``predict`` (``portbench/drivers.py``).  A model whose kind the
reference does not declare, or a reference without one of these names,
stops the run before any data is made.  A task of the configuration's ``data`` may state
``"shape": [h, w]``: its rows are then handed to the program as images.

A run: set-up (data, programs and the program's kernels and graphs, all
from ``--seed``; every shape of the cell warmed), a window of
``--seconds`` seconds, then the reference judges what the window
produced.  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled stretch of the
window.  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of that object.  There is no CPU fallback: without
the cards the cell asks for, the run exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

DEFAULT_REFERENCE = "portbench/tm_reference.py"
# what the harness calls in a reference module
REFERENCE_NAMES = ("KINDS", "bool_features", "has_weights", "motif_literals",
                   "model_at", "rows_of", "held_ta", "weight_matrix",
                   "Cluster", "train_step", "predict")
# top-level modules that must not be loaded in a run (the JAX package and
# JAX itself), compared with each loaded module's top-level name whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# every number compared must not exceed its limit: all are counts of
# outputs that differ from the reference's, and the arithmetic is integer
LIMITS = {"ta_mismatch": 0, "include_mismatch": 0, "weight_mismatch": 0,
          "prng_mismatch": 0, "stats_mismatch": 0, "wrong_answers": 0,
          "missing_answers": 0, "pass_mismatch": 0}


# a run that hangs prints every thread's stack and exits 1 with no result:
# set-up may compile (a checkout's first run), the rest may not hang past
# the window by more than the judging and the wait for late answers
SETUP_WATCH_S = 1100
AFTER_WINDOW_WATCH_S = 240


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    seed: int
    device: str
    cache_dir: pathlib.Path
    end_to_end: list
    per_layer: list
    ref: object                   # the configuration's reference module
    root: pathlib.Path = ROOT


def require_devices(n: int) -> str:
    """The device of a run: the first card, when there are ``n``."""
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("CUDA is not available: this benchmark runs on the "
                       "card only")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"the cell asks for {n} cards, "
                       f"{torch.cuda.device_count()} present")
    return "cuda"


def load_cell(name: str, seed: int, device: str, root=ROOT) -> Cell:
    """A cell of the manifest with its configuration, traffic and
    metrics."""
    man = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in man["workloads"]}[name]
    conf = {c["name"]: c for c in man["configs"]}[entry["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{entry['traffic']}.json")
        .read_text())

    def mine(metrics, moves=None):
        out = []
        for m in metrics:
            if name in m.get("workloads", ()):
                out.append(m)
            elif "workloads" not in m and (moves is None
                                           or m["moves"] in moves):
                out.append(m)
        return out
    ref = reference(config, root)
    e2e = mine(man["end_to_end"])
    per_layer = mine(man["per_layer"], {m["name"] for m in e2e})
    cache = root / "build" / "portbench"
    cache.mkdir(parents=True, exist_ok=True)
    return Cell(name, entry, config, traffic, seed, device, cache, e2e,
                per_layer, ref, root)


def reference(config: dict, root=ROOT):
    """The plain reference module that ``config`` names, loaded from its
    file; raises when it lacks a name of :data:`REFERENCE_NAMES` or does
    not judge the kind of one of the configuration's models."""
    rel = config.get("reference", DEFAULT_REFERENCE)
    name = "portbench_reference_" + "".join(
        ch if ch.isalnum() else "_" for ch in rel)
    spec = importlib.util.spec_from_file_location(name, root / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod       # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    missing = [n for n in REFERENCE_NAMES if not hasattr(mod, n)]
    if missing:
        raise ValueError(f"{rel} lacks {missing} of a reference module")
    for model, m in config["models"].items():
        if m["kind"] not in mod.KINDS:
            raise ValueError(
                f"{rel} judges the kinds {list(mod.KINDS)}, not model "
                f"{model!r} of kind {m['kind']!r}")
    return mod


def reader(name: str, root=ROOT):
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run(cell: Cell, seconds: float, trace: bool, out=sys.stdout,
        err=sys.stderr, t_start: float = T_START,
        watchdog: bool = False) -> dict:
    """One run of ``cell``; returns the result object it prints.
    ``watchdog``: a run that hangs dumps its threads' stacks and exits."""
    import torch
    from repro_torch import api
    from portbench import drivers, work
    from portbench.trace import Tracer

    torch.set_num_threads(2)
    drv = drivers.DRIVERS[cell.traffic["driver"]](cell)
    on_card = torch.device(cell.device).type == "cuda"
    peaks = work.peaks(torch) if on_card else {
        "int_ops_per_s": 1.0, "bit_products_per_s": 1.0, "bytes_per_s": 1.0}
    drv.begin(t_start)
    drv.setup(api)
    setup_s = time.perf_counter() - t_start
    if watchdog:
        faulthandler.dump_traceback_later(seconds + AFTER_WINDOW_WATCH_S,
                                          exit=True, file=sys.__stderr__)
    tracer = None
    if trace:
        tracer = Tracer(cell.device)
        tracer.prime()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    e2e = drv.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: "
                           f"{found}")
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = drv.judge()
    judge_s = time.perf_counter() - t_judge
    correct = all(v <= LIMITS[k] for k, v in checks.items())
    summary = tracer.summary() if tracer is not None else {}
    c = drv.counters
    for k, v in drv.phases.items():
        print(f"setup {k}: {v:.3f} s", file=err)
    print(f"judge: {judge_s:.3f} s", file=err)
    for k in ("samples", "requests", "passes", "steps", "rows_each_second",
              "cpu_ms_each_second"):
        if k in c:
            print(f"{k}: {c[k]}", file=err)
    if trace:
        ctx = {"counters": c, "trace": summary, "notes": tracer.notes,
               "config": cell.config, "traffic": cell.traffic,
               "peaks": peaks}
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"], cell.root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        vals = dict(e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": float(vals[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(0) if on_card else "cpu"),
              "count": int(cell.entry.get("chips", 1)),
              "memory_peak_bytes": int(peak)}
    if trace:
        device.update(busy_s=summary.get("busy_s", 0.0),
                      window_s=summary.get("window_s", 0.0))
    if on_card:
        print(f"card: {peaks['card']}, max SM clock {peaks['max_sm_mhz']} "
              f"MHz", file=err)
    attempted = c.get("requests", c.get("steps", 0))
    failed = c.get("failed", 0)
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = {"device_ops": summary.get("device_ops", []),
                               "idle_gaps": summary.get("idle_gaps", [])}
    result["checks"] = {k: {"value": v, "limit": LIMITS[k]}
                        for k, v in checks.items()}
    for k, v in checks.items():
        print(f"check {k}: {v} (limit {LIMITS[k]})", file=err)
    err.flush()
    if watchdog:
        faulthandler.cancel_dump_traceback_later()
    print(json.dumps(result), file=out)
    out.flush()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    faulthandler.enable(file=sys.__stderr__, all_threads=True)
    faulthandler.dump_traceback_later(SETUP_WATCH_S, exit=True,
                                      file=sys.__stderr__)
    try:
        cell = load_cell(a.workload, a.seed, "cuda")
        cell.device = require_devices(int(cell.entry.get("chips", 1)))
    except NoDevice as e:
        faulthandler.cancel_dump_traceback_later()
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    run(cell, a.seconds, bool(a.trace), watchdog=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
