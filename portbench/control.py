"""The readings that set a cell's limits: the program's numbers on many
seeds (the lower reading), the control's (the reference one bit narrower
in TA states and weights, put in the program's place: the upper reading)
and each fault the cell can have, planted in the reference put in the
program's place (training: a step that returns its state unchanged, half
of the batch left out) or in the program's answers (serving: an answer
altered).  One set-up and window a seed, at the cell's own size:

    python3 portbench/control.py --workload mnist_cotm.fit_b32 \\
        --seeds 11,12,13 --seconds 2

prints one JSON line a seed.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from portbench import run as bench  # noqa: E402

FAULTS = {"fit": ("unchanged", "half_batch"),
          "partial_fit": ("unchanged",),
          "serve": ("altered",)}


def readings(cell, seconds: float) -> dict:
    """A cell's set-up and window, then the program's, the control's and
    each fault's numbers."""
    import torch
    from repro_torch import api
    from portbench import drivers
    drv = drivers.DRIVERS[cell.traffic["driver"]](cell)
    drv.setup(api)
    drv.window(seconds, None)
    drv.release()
    gc.collect()
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": cell.seed, "program": drv.judge(),
           "control": drv.judge(drop=1)}
    for f in FAULTS[cell.traffic["driver"]]:
        out[f] = drv.judge(fault=f)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        cell = bench.load_cell(a.workload, seed, "cuda")
        cell.device = bench.require_devices(int(cell.entry.get("chips", 1)))
        print(json.dumps(readings(cell, a.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
