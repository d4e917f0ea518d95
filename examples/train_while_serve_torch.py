"""Durable streaming continual learning on the PyTorch port:
train-while-serve, crash, and bit-identical recovery.

The mirror of ``examples/train_while_serve.py`` on ``repro_torch``.  Two
tenants learn online through ``submit_train`` while serving inference off
the same program-major launches.  An async checkpoint writer makes every
applied step durable off the hot path; an injected transient launch fault
is absorbed by the retry budget while gold-SLA traffic keeps flowing.
Then the process state is thrown away and ``api.serve(None,
durable_dir=...)`` cold-starts the whole roster (specs, SLAs, programs,
PRNGs and step counters) from disk, continuing exactly where the
"crashed" server stopped.  The durable directory is a temporary one,
removed at the end.

    python examples/train_while_serve_torch.py                  # on the card
    python examples/train_while_serve_torch.py --device cpu     # plain versions

``main(argv)`` returns ``{"device", "steps", "predictions",
"continued_steps", "stats"}``: the steps and the probe's predictions
before the crash (equal after the cold start), the steps after one more
training batch, and the scheduler's counters.  The assertions hold at
every size.
"""
import argparse
import os
import pathlib
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.api import TMSpec  # noqa: E402
from repro_torch.launch.scheduler import (GOLD, STANDARD,  # noqa: E402
                                          SchedulerConfig)
from repro_torch.launch.serve_tm import demo_batch  # noqa: E402
from repro_torch.runtime.fault import FaultInjector, FaultPlan  # noqa: E402

B = 8
SLAS = {"kws-gold": GOLD, "votes-std": STANDARD}


def make_roster(scale: int = 1) -> dict:
    """The JAX script's two tenants, clause counts divided by ``scale``."""
    return {
        "kws-gold": TMSpec.vanilla(features=24, classes=6,
                                   clauses=32 // scale, T=16, s=4.0),
        "votes-std": TMSpec.regression(features=12, clauses=32 // scale,
                                       T=32, s=3.0),
    }


def batches(roster, name, step):
    rng = np.random.default_rng(100 * step + (name == "kws-gold"))
    x = demo_batch(roster[name], B, seed=step)
    if roster[name].kind == "regression":
        return x, rng.random(B).astype(np.float32)
    return x, rng.integers(0, roster[name].classes, B).astype(np.int32)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    ap.add_argument("--steps", type=int, default=6,
                    help="training batches a tenant before the crash")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide the tenants' clause counts by this")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    ns = parse(argv)
    roster = make_roster(ns.scale)
    durable_dir = tempfile.mkdtemp(prefix="dtm_durable_")
    try:
        # --- train-while-serve with an injected launch fault ------------
        inj = FaultInjector(FaultPlan(fail={"launch": (3,)}))  # transient
        sched = api.serve(roster, batch_slot=B, device=ns.device,
                          durable_dir=durable_dir, slas=SLAS, injector=inj,
                          config=SchedulerConfig(ckpt_interval_s=0.05))
        device = str(sched.server.engine.device)
        print(f"engine device={device}  durable_dir={durable_dir}")
        for step in range(ns.steps):
            for name in roster:
                x, y = batches(roster, name, step)
                sched.submit_train(name, x, y)
                sched.submit(name, demo_batch(roster[name], B,
                                              seed=step + 50))
        sched.drain()
        sched.checkpoint_now()              # durability barrier

        stats = sched.stats()
        assert stats["completed"] == stats["submitted"], \
            "gold requests dropped?"
        print(f"served {stats['completed']} requests "
              f"({stats['trains']} training steps applied), "
              f"retries={stats['retries']} faults={stats['faults']} "
              f"checkpoint_saves={stats['checkpoint']['saves']}")

        probe = {n: demo_batch(roster[n], B, seed=7) for n in roster}
        want = {n: np.asarray(sched.server.predict(n, probe[n]))
                for n in roster}
        steps_before = {n: sched.server.tenants[n].steps for n in roster}
        sched.stop()
        del sched                           # the "crash"

        # --- cold-start from disk alone ---------------------------------
        restored = api.serve(None, durable_dir=durable_dir,
                             device=ns.device)
        print(f"\nrestored roster: {sorted(restored.server.tenants)}  "
              f"(kws-gold sla={restored.sla_of('kws-gold').name})")
        for n in roster:
            assert restored.server.tenants[n].steps == steps_before[n]
            got = np.asarray(restored.server.predict(n, probe[n]))
            np.testing.assert_array_equal(got, want[n])
            print(f"  {n:10s} step={steps_before[n]} predictions "
                  "bit-identical")

        # and it keeps LEARNING from where it stopped
        for name in roster:
            x, y = batches(roster, name, ns.steps)
            restored.submit_train(name, x, y)
        restored.drain()
        assert all(restored.server.tenants[n].steps == steps_before[n] + 1
                   for n in roster)
        continued = {n: restored.server.tenants[n].steps for n in roster}
        print(f"\ncontinued training to step {continued}")
        print("durable layout:",
              sorted(os.listdir(os.path.join(durable_dir, "tenants"))))
        restored.stop()
    finally:
        shutil.rmtree(durable_dir, ignore_errors=True)
    return {"device": device, "steps": steps_before,
            "predictions": {n: v.tolist() for n, v in want.items()},
            "continued_steps": continued,
            "stats": {k: stats[k] for k in ("completed", "submitted",
                                            "trains", "retries", "faults")}}


if __name__ == "__main__":
    main()
