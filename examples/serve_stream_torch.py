"""Async continuous-batching serving on the PyTorch port: one scheduler,
four tenants at different rates and SLA classes.

The mirror of ``examples/serve_stream.py`` on ``repro_torch``.  The four
tenants stream requests from the caller thread while the background
driver ("tm-scheduler") owns the card: it coalesces the per-tenant queue
heads into program-major stacked launches earliest-deadline-first, keeps
launches pipelined, and, with ``resident_slots=3``, only three tenants
ride the resident bank at a time, the EWMA arrival-rate loop promoting
the hot one and demoting the cold one through routed program swaps.

    python examples/serve_stream_torch.py                  # on the card
    python examples/serve_stream_torch.py --device cpu     # plain versions

``main(argv)`` returns ``{"device", "answers", "completed",
"submitted", "stats"}``: ``answers`` holds each streamed request as
(tenant, ``demo_batch`` seed, predictions); ``stats`` (the scheduler's)
varies with timing.  The JAX script streams for ``--seconds`` (0.5);
``--requests N`` streams exactly N requests instead, so two runs answer
the same requests.  The assertions hold at every size.
"""
import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.api import TMSpec  # noqa: E402
from repro_torch.launch.scheduler import (BATCH, GOLD, STANDARD,  # noqa: E402
                                          SchedulerConfig)
from repro_torch.launch.serve_tm import demo_batch  # noqa: E402

B = 8


def tenants(scale: int = 1) -> dict:
    """name: (spec, SLA class, offered share of the request stream); the
    JAX script's clause counts divided by ``scale``."""
    return {
        "kws-gold": (TMSpec.vanilla(features=24, classes=6,
                                    clauses=32 // scale, T=16, s=4.0),
                     GOLD, 0.45),
        "mnist-std": (TMSpec.coalesced(features=32, classes=10,
                                       clauses=48 // scale, T=24, s=6.0),
                      STANDARD, 0.35),
        "votes-std": (TMSpec.regression(features=12, clauses=32 // scale,
                                        T=32, s=3.0), STANDARD, 0.15),
        "logs-batch": (TMSpec.vanilla(features=16, classes=2,
                                      clauses=16 // scale, T=8, s=3.0),
                       BATCH, 0.05),
    }


def config() -> SchedulerConfig:
    return SchedulerConfig(max_wait_s=0.001, pipeline_depth=2,
                           resident_slots=3, membership_every=4,
                           min_dwell_ticks=1, promote_min_qps=1.0)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    ap.add_argument("--seconds", type=float, default=0.5,
                    help="how long the caller streams requests")
    ap.add_argument("--requests", type=int, default=None,
                    help="stream exactly this many requests instead")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide the tenants' clause counts by this")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    ns = parse(argv)
    spec_of = tenants(ns.scale)
    roster = {n: spec for n, (spec, _, _) in spec_of.items()}
    sched = api.serve(roster, batch_slot=B, device=ns.device,
                      config=config(),
                      slas={n: sla for n, (_, sla, _) in spec_of.items()})
    print(f"engine device={sched.server.engine.device}  "
          f"resident={sched.server.resident_names()} "
          f"(capacity 3 of {len(roster)})")

    # warm the stacked path untimed, then stream skewed traffic from this
    # thread while the background driver serves it
    for name in roster:
        sched.submit(name, demo_batch(roster[name], B, seed=0))
    sched.drain()

    rng = np.random.default_rng(0)
    names = list(spec_of)
    shares = np.array([s for _, _, s in spec_of.values()])
    sched.start()
    futs, t0 = [], time.perf_counter()
    while (len(futs) < ns.requests if ns.requests is not None
           else time.perf_counter() - t0 < ns.seconds):
        name = names[rng.choice(len(names), p=shares)]
        futs.append((name, len(futs), sched.submit(
            name, demo_batch(roster[name], B, seed=len(futs)))))
        time.sleep(0.002)
    answers = []
    for name, seed, fut in futs:
        preds = fut.result(timeout=60)
        assert preds.shape[0] == B, name
        answers.append((name, seed, np.asarray(preds).tolist()))
    sched.stop()

    stats = sched.stats()
    print(f"\nserved {stats['completed']}/{stats['submitted']} requests in "
          f"{stats['launches']} stacked launches  "
          f"(promotions={stats['promotions']} "
          f"demotions={stats['demotions']})")
    print(f"resident now: {sched.server.resident_names()}  "
          f"cold-path requests: {stats['server']['cold_requests']}")
    print("\nper-tenant:")
    for name, st in stats["tenants"].items():
        print(f"  {name:12s} sla={st['sla']:8s} "
              f"completed={st['completed']:3d} "
              f"ewma={st['ewma_qps']:7.1f}/s resident={st['resident']} "
              f"last_latency={st['last_latency_ms']}ms")
    print("\nfull stats:")
    print(json.dumps(stats, indent=2, default=str))

    # submitted/completed include the len(roster) warm-up requests
    assert stats["completed"] == stats["submitted"] == len(futs) + len(roster)
    assert stats["launches"] < stats["completed"], "no coalescing happened?"
    return {"device": str(sched.server.engine.device), "answers": answers,
            "completed": stats["completed"],
            "submitted": stats["submitted"], "stats": stats}


if __name__ == "__main__":
    main()
