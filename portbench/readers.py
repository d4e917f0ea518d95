"""Readers shared by the per-layer metrics of the training cells.  Each
metric file under ``portbench/metrics/`` names one of these as its
``read``, so that a metric of one training cell and its twin of another,
which move different end-to-end metrics, read the same way."""
from __future__ import annotations

import re

from portbench import trace, work

TA_KERNEL = re.compile(r"\bta_update\b")


def active_groups(ctx):
    """Alg 6's active share: the 128-row clause groups that got feedback,
    over all groups, summed over every step of the window (the program's
    step stats: ``TM.fit``'s epoch records, ``TM.partial_fit``'s
    stats)."""
    c = ctx["counters"]
    if not c.get("total_groups"):
        return None
    return 100.0 * c["active_groups"] / c["total_groups"]


def kernels_per_step(ctx):
    """Kernels launched a training step: every kernel of the traced
    stretch (replays included, copies and fills not), over the stretch's
    steps."""
    tr, steps = ctx.get("trace") or {}, ctx["notes"].get("steps")
    if not tr.get("kernels") or not steps:
        return None
    return tr["kernels"] / steps


def ta_update_roofline(ctx):
    """The TA update kernels' share of their roofline in the traced
    stretch: the least time of the stretch's TA deltas
    (``work.ta_update_ops`` of the (batch row, clause) pairs with feedback
    that the program's step stats count) over the device time of every
    ``ta_update`` kernel there."""
    sec, launches = trace.kernel_seconds(ctx.get("trace") or {}, TA_KERNEL)
    notes = ctx["notes"]
    if not launches or not sec or "selected" not in notes:
        return None
    (model,) = ctx["config"]["models"].values()
    steps, batch = notes["steps"], ctx["counters"]["batch"]
    nbytes = 4 * 2 * batch * work.words(model) * steps
    pk = ctx["peaks"]
    t, _ = work.bound_s(
        work.least_s(pk, work.ta_update_ops(model, notes["selected"])),
        nbytes, pk)
    return 100.0 * t / sec


def step_mfu(ctx):
    """The whole training step's share of the chip's peak: the least time
    of the work of every step of the window at the chip's peaks
    (``work.train_s``, with the pairs with feedback that the step stats
    count) over the window."""
    c = ctx["counters"]
    if not c.get("steps"):
        return None
    (model,) = ctx["config"]["models"].values()
    t = work.train_s(model, c["batch"], c["steps"], c["selected"],
                     ctx["peaks"])
    return 100.0 * t / c["window_s"]
