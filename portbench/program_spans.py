"""Readers of the program's own span table (``repro_torch.runtime.spans``
``totals()``): the sums of every span the program closed while the
profiler was on.  In a run the profiler is on for ``Tracer.prime`` (which
runs nothing) and the traced stretch, so the table holds the stretch.
A program without the table, or whose spans were not called, reads
``None``."""
from __future__ import annotations


def totals() -> dict:
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return {}
    return spans.totals()


def _sum(t: dict, *names: str) -> float:
    return sum(t[n]["total_s"] for n in names if n in t)


def _per(t: dict, top: str) -> int:
    return t.get(top, {}).get("calls", 0)


def host_us_per_step(ctx):
    """Host microseconds a ``TM.partial_fit`` outside the step graph's
    run: the call less its ``graph.run``, over the calls."""
    t = totals()
    n = _per(t, "tm.partial_fit")
    if not n:
        return None
    return 1e6 * (_sum(t, "tm.partial_fit") - _sum(t, "graph.run")) / n


def encode_us_per_step(ctx):
    """Microseconds a ``TM.partial_fit`` in ``session.encode``: the rows
    and labels to packed literals on the device."""
    t = totals()
    n = _per(t, "tm.partial_fit")
    if not n or "session.encode" not in t:
        return None
    return 1e6 * _sum(t, "session.encode") / n


def copy_us_per_step(ctx):
    """Microseconds a ``TM.partial_fit`` in ``step.load`` and
    ``step.unload``: the program, PRNG and batch into the step graph's
    buffers, and the trained state and stats out."""
    t = totals()
    n = _per(t, "tm.partial_fit")
    if not n or "step.load" not in t:
        return None
    return 1e6 * _sum(t, "step.load", "step.unload") / n


def serial_ms_per_pass(ctx):
    """Host milliseconds a ``TM.fit`` that nothing queued on the device
    overlaps: the call less its ``graph.run`` (the replays' launches)
    and its ``epoch.fetch`` (the wait for each epoch's stats), over the
    calls."""
    t = totals()
    n = _per(t, "tm.fit")
    if not n:
        return None
    return 1e3 * (_sum(t, "tm.fit") - _sum(t, "graph.run", "epoch.fetch")) / n
