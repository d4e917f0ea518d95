"""Requests a stacked launch: the scheduler's completed requests over its
launches in the window (``TMScheduler.stats()``)."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("launches"):
        return None
    return c["completed"] / c["launches"]
