"""The served path's share of the chip's peak: the least time of the
inference work of every row answered in the window at the chip's peaks
(``work.inference_s`` of its tenant's model) over the window."""
from portbench import work


def read(ctx):
    c = ctx["counters"]
    rows = c.get("window_rows_by_tenant")
    if not rows:
        return None
    models = ctx["config"]["models"]
    t = sum(work.inference_s(models[m], n, ctx["peaks"])
            for m, n in rows.items())
    return 100.0 * t / c["window_s"]
