"""``packed_clause_tile``'s share of its roofline in the traced pass of
a conv fit: each launch evaluates the clauses on every patch row of a
batch; the least time of that work (``conv_work.clause_tile_cost``: the
model's products, its include and literal bits, one output bit a
(patch row, clause)) over the launches' device time.  The products
bind."""
import re

from portbench import conv_work, trace, work

KERNEL = re.compile(r"\bpacked_clause_tile\b")


def read(ctx):
    sec, launches = trace.kernel_seconds(ctx.get("trace") or {}, KERNEL)
    batch = ctx["counters"].get("batch")
    if not launches or not sec or not batch:
        return None
    (model,) = ctx["config"]["models"].values()
    products, nbytes = conv_work.clause_tile_cost(model, batch)
    pk = ctx["peaks"]
    t, _ = work.bound_s(work.least_s(pk, bit_products=products), nbytes, pk)
    return 100.0 * launches * t / sec
