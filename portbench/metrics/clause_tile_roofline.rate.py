"""``packed_clause_tile``'s share of its roofline in the traced stretch:
each launch evaluates every resident tenant's clauses on a full batch
slot (``work.clause_tile_cost``); the least time of the launches over
their device time.  The least time is the larger of the bit products at
the tensor cores' single-bit rate and the bytes at the memory rate; at
the roster's shapes the bytes bind."""
import re

from portbench import trace, work

KERNEL = re.compile(r"\bpacked_clause_tile\b")


def read(ctx):
    sec, launches = trace.kernel_seconds(ctx.get("trace") or {}, KERNEL)
    if not launches or not sec:
        return None
    models = list(ctx["config"]["models"].values())
    products, nbytes = work.clause_tile_cost(
        models, ctx["config"]["engine"]["batch_slot"])
    pk = ctx["peaks"]
    t, _ = work.bound_s(work.least_s(pk, bit_products=products), nbytes, pk)
    return 100.0 * launches * t / sec
