"""Device microseconds a conv training step of every kernel of the traced
pass but the clause tile and the class sums (``packed_clause_tile``,
``class_sum_kernel``): the draws, the patch mask and OR, the selection,
the patch pick, the TA and weight update, whichever kernels run them.
Copies and fills are not kernels (``trace.NOT_KERNELS``)."""
import re

from portbench import trace

CLAUSE_STAGE = re.compile(r"\bpacked_clause_tile\b|\bclass_sum_kernel\b")


def read(ctx):
    tr, steps = ctx.get("trace") or {}, ctx["notes"].get("steps")
    by = tr.get("by_kernel")
    if not by or not steps:
        return None
    sec = sum(s for name, (s, _) in by.items()
              if not name.startswith(trace.NOT_KERNELS)
              and not CLAUSE_STAGE.search(name))
    return 1e6 * sec / steps
