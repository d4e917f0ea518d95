"""The work of a conv training step (``kind: "conv"``), counted as
``portbench/work.py`` counts the flat step's: the algorithm's, never the
kernels', each a lower bound on what any implementation does for these
inputs, priced at the same peaks (``work.peaks``).

A clause sees ``2 * bool_features`` literals (the reference's
``bool_features``: a patch's pixels and its position code), and is
evaluated on every (image, patch) row of the batch.
"""
from __future__ import annotations

from portbench import conv_reference as ref
from portbench import work

PICK_OPS = 1        # per (batch row, patch, clause): the compare-select of
                    # the patch pick's argmax


def literals(model: dict) -> int:
    """Literals a clause sees: x and not-x of each Boolean feature."""
    return 2 * ref.bool_features(model)


def clause_products(model: dict, batch: int) -> int:
    """A single-bit product (literal absent AND included) per (patch row,
    clause, literal)."""
    return batch * ref.patches(model) * model["clauses"] * literals(model)


def class_sum_ops(model: dict, batch: int) -> int:
    """A multiply-add per (row, class, clause)."""
    return 2 * batch * model["classes"] * model["clauses"]


def select_ops(model: dict, batch: int) -> int:
    """Both Alg-3 rounds."""
    return 2 * work.SELECT_OPS * batch * model["clauses"]


def pick_ops(model: dict, batch: int) -> int:
    """The patch each (row, clause) learns from."""
    return PICK_OPS * batch * ref.patches(model) * model["clauses"]


def ta_update_ops(model: dict, selected: int) -> int:
    """The TA deltas of ``selected`` (batch row, clause) pairs."""
    return work.TA_DELTA_OPS * literals(model) * selected


def train_s(model: dict, batch: int, steps: int, selected: int,
            pk: dict) -> float:
    """Least seconds of ``steps`` conv steps of ``batch`` images in which
    ``selected`` (batch row, clause) pairs got feedback: clause outputs on
    every patch, class sums, both selection rounds, the patch pick, the
    TA deltas and the weight nudges."""
    ops = (steps * (class_sum_ops(model, batch) + select_ops(model, batch)
                    + pick_ops(model, batch))
           + selected * (ta_update_ops(model, 1) + work.WEIGHT_OPS))
    return work.least_s(pk, ops, steps * clause_products(model, batch))


def clause_tile_cost(model: dict, batch: int) -> tuple:
    """(single-bit products, bytes) of the clause stage of one conv train
    step, the work of a ``packed_clause_tile`` launch at K=1 and
    ``batch`` × P patch rows, counted as any implementation must do it:
    a product per (patch row, clause, literal) at the model's clauses
    and literals, not the engine's padded R and W; the include bits and
    the patch rows' literal bits read once; at most one bit written per
    (patch row, clause), whatever the kernel's output format.  The
    products bind at the cell's sizes, so a narrower output (bytes, bits,
    or only the OR over patches and the pick) cannot read above 100 %."""
    n, C, lits = batch * ref.patches(model), model["clauses"], literals(model)
    row_bytes = -(-lits // 8)
    return n * C * lits, C * row_bytes + n * row_bytes + -(-n * C // 8)
