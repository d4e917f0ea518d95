"""The work a cell needs, counted from its shapes and from the exact
counts of its records, and the chip's peaks.

The counts are the algorithm's, never the kernels': a later change that
replaces a kernel or fuses the glue around it changes the time, not the
count.  Each is a lower bound on what any implementation does for these
inputs, so a share of a peak or roofline cannot pass 100 % unless the
time is wrong.

Peaks (frozen from ``chip_smoke.py`` of commit 14675cf): the int32 rate
is 64 operations a clock an SM (CUDA C++ Programming Guide, arithmetic
instruction throughput of compute capability 9.0: 32-bit integer add,
logic, shift, compare and IMAD) × the SM count × the card's maximum SM
clock from ``nvidia-smi``; the memory rate is the H100 SXM data sheet's
3.35 TB/s; the single-bit product rate is the tensor cores'
``mma.m16n8k256 .b1 .and.popc`` rate that ``chip_smoke.py``'s
``b1_mma_probe`` measured on this card (1.5e11 products a second,
``src/repro_torch/launch/mesh.py`` ``H100.b1_mma_per_s`` of the same
commit), each product 16 × 8 × 256 bit products.  A clause's AND and
popcount over its literals is priced at that rate, whichever unit a
kernel runs it on: it is the fastest the chip can do it.
"""
from __future__ import annotations

import subprocess

from portbench.tm_reference import rows_of as rows

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_CLOCK_PER_SM = 64
B1_MMA_PER_S = 1.5e11
B1_BITS_PER_MMA = 16 * 8 * 256
TA_DELTA_OPS = 6     # per (TA, batch row with feedback on its clause): the
                     # random-word compare, the literal bit, the Type I
                     # select and add, the Type II test and add
SELECT_OPS = 4       # per (batch row, clause, round): the product, the
                     # shift, the compare, the mask
WEIGHT_OPS = 2       # per (batch row, clause) with feedback: the nudge


def smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def peaks(torch) -> dict:
    """The first card's int32 rate and memory rate, with its name, SM
    clock and power limit."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name, limit, clock = smi("name,power.limit,clocks.max.sm").split(", ")
    mhz = float(clock.split()[0])
    return {"int_ops_per_s": INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6,
            "bit_products_per_s": B1_MMA_PER_S * B1_BITS_PER_MMA,
            "bytes_per_s": HBM_BYTES_PER_S, "sms": sms, "max_sm_mhz": mhz,
            "card": f"{name}, {limit}"}


def words(model: dict) -> int:
    """32-bit words of a row of the model's 2f literals."""
    return -(-2 * model["features"] // 32)


def clause_products(model: dict, batch: int) -> int:
    """Clause outputs of ``batch`` rows: a single-bit product (literal
    absent AND included) per (row, clause, literal), popcounted."""
    return batch * rows(model) * 2 * model["features"]


def class_sum_ops(model: dict, batch: int) -> int:
    """CoTM: a multiply-add per (row, class, clause); Vanilla: an add per
    (row, clause) into its class."""
    if model["kind"] == "coalesced":
        return 2 * batch * model["classes"] * model["clauses"]
    return batch * rows(model)


def least_s(pk: dict, int_ops: float = 0, bit_products: float = 0) -> float:
    """Seconds of ``int_ops`` int32 operations and ``bit_products``
    single-bit products at the chip's peaks."""
    return (int_ops / pk["int_ops_per_s"]
            + bit_products / pk["bit_products_per_s"])


def inference_s(model: dict, batch: int, pk: dict) -> float:
    """Least seconds of inference on ``batch`` rows: clause outputs and
    class sums."""
    return least_s(pk, class_sum_ops(model, batch),
                   clause_products(model, batch))


def train_s(model: dict, batch: int, steps: int, selected: int,
            pk: dict) -> float:
    """Least seconds of ``steps`` training steps of ``batch`` rows in which
    ``selected`` (batch row, clause) pairs got feedback: clause outputs,
    class sums, both selection rounds, the TA deltas and the weight
    nudges."""
    weight = WEIGHT_OPS if model["kind"] == "coalesced" else 0
    ops = (steps * (class_sum_ops(model, batch)
                    + 2 * SELECT_OPS * batch * rows(model))
           + selected * (ta_update_ops(model, 1) + weight))
    return least_s(pk, ops, steps * clause_products(model, batch))


def ta_update_ops(model: dict, selected: int) -> int:
    """The TA deltas of ``selected`` (batch row, clause) pairs."""
    return TA_DELTA_OPS * 2 * model["features"] * selected


def bound_s(ops_s: float, nbytes: float, pk: dict) -> tuple:
    """(least seconds, what bounds it) of work whose operations take
    ``ops_s`` seconds at the peaks (:func:`least_s`) and that reads and
    writes ``nbytes``."""
    t_bytes = nbytes / pk["bytes_per_s"]
    return max(ops_s, t_bytes), ("operations" if ops_s >= t_bytes
                                 else "bytes")


def clause_tile_cost(models: list, batch: int) -> tuple:
    """(single-bit products, bytes) of one stacked clause evaluation of
    ``models`` on ``batch`` rows each: every include word and literal
    word read once, an int32 clause output written per (row, clause)."""
    products = sum(clause_products(m, batch) for m in models)
    nbytes = sum(4 * (rows(m) * words(m) + batch * words(m)
                      + batch * rows(m)) for m in models)
    return products, nbytes
