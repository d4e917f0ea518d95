"""Analytic cost model of the TM datapath on the card (H100 roofline terms).

The JAX package's ``launch/tm_perf.py`` models the same stages on a TPU
v5e.  Here every function takes a :class:`~repro_torch.launch.mesh.
HardwareModel` (``hw``, default :data:`~repro_torch.launch.mesh.H100`),
and no TPU constant is used.  The byte counts are facts of the layouts,
so they equal the JAX package's wherever the layouts agree (a CPU test
holds that); the seconds are the card's.

:func:`packed_eval_costs` is what the autotuner's ``seed`` mode reads to
choose between the two packed clause kernels for an eval batch above the
edge regime: the edge kernel (``packed_vpu``), whose work is a word
operation per (batch row, clause, word), and the tile kernel
(``mxu_popcount``), whose work is ``.b1`` tensor-core products.
"""
from __future__ import annotations

from repro_torch.kernels.packed_clause import MMA_ROWS
from .mesh import H100, HardwareModel

# the tile kernel's m16n8k256 products: n (batch rows) and k (words)
MMA_N = 8
MMA_K_WORDS = 8
EDGE_OPS_PER_WORD = 2    # the edge kernel's AND-NOT-OR and its test, at least


def roofline_s(ops: float, bytes_: float, hw: HardwareModel = H100,
               ops_per_s: float = 0.0) -> float:
    """Seconds at the card's roofline: the larger of ``ops`` at
    ``ops_per_s`` (default: the 32-bit integer rate) and ``bytes_`` at the
    memory rate."""
    rate = ops_per_s or hw.int32_ops_per_s()
    return max(ops / rate, bytes_ / hw.hbm_bw)


def clause_eval_bytes(B: int, L: int, C: int, packed: bool) -> dict:
    """Bytes moved by one clause evaluation: int8 literals [B, L] and
    include [C, L], or packed words [B, W] and [C, W] (W = ceil(L / 32)),
    and the [B, C] int32 clause matrix written."""
    W = (L + 31) // 32
    lit = B * W * 4 if packed else B * L
    inc = C * W * 4 if packed else C * L
    out = B * C * 4
    return {"literal_bytes": lit, "include_bytes": inc, "out_bytes": out,
            "total_bytes": lit + inc + out}


def train_front_costs(B: int, L: int, C: int, H: int,
                      hw: HardwareModel = H100) -> dict:
    """The training-step front half (clause eval, class sums, both Alg-3
    rounds) on int8 literals and include, as the JAX model counts it:
    unfused, the [B, C] clause matrix is written and read back and the
    sums re-read by the selection; fused, the clause matrix is written
    once.  Seconds: the int8 products at the tensor-core rate."""
    ops = 2 * B * C * L + 2 * B * C * H + 6 * B * C
    lit, inc = B * L, C * L
    w = H * C * 4
    clause = B * C * 4
    sums = B * H * 4
    sel_io = 2 * B * C * 4
    sel_out = 2 * B * C * 4
    shared = lit + inc + w + sums + sel_io + sel_out
    unfused_bytes = shared + 2 * clause + sums
    fused_bytes = shared + clause
    rate = hw.int8_ops_per_s
    return {"flops": ops, "unfused_bytes": unfused_bytes,
            "fused_bytes": fused_bytes,
            "unfused_roofline_s": roofline_s(ops, unfused_bytes, hw, rate),
            "fused_roofline_s": roofline_s(ops, fused_bytes, hw, rate)}


def clause_shard_step_s(B: int, L: int, C: int, H: int, shards: int,
                        hw: HardwareModel = H100) -> dict:
    """Roofline estimate of one clause-sharded train step (``ShardedTM``):
    each shard runs the :func:`train_front_costs` fused datapath on its
    C/shards row window, then the [B, H] int32 class sums cross NVLink
    once (a ring all-reduce moves ``2·(s-1)/s`` of the buffer a card).
    JAX's formula, on the card's rates."""
    local = train_front_costs(B, L, max(C // shards, 1), H, hw)
    psum_bytes = (0 if shards <= 1
                  else 2 * (shards - 1) / shards * B * H * 4)
    ici_s = psum_bytes / hw.collective_bw()
    return {
        "local_s": local["fused_roofline_s"],
        "psum_bytes": psum_bytes,
        "ici_s": ici_s,
        "step_s": local["fused_roofline_s"] + ici_s,
    }


def program_bytes(L: int, C: int, H: int, ta_bits: int = 8,
                  P: int = 1) -> int:
    """Bytes of one padded program of the port (``DTMProgram.nbytes``):
    TA states [C, L] (uint8, int32 iff ta_bits > 8), include words
    [C, ceil(L/32)] int32, weights [H, C] int32, the int32 clause,
    literal, class and patch masks, and the seven scalars (three bool,
    four int32)."""
    W = (L + 31) // 32
    ta = C * L * (1 if ta_bits <= 8 else 4)
    masks = (C + L + H + P) * 4
    scalars = 3 * 1 + 4 * 4
    return ta + C * W * 4 + H * C * 4 + masks + scalars


def ta_rand_bytes(B: int, L: int, C: int, hw: HardwareModel = H100) -> dict:
    """Random-word traffic of one TA update: the streamed baseline reads a
    word per (batch row, clause, literal); the in-kernel streams read
    none."""
    streamed = B * C * L * 4
    return {"streamed_rand_bytes": streamed, "inkernel_rand_bytes": 0,
            "streamed_rand_s": streamed / hw.hbm_bw}


def tile_products(B: int, L: int, C: int) -> int:
    """m16n8k256 products of the tile kernel: a warp's 16 clause rows
    against each 8-row n-tile holding a real batch row, over ceil(W / 8)
    k-steps."""
    W = (L + 31) // 32
    return -(-B // MMA_N) * -(-C // MMA_ROWS) * -(-W // MMA_K_WORDS)


def packed_eval_costs(B: int, L: int, C: int,
                      hw: HardwareModel = H100) -> dict:
    """The card's terms for one packed clause evaluation on its two
    kernels (both read the same packed words and write the same [B, C]
    int32 clause matrix):

    * ``packed_vpu`` — the edge kernel: ``EDGE_OPS_PER_WORD`` integer
      instructions per (b, c, w) word at the int32 issue rate;
    * ``mxu_popcount`` — the tile kernel: :func:`tile_products` at
      ``hw.b1_mma_per_s``, derated by the occupancy its tiling gives: its
      independent accumulator chains (a warp per 16 clause rows and 32
      batch rows holds a chain per 8-row n-tile with a real row) against
      the probe's chains on every SM.

    Each leg is the larger of its work and the bytes at the memory rate;
    ``winner`` is ``mxu_popcount`` only where it is strictly faster (a
    tie, both bound by bytes, keeps the edge kernel, as in the JAX
    model)."""
    W = (L + 31) // 32
    io = clause_eval_bytes(B, L, C, packed=True)["total_bytes"]
    vpu_word_ops = EDGE_OPS_PER_WORD * B * C * W
    vpu_s = max(vpu_word_ops / hw.int32_ops_per_s(), io / hw.hbm_bw)
    products = tile_products(B, L, C)
    chains = -(-C // MMA_ROWS) * -(-B // MMA_N)
    occupancy = min(1.0, chains / (hw.b1_probe_chains_per_sm * hw.sms))
    mxu_s = max(products / (hw.b1_mma_per_s * occupancy), io / hw.hbm_bw)
    return {"bytes": io, "vpu_word_ops": vpu_word_ops,
            "b1_products": products, "occupancy": occupancy,
            "vpu_s": vpu_s, "mxu_s": mxu_s,
            "winner": "mxu_popcount" if mxu_s < vpu_s else "packed_vpu"}
