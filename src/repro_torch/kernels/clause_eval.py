"""Dense clause evaluation: the Hopper kernel and its plain version.

    clause[k, b, c] = Σ_l (1 − lit[k, b, l]) · inc[k, c, l] == 0
                      (and, in eval mode, row c of inc is nonempty)

on one byte per literal, ``lit`` int8 [K, B, L] and ``inc`` int8
[K, C, L] (any nonzero byte counts as 1), to ``clause`` int32 [K, B, C].
This is the engine's ``mxu`` clause path (the dense int8 operands the JAX
package feeds its MXU) and the clause stage of the unfused training front
half.

:func:`clause_eval` launches ``csrc/clause_eval.cu:dtm_clause_eval`` on
CUDA tensors and runs the plain version on CPU tensors; it raises for
anything else.  It replaces ``repro/kernels/clause_eval.py:clause_eval``.
Bound by the bytes of the include matrix it reads; the source note gives
the design.  :func:`clause_split` cuts the literal axis so that small
B·C still fill the card.  ``clause_eval.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build, ref
from .ta_update import _route

# The violation-count form: [B, L] and [C, L] operands, no [B, C, L]
# broadcast (ref.clause_eval_ref is the broadcast oracle).
clause_eval_plain = ref.clause_eval_viol_ref

TILE_B = 32          # batch rows per block (csrc ce::kTileB)
TILE_C = 128         # clauses per block (ce::kTileC)
CHUNK = 128          # literal bytes per stage (ce::kChunk)
MAX_CHUNKS = 64      # chunks a split packs at once: 32 KB of literals
MAX_SPLITS = 8       # splits of a tile: the blocks of one cluster (portable)
MIN_CHUNKS = 2       # chunks per split worth a block
BLOCKS_PER_SM = 2    # blocks an SM holds at once (~80 KB shared memory each)

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def operands(lit: torch.Tensor, inc: torch.Tensor):
    """Validate dense clause operands; returns (K, B, C, L)."""
    if lit.dim() != 3 or inc.dim() != 3:
        raise ValueError(f"expected literals [K, B, L] and include "
                         f"[K, C, L], got {tuple(lit.shape)} and "
                         f"{tuple(inc.shape)}")
    if lit.dtype != torch.int8 or inc.dtype != torch.int8:
        raise TypeError(f"literals and include must be int8, got "
                        f"{lit.dtype}, {inc.dtype}")
    K, B, L = lit.shape
    K2, C, L2 = inc.shape
    if K != K2 or L != L2:
        raise ValueError(f"literals {tuple(lit.shape)} and include "
                         f"{tuple(inc.shape)} disagree on K or L")
    if K > 65535:
        raise ValueError(f"K={K} programs exceed the grid's z limit")
    return K, B, C, L


def vec_loads(L: int, *ts: torch.Tensor) -> int:
    """1 when the kernel may stage rows with 16-byte loads."""
    return int(L % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def clause_split(K: int, B: int, C: int, L: int, sms: int
                 ) -> Tuple[int, int]:
    """(splits, chunks per split) of the literal axis: enough blocks of
    32 batch rows × 128 clauses × one split for ``BLOCKS_PER_SM`` blocks
    on each of ``sms`` SMs, with at most ``MAX_SPLITS`` splits of at least
    ``MIN_CHUNKS`` chunks of 128 literals, and no more than ``MAX_CHUNKS``
    chunks a split until the splits run out (past ``MAX_SPLITS ·
    MAX_CHUNKS · CHUNK`` = 65,536 literals a split packs its literals in
    ranges of ``MAX_CHUNKS`` chunks).  Pure: the CPU tests check it."""
    nchunks = max(-(-L // CHUNK), 1)
    tiles = max(K * -(-B // TILE_B) * -(-C // TILE_C), 1)
    want = -(-BLOCKS_PER_SM * sms // tiles)
    splits = min(want, -(-nchunks // MIN_CHUNKS), MAX_SPLITS)
    splits = min(max(splits, -(-nchunks // MAX_CHUNKS), 1), MAX_SPLITS)
    cps = -(-nchunks // splits)
    return -(-nchunks // cps), cps


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def clause_eval(lit: torch.Tensor, inc: torch.Tensor,
                eval_mode: bool = False) -> torch.Tensor:
    """literals int8 [K, B, L], include int8 [K, C, L] -> clause
    [K, B, C] int32."""
    K, B, C, L = operands(lit, inc)
    if _route(lit, inc) == "cpu":
        return clause_eval_plain(lit, inc, eval_mode)
    lit, inc = lit.contiguous(), inc.contiguous()
    dev = lit.device
    out = torch.empty((K, B, C), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib, fn = _build.entry("clause_eval", "dtm_clause_eval", _ARGTYPES)
    _, cps = clause_split(K, B, C, L, sm_count(dev.index or 0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(lit.data_ptr(), inc.data_ptr(), out.data_ptr(), K, B, C,
                    L, int(bool(eval_mode)), vec_loads(L, lit, inc), cps,
                    stream)
    _build.check(lib, status, "dtm_clause_eval")
    clause_eval.launches += 1
    return out


clause_eval.launches = 0
