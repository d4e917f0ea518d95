"""Dense clause evaluation: the Hopper kernel and its plain version.

    clause[k, b, c] = Σ_l (1 − lit[k, b, l]) · inc[k, c, l] == 0
                      (and, in eval mode, row c of inc is nonempty)

on one byte per literal, ``lit`` int8 [K, B, L] and ``inc`` int8
[K, C, L] ({0, 1}), to ``clause`` int32 [K, B, C].  This is the engine's
``mxu`` clause path (the dense int8 operands the JAX package feeds its
MXU) and the clause stage of the unfused training front half.

:func:`clause_eval` launches ``csrc/clause_eval.cu:dtm_clause_eval`` on
CUDA tensors and runs the plain version on CPU tensors; it raises for
anything else.  It replaces ``repro/kernels/clause_eval.py:clause_eval``.
Bound by the bytes of the include matrix it reads; the source note gives
the design.  ``clause_eval.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .ta_update import _route

# The violation-count form: [B, L] and [C, L] operands, no [B, C, L]
# broadcast (ref.clause_eval_ref is the broadcast oracle).
clause_eval_plain = ref.clause_eval_viol_ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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


def clause_eval(lit: torch.Tensor, inc: torch.Tensor,
                eval_mode: bool = False) -> torch.Tensor:
    """literals int8 [K, B, L], include int8 [K, C, L] -> clause
    [K, B, C] int32."""
    K, B, C, L = operands(lit, inc)
    if _route(lit, inc) == "cpu":
        return clause_eval_plain(lit, inc, eval_mode)
    lit, inc = lit.contiguous(), inc.contiguous()
    out = torch.empty((K, B, C), dtype=torch.int32, device=lit.device)
    if out.numel() == 0:
        return out
    lib = _build.load("clause_eval")
    fn = lib.dtm_clause_eval
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(lit.device):
        stream = torch.cuda.current_stream(lit.device).cuda_stream
        status = fn(lit.data_ptr(), inc.data_ptr(), out.data_ptr(), K, B, C,
                    L, int(bool(eval_mode)), vec_loads(L, lit, inc), stream)
    _build.check(lib, status, "dtm_clause_eval")
    clause_eval.launches += 1
    return out


clause_eval.launches = 0
