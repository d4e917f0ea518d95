"""Fused inference: the Hopper kernel and its plain version.

    sums[k, b, h] = Σ_c clause[k, b, c] · w[k, h, c]
    clause        = the dense clause evaluation of :mod:`.clause_eval`

from literals int8 [K, B, L], include int8 [K, C, L] and weights int32
[K, H, C] to unpinned class sums int32 [K, B, H], in one launch: the
clause tile never goes to device memory (the paper's Fig 9a pipeline).

:func:`tm_infer` launches ``csrc/clause_eval.cu:dtm_tm_infer`` on CUDA
tensors and runs the plain version on CPU tensors; it raises for anything
else.  It replaces ``repro/kernels/tm_infer.py:tm_infer``.  Bound by the
bytes of the include matrix; the source note gives the design.
``tm_infer.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .clause_eval import operands, vec_loads
from .ta_update import _route

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def tm_infer_plain(lit: torch.Tensor, inc: torch.Tensor, w: torch.Tensor,
                   eval_mode: bool = True) -> torch.Tensor:
    """The plain version: the violation-count clause evaluation, then the
    class sums (``ref.tm_infer_ref`` without the [B, C, L] broadcast)."""
    return ref.class_sum_ref(ref.clause_eval_viol_ref(lit, inc, eval_mode),
                             w)


def tm_infer(lit: torch.Tensor, inc: torch.Tensor, w: torch.Tensor,
             eval_mode: bool = True) -> torch.Tensor:
    """literals int8 [K, B, L], include int8 [K, C, L], weights int32
    [K, H, C] -> unpinned class sums [K, B, H] int32."""
    K, B, C, L = operands(lit, inc)
    if w.dim() != 3 or w.shape[0] != K or w.shape[2] != C:
        raise ValueError(f"weights {tuple(w.shape)} do not fit K={K}, C={C}")
    if w.dtype != torch.int32:
        raise TypeError(f"weights must be int32, got {w.dtype}")
    H = w.shape[1]
    if _route(lit, inc, w) == "cpu":
        return tm_infer_plain(lit, inc, w, eval_mode)
    lit, inc, w = lit.contiguous(), inc.contiguous(), w.contiguous()
    out = torch.zeros((K, B, H), dtype=torch.int32, device=lit.device)
    if out.numel() == 0 or C == 0:     # C == 0: an empty grid
        return out
    lib = _build.load("clause_eval")
    fn = lib.dtm_tm_infer
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(lit.device):
        stream = torch.cuda.current_stream(lit.device).cuda_stream
        status = fn(lit.data_ptr(), inc.data_ptr(), w.data_ptr(),
                    out.data_ptr(), K, B, C, L, H, int(bool(eval_mode)),
                    vec_loads(L, lit, inc), stream)
    _build.check(lib, status, "dtm_tm_infer")
    tm_infer.launches += 1
    return out


tm_infer.launches = 0
