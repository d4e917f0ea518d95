"""Fused inference: the Hopper kernel and its plain version.

    sums[k, b, h] = Σ_c clause[k, b, c] · w[k, h, c]
    clause        = the dense clause evaluation of :mod:`.clause_eval`

from literals int8 [K, B, L], include int8 [K, C, L] and weights int32
[K, H, C] to unpinned class sums int32 [K, B, H], in one launch: the
clause tile never goes to device memory (the paper's Fig 9a pipeline).

:func:`tm_infer` launches ``csrc/clause_eval.cu:dtm_tm_infer`` on CUDA
tensors and runs the plain version on CPU tensors; it raises for anything
else.  It replaces ``repro/kernels/tm_infer.py:tm_infer``.  The kernel is
``clause_eval``'s clause body (same tile, same literal splits) with a
class-sum epilogue that adds into a zeroed output; the source note gives
the design.  :func:`prepare_tm_infer` returns the bare launch, without the
fill.  ``tm_infer.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .clause_eval import clause_split, operands, sm_count, vec_loads
from .ta_update import _route

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def tm_infer_plain(lit: torch.Tensor, inc: torch.Tensor, w: torch.Tensor,
                   eval_mode: bool = True) -> torch.Tensor:
    """The plain version: the violation-count clause evaluation, then the
    class sums (``ref.tm_infer_ref`` without the [B, C, L] broadcast)."""
    return ref.class_sum_ref(ref.clause_eval_viol_ref(lit, inc, eval_mode),
                             w)


def _check(lit, inc, w):
    """Validate the operands; returns (K, B, C, L, H)."""
    K, B, C, L = operands(lit, inc)
    if w.dim() != 3 or w.shape[0] != K or w.shape[2] != C:
        raise ValueError(f"weights {tuple(w.shape)} do not fit K={K}, C={C}")
    if w.dtype != torch.int32:
        raise TypeError(f"weights must be int32, got {w.dtype}")
    return K, B, C, L, w.shape[1]


def prepare_tm_infer(lit: torch.Tensor, inc: torch.Tensor, w: torch.Tensor,
                     eval_mode: bool = True):
    """(launch or None, sums) of :func:`tm_infer` on CUDA operands.
    ``sums`` is zeroed here; ``launch()`` adds the class sums into it, so
    it holds the result after exactly one launch."""
    K, B, C, L, H = _check(lit, inc, w)
    dev = lit.device
    lit, inc, w = lit.contiguous(), inc.contiguous(), w.contiguous()
    out = torch.zeros((K, B, H), dtype=torch.int32, device=dev)
    if out.numel() == 0 or C == 0:     # C == 0: an empty grid
        return None, out
    lib, fn = _build.entry("clause_eval", "dtm_tm_infer", _ARGTYPES)
    _, cps = clause_split(K, B, C, L, sm_count(dev.index or 0))
    cargs = [lit.data_ptr(), inc.data_ptr(), w.data_ptr(), out.data_ptr(),
             K, B, C, L, H, int(bool(eval_mode)), vec_loads(L, lit, inc),
             cps]

    def launch():
        with torch.cuda.device(dev):
            status = fn(*cargs, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, status, "dtm_tm_infer")
        tm_infer.launches += 1
    launch.keep = (lit, inc, w, out)   # the tensors its pointers point into
    return launch, out


def tm_infer(lit: torch.Tensor, inc: torch.Tensor, w: torch.Tensor,
             eval_mode: bool = True) -> torch.Tensor:
    """literals int8 [K, B, L], include int8 [K, C, L], weights int32
    [K, H, C] -> unpinned class sums [K, B, H] int32."""
    if _route(lit, inc, w) == "cpu":
        _check(lit, inc, w)
        return tm_infer_plain(lit, inc, w, eval_mode)
    launch, out = prepare_tm_infer(lit, inc, w, eval_mode)
    if launch is not None:
        launch()
    return out


tm_infer.launches = 0
