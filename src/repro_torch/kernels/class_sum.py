"""Class sums: the Hopper kernel and its plain version.

    csum[k, b, h] = Σ_r clause[k, b, r] · w[k, h, r]      (int32, exact)

:func:`class_sum` launches ``csrc/class_sum.cu:class_sum_kernel`` on CUDA
tensors and runs the plain version on CPU tensors; it raises for anything
else.  It replaces ``repro/kernels/class_sum.py:class_sum``.  Bound by the
bytes of the clause matrix and the weights it reads; the source note gives
the design.  ``class_sum.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

class_sum_plain = ref.class_sum_ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong] * 3 + [ctypes.c_void_p]


def _operands(cl: torch.Tensor, w: torch.Tensor):
    """Validate kernel operands; returns (K, B, R, H)."""
    if cl.dim() != 3 or w.dim() != 3:
        raise ValueError(f"expected clauses [K, B, R] and weights "
                         f"[K, H, R], got {tuple(cl.shape)} and "
                         f"{tuple(w.shape)}")
    if cl.dtype != torch.int32 or w.dtype != torch.int32:
        raise TypeError(f"clauses and weights must be int32, got "
                        f"{cl.dtype}, {w.dtype}")
    K, B, R = cl.shape
    K2, H, R2 = w.shape
    if K != K2 or R != R2:
        raise ValueError(f"clauses {tuple(cl.shape)} and weights "
                         f"{tuple(w.shape)} disagree on K or R")
    for name, t in (("clauses", cl), ("weights", w)):
        if t.stride(2) != 1 or (t.shape[1] > 1 and t.stride(1) != R):
            raise ValueError(f"{name} rows must be contiguous, strides "
                             f"{t.stride()}")
    if K > 65535:
        raise ValueError(f"K={K} programs exceed the grid's y limit")
    return K, B, R, H


def class_sum(cl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """clauses [K, B, R] int32 {0,1}, weights [K, H, R] int32 ->
    sums [K, B, H] int32."""
    kinds = {cl.device.type, w.device.type}
    if kinds == {"cpu"}:
        _operands(cl, w)
        return class_sum_plain(cl, w)
    if kinds != {"cuda"} or cl.device != w.device:
        raise ValueError(f"no kernel for operands on {cl.device} and "
                         f"{w.device}")
    K, B, R, H = _operands(cl, w)
    out = torch.empty((K, B, H), dtype=torch.int32, device=cl.device)
    if out.numel() == 0:
        return out
    lib = _build.load("class_sum")
    fn = lib.dtm_class_sum
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(cl.device):
        stream = torch.cuda.current_stream(cl.device).cuda_stream
        status = fn(cl.data_ptr(), w.data_ptr(), out.data_ptr(), K, B, R, H,
                    cl.stride(0), w.stride(0), out.stride(0), stream)
    _build.check(lib, status, "dtm_class_sum")
    class_sum.launches += 1
    return out


class_sum.launches = 0
