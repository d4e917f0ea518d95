"""Class sums: the Hopper kernel and its plain version.

    csum[k, b, h] = Σ_r clause[k, b, r] · w[k, h, r]      (int32, exact)

:func:`class_sum` launches ``csrc/class_sum.cu:class_sum_kernel`` on CUDA
tensors and runs the plain version on CPU tensors; it raises for anything
else.  It replaces ``repro/kernels/class_sum.py:class_sum``.  Bound by the
bytes of the clause matrix and the weights it reads; the source note gives
the design: a thread-block cluster per (program, batch tile) splits the
clause axis (:func:`class_sum_split`).  ``class_sum.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, ref

class_sum_plain = ref.class_sum_ref

ROWS = 4              # batch rows per tile (csrc kRows: 1 or 4)
MAX_CLUSTER = 16      # blocks of a cluster over R (csrc kMaxCluster)
MIN_SPAN = 128        # clauses a block takes at least: 32 threads of 4
BLOCKS_PER_SM = 2     # blocks in flight the split aims at
MAX_CLASSES = 2048    # classes exchanged at once (shared memory)

# cl, w, out; K, B, R, H; cl_sk, w_sk, out_sk; rows, cs, span, hc, vec; stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


def class_sum_split(K: int, B: int, R: int, sms: int
                    ) -> Tuple[int, int, int]:
    """(batch rows per tile, blocks of a cluster, clauses per block) of a
    launch: one row a tile at B = 1, else ``ROWS``; enough blocks for
    ``BLOCKS_PER_SM`` on each of ``sms`` SMs, at most ``MAX_CLUSTER`` a
    cluster, each taking at least ``MIN_SPAN`` clauses (a multiple of 4).
    Pure: the CPU tests check it."""
    rows = 1 if B == 1 else ROWS
    clusters = max(K * -(-B // rows), 1)
    want = -(-BLOCKS_PER_SM * sms // clusters)
    cs = max(1, min(want, MAX_CLUSTER, -(-R // MIN_SPAN)))
    span = max(4, 4 * -(-R // (4 * cs)))
    return rows, max(1, -(-R // span)), span


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
    if K > 65535 or -(-B // ROWS) > 65535:
        raise ValueError(f"K={K}, B={B} exceed the grid's z or y limit")
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
    lib, fn = _build.entry("class_sum", "dtm_class_sum", _ARGTYPES)
    from .clause_eval import sm_count
    rows, cs, span = class_sum_split(K, B, R, sm_count(cl.device.index or 0))
    vec = int(R % 4 == 0 and all(t.data_ptr() % 16 == 0 and
                                 (t.shape[0] == 1 or t.stride(0) % 4 == 0)
                                 for t in (cl, w)))
    with torch.cuda.device(cl.device):
        stream = torch.cuda.current_stream(cl.device).cuda_stream
        status = fn(cl.data_ptr(), w.data_ptr(), out.data_ptr(), K, B, R, H,
                    cl.stride(0), w.stride(0), out.stride(0), rows, cs, span,
                    min(H, MAX_CLASSES), vec, stream)
    _build.check(lib, status, "dtm_class_sum")
    class_sum.launches += 1
    return out


class_sum.launches = 0
