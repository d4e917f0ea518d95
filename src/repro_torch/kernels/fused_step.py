"""Fused training-step front half: the Hopper kernel and its plain version.

One launch computes, for a bank of K programs,

    clause [K, B, R]  training-mode clause outputs (empty clauses fire)
    sums   [K, B, H]  class sums, padded classes pinned to NEG_INF_SUM
    sel_lab, sel_neg [K, B, R]  Alg-3 selection for the target and the
                      negated rounds

from the engine's packed operands: literals ``[K, B, W]`` and include
words ``[K, R, W]`` (int32 bit patterns, ``n_bits`` real literals), weights
``[K, H, R]``, labels and negated labels ``[K, B]``, random words
``[K, 2, B, R]`` (< 2^rand_bits; round 0 target, round 1 negated), masks
and the per-program ``T`` and ``w_frozen`` ``[K]``.

:func:`fused_step` launches ``csrc/fused_step.cu`` on CUDA tensors and runs
:func:`fused_step_plain` on CPU tensors; it raises for anything else.  It
replaces ``repro/kernels/fused_step.py:fused_step``.  ``fused_step.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ROWS = 4                   # csrc kRows: batch rows per block
_SMEM_LIMIT = 48 * 1024


def fused_step_plain(lit, inc, weights, labels, neg, rand, cl_mask, h_mask,
                     T, w_frozen, rand_bits: int = 16, n_bits=None):
    """Plain version of the kernel (the JAX package's ``packed_step_ref``)."""
    return ref.packed_step_ref(lit, inc, weights, labels, neg, rand[:, 0],
                               rand[:, 1], cl_mask, h_mask, T, w_frozen,
                               rand_bits, n_bits=n_bits)


def _check(lit, inc, weights, labels, neg, rand, cl_mask, h_mask, T,
           w_frozen, rand_bits, n_bits):
    """Validate the operands; returns (K, B, R, W, H, n_bits)."""
    if lit.dim() != 3 or inc.dim() != 3 or weights.dim() != 3:
        raise ValueError(f"expected lit [K, B, W], inc [K, R, W], weights "
                         f"[K, H, R]; got {tuple(lit.shape)}, "
                         f"{tuple(inc.shape)}, {tuple(weights.shape)}")
    K, B, W = lit.shape
    R, H = inc.shape[1], weights.shape[1]
    want = {"inc": (inc, (K, R, W)), "weights": (weights, (K, H, R)),
            "labels": (labels, (K, B)), "neg": (neg, (K, B)),
            "rand": (rand, (K, 2, B, R)), "cl_mask": (cl_mask, (K, R)),
            "h_mask": (h_mask, (K, H)), "T": (T, (K,)),
            "w_frozen": (w_frozen, (K,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    n_bits = 32 * W if n_bits is None else int(n_bits)
    if not 0 < n_bits <= 32 * W:
        raise ValueError(f"n_bits={n_bits} outside (0, {32 * W}]")
    if not 0 < rand_bits < 32:
        raise ValueError(f"rand_bits={rand_bits} outside [1, 31]")
    return K, B, R, W, H, n_bits


def fused_step(lit: torch.Tensor, inc: torch.Tensor, weights: torch.Tensor,
               labels: torch.Tensor, neg: torch.Tensor, rand: torch.Tensor,
               cl_mask: torch.Tensor, h_mask: torch.Tensor, T: torch.Tensor,
               w_frozen: torch.Tensor, rand_bits: int = 16, n_bits=None):
    """Training-step front half of K programs in one launch (module
    docstring).  Returns (clause, sums, sel_lab, sel_neg), all int32.
    Labels must lie in [0, H)."""
    args = (lit, inc, weights, labels, neg, rand, cl_mask, h_mask, T,
            w_frozen)
    K, B, R, W, H, n_bits = _check(*args, rand_bits, n_bits)
    kinds = {t.device.type for t in args}
    if kinds == {"cpu"}:
        return fused_step_plain(*args, rand_bits=rand_bits, n_bits=n_bits)
    if kinds != {"cuda"} or len({t.device for t in args}) != 1:
        raise ValueError(f"no kernel for operands on "
                         f"{sorted(str(t.device) for t in args)}")
    if lit.dtype != torch.int32 or inc.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {lit.dtype}, "
                        f"{inc.dtype}")
    # the kernel reads dense int32 rows: cast and compact what is not
    ops_ = [t.to(torch.int32).contiguous() for t in args]
    dev = lit.device
    clause = torch.empty((K, B, R), dtype=torch.int32, device=dev)
    sums = torch.empty((K, B, H), dtype=torch.int32, device=dev)
    sel_lab = torch.empty_like(clause)
    sel_neg = torch.empty_like(clause)
    # scratch: class-sum accumulators and per-batch-tile block counters
    acc = torch.zeros((K, B, H), dtype=torch.int32, device=dev)
    done = torch.zeros((K, -(-B // _ROWS)), dtype=torch.int32, device=dev)
    if clause.numel() == 0 or H == 0:
        return clause, sums, sel_lab, sel_neg
    lib = _build.load("fused_step")
    lib.dtm_fused_step_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dtm_fused_step_smem.restype = ctypes.c_size_t
    if lib.dtm_fused_step_smem(W, H) > _SMEM_LIMIT:
        raise ValueError(f"W={W}, H={H} overflow the kernel's shared memory")
    if K > 65535 or -(-B // _ROWS) > 65535:
        raise ValueError(f"K={K}, B={B} exceed the grid's z or y limit")
    fn = lib.dtm_fused_step
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*(t.data_ptr() for t in ops_), clause.data_ptr(),
                    sums.data_ptr(), sel_lab.data_ptr(), sel_neg.data_ptr(),
                    acc.data_ptr(), done.data_ptr(), K, B, R, W, H, n_bits,
                    rand_bits, stream)
    _build.check(lib, status, "dtm_fused_step")
    fused_step.launches += 1
    return clause, sums, sel_lab, sel_neg


fused_step.launches = 0
