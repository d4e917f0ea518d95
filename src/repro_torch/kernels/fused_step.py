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
replaces ``repro/kernels/fused_step.py:fused_step``.  The kernel splits the
clause axis over a thread-block cluster (:func:`fused_split`) and needs no
scratch, so a call is one launch.  :func:`prepare_fused_step` returns
``(launch, outputs)``: ``launch()`` is the bare kernel launch, so a caller
can time the kernel apart from its wrapper.  ``fused_step.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import torch

from . import _build, ref
from .ta_update import _route

ROWS = 4              # batch rows per tile (csrc kRows)
TILE = 256            # clause rows per tile, one per thread (csrc kTile)
MAX_CLUSTER = 16      # blocks of a cluster over R (csrc kMaxCluster)
SMEM_LIMIT = 227 * 1024   # dynamic shared memory a block may opt into

# lit, inc, w, labels, neg, rand, cl_mask, h_mask, T, w_frozen, clause,
# sums, sel_lab, sel_neg; K, B, R, W, H, n_bits, rand_bits, cs, bulk; stream
_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def fused_step_plain(lit, inc, weights, labels, neg, rand, cl_mask, h_mask,
                     T, w_frozen, rand_bits: int = 16, n_bits=None):
    """Plain version of the kernel (the JAX package's ``packed_step_ref``)."""
    return ref.packed_step_ref(lit, inc, weights, labels, neg, rand[:, 0],
                               rand[:, 1], cl_mask, h_mask, T, w_frozen,
                               rand_bits, n_bits=n_bits)


def fused_split(R: int) -> int:
    """Blocks of a cluster: one cluster per (program, tile of ``ROWS``
    batch rows) whose blocks share the ``TILE``-row clause tiles, at most
    ``MAX_CLUSTER`` of them (block q takes tiles q, q + cs, ...).  Pure:
    the CPU tests check it."""
    return max(1, min(-(-R // TILE), MAX_CLUSTER))


def fused_bulk(W: int, R: int, aligned: bool, bulk_smem: int) -> bool:
    """Whether the kernel stages each warp's include rows in one bulk copy:
    W and R multiples of 4, the operands 16-byte aligned and the whole
    rows within shared memory (``bulk_smem`` bytes with them); else it
    copies 4 bytes at a time, 64 words a pass."""
    return (W % 4 == 0 and R % 4 == 0 and aligned
            and bulk_smem <= SMEM_LIMIT)


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


def _int32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: the tensor itself when it is
    contiguous int32, else a contiguous int32 copy."""
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def prepare_fused_step(lit, inc, weights, labels, neg, rand, cl_mask,
                       h_mask, T, w_frozen, rand_bits: int = 16,
                       n_bits=None, geometry=None):
    """(launch or None, (clause, sums, sel_lab, sel_neg)) of
    :func:`fused_step` on CUDA operands; the outputs hold the result once
    ``launch()`` has run.  Raises for a shape the kernel does not take.
    ``geometry`` ({"cluster"}) replaces :func:`fused_split`'s choice."""
    args = (lit, inc, weights, labels, neg, rand, cl_mask, h_mask, T,
            w_frozen)
    K, B, R, W, H, n_bits = _check(*args, rand_bits, n_bits)
    if lit.dtype != torch.int32 or inc.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {lit.dtype}, "
                        f"{inc.dtype}")
    dev = lit.device
    clause = torch.empty((K, B, R), dtype=torch.int32, device=dev)
    sums = torch.empty((K, B, H), dtype=torch.int32, device=dev)
    sel_lab = torch.empty_like(clause)
    sel_neg = torch.empty_like(clause)
    outs = (clause, sums, sel_lab, sel_neg)
    if clause.numel() == 0 or H == 0:
        return None, outs
    if K > 65535 or -(-B // ROWS) > 65535:
        raise ValueError(f"K={K}, B={B} exceed the grid's z or y limit")
    lib, fn = _build.entry("fused_step", "dtm_fused_step", _ARGTYPES)
    _, smem_fn = _build.entry("fused_step", "dtm_fused_step_smem",
                              [ctypes.c_int] * 3, ctypes.c_size_t)
    ops_ = [_int32(t) for t in args]
    aligned = all(ops_[i].data_ptr() % 16 == 0 for i in (1, 2, 5, 6))
    bulk = fused_bulk(W, R, aligned, smem_fn(H, W, 1))
    if smem_fn(H, W, int(bulk)) > SMEM_LIMIT:
        raise ValueError(f"H={H} classes overflow the kernel's shared memory")
    cluster = _build.geometry_override(geometry, ("cluster",),
                                       "fused_step").get("cluster") \
        or fused_split(R)
    cargs = ([t.data_ptr() for t in ops_] + [t.data_ptr() for t in outs]
             + [K, B, R, W, H, n_bits, int(rand_bits), cluster, int(bulk)])

    def launch():
        status = fn(*cargs, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, status, "dtm_fused_step")
        fused_step.launches += 1
    launch.keep = (ops_, outs)      # the tensors its pointers point into
    return launch, outs


def fused_step(lit: torch.Tensor, inc: torch.Tensor, weights: torch.Tensor,
               labels: torch.Tensor, neg: torch.Tensor, rand: torch.Tensor,
               cl_mask: torch.Tensor, h_mask: torch.Tensor, T: torch.Tensor,
               w_frozen: torch.Tensor, rand_bits: int = 16, n_bits=None,
               geometry=None):
    """Training-step front half of K programs in one launch (module
    docstring).  Returns (clause, sums, sel_lab, sel_neg), all int32.
    Labels must lie in [0, H).  ``geometry``: :func:`prepare_fused_step`."""
    args = (lit, inc, weights, labels, neg, rand, cl_mask, h_mask, T,
            w_frozen)
    if _route(*args) == "cpu":
        _check(*args, rand_bits, n_bits)
        return fused_step_plain(*args, rand_bits=rand_bits, n_bits=n_bits)
    launch, outs = prepare_fused_step(*args, rand_bits=rand_bits,
                                      n_bits=n_bits, geometry=geometry)
    if launch is not None:
        with torch.cuda.device(lit.device):
            launch()
    return outs


fused_step.launches = 0
