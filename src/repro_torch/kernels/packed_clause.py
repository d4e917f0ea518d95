"""Packed clause evaluation: the Hopper kernels and their plain versions.

Two kernels compute one function on a bank of K programs,

    clause[k, b, r] = OR_w(inc[k, r, w] & ~lit[k, b, w]) == 0
                      (and, in eval mode, row r of inc is nonempty)

from packed int32 words (uint32 bit patterns), ``lit [K, B, W]`` and
``inc [K, R, W]``, to ``clause [K, B, R]`` int32:

* :func:`packed_clause_eval` — ``csrc/packed_clause.cu:packed_clause_edge``,
  a GEMV-shaped kernel for edge batches (B <= 4).  It replaces
  ``repro/kernels/packed_clause.py:packed_clause_eval``.  Bound by the
  bytes of the include bitplane it streams.
* :func:`packed_clause_tile` — ``csrc/packed_clause.cu:packed_clause_tile``,
  a GEMM-shaped tile kernel for throughput batches.  It replaces
  ``repro/kernels/packed_clause.py:packed_clause_eval_mxu``.  Bound by
  bytes at the serving shapes; the source note gives the design.

Each wrapper runs the plain version for CPU tensors, launches its kernel
for CUDA tensors, and raises for anything else: a CUDA tensor never
reaches the plain version.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

# Plain versions: the JAX package's oracles for the two Pallas kernels.
packed_clause_eval_plain = ref.packed_clause_eval_ref
packed_clause_tile_plain = ref.packed_clause_mxu_ref

_EDGE_ROWS = 4            # csrc kEdgeRows: batch rows staged per block
_SMEM_LIMIT = 48 * 1024   # static launch limit for dynamic shared memory
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _operands(lit: torch.Tensor, inc: torch.Tensor, n_bits):
    """Validate kernel operands; returns (K, B, R, W, n_bits)."""
    if lit.dim() != 3 or inc.dim() != 3:
        raise ValueError(f"expected lit [K, B, W] and inc [K, R, W], got "
                         f"{tuple(lit.shape)} and {tuple(inc.shape)}")
    if lit.dtype != torch.int32 or inc.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {lit.dtype}, "
                        f"{inc.dtype}")
    if lit.device != inc.device:
        raise ValueError(f"operands on {lit.device} and {inc.device}")
    K, B, W = lit.shape
    K2, R, W2 = inc.shape
    if K != K2 or W != W2:
        raise ValueError(f"lit {tuple(lit.shape)} and inc "
                         f"{tuple(inc.shape)} disagree on K or W")
    for name, t in (("lit", lit), ("inc", inc)):
        if t.stride(2) != 1 or (t.shape[1] > 1 and t.stride(1) != W):
            raise ValueError(f"{name} rows must be contiguous, strides "
                             f"{t.stride()}")
    n_bits = 32 * W if n_bits is None else int(n_bits)
    if not 0 < n_bits <= 32 * W:
        raise ValueError(f"n_bits={n_bits} outside (0, {32 * W}]")
    if K > 65535:
        raise ValueError(f"K={K} programs exceed the grid's z limit")
    return K, B, R, W, n_bits


def _launch(wrapper, entry: str, lit, inc, eval_mode, n_bits
            ) -> torch.Tensor:
    K, B, R, W, n_bits = _operands(lit, inc, n_bits)
    out = torch.empty((K, B, R), dtype=torch.int32, device=lit.device)
    if out.numel() == 0:
        return out
    lib = _build.load("packed_clause")
    fn = getattr(lib, entry)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(lit.device):
        stream = torch.cuda.current_stream(lit.device).cuda_stream
        status = fn(lit.data_ptr(), inc.data_ptr(), out.data_ptr(),
                    K, B, R, W, lit.stride(0), inc.stride(0), out.stride(0),
                    n_bits, int(bool(eval_mode)), stream)
    _build.check(lib, status, entry)
    wrapper.launches += 1
    return out


def _route(lit: torch.Tensor, inc: torch.Tensor) -> str:
    """'cpu' for the plain version, 'cuda' for the kernel; raises else."""
    kinds = {lit.device.type, inc.device.type}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"no kernel for operands on {lit.device} and "
                     f"{inc.device}")


def packed_clause_eval(lit: torch.Tensor, inc: torch.Tensor,
                       eval_mode: bool = False,
                       n_bits: int | None = None) -> torch.Tensor:
    """Edge-batch clause evaluation: lit [K, B, W], inc [K, R, W] ->
    clause [K, B, R] int32.  ``n_bits`` (default 32*W) masks include bits
    past the real literal count."""
    if _route(lit, inc) == "cpu":
        _operands(lit, inc, n_bits)
        return packed_clause_eval_plain(lit, inc, eval_mode, n_bits)
    if 4 * _EDGE_ROWS * lit.shape[-1] > _SMEM_LIMIT:
        raise ValueError(f"W={lit.shape[-1]} words overflow the edge "
                         "kernel's shared literal rows")
    return _launch(packed_clause_eval, "dtm_packed_clause_edge", lit, inc,
                   eval_mode, n_bits)


def packed_clause_tile(lit: torch.Tensor, inc: torch.Tensor,
                       eval_mode: bool = False,
                       n_bits: int | None = None) -> torch.Tensor:
    """Throughput-batch clause evaluation, same contract as
    :func:`packed_clause_eval`."""
    if _route(lit, inc) == "cpu":
        _operands(lit, inc, n_bits)
        return packed_clause_tile_plain(lit, inc, eval_mode, n_bits)
    return _launch(packed_clause_tile, "dtm_packed_clause_tile", lit, inc,
                   eval_mode, n_bits)


packed_clause_eval.launches = 0
packed_clause_tile.launches = 0
