"""Packed clause evaluation: the Hopper kernels and their plain versions.

Two kernels compute one function on a bank of K programs,

    clause[k, b, r] = OR_w(inc[k, r, w] & ~lit[k, b, w]) == 0
                      (and, in eval mode, row r of inc is nonempty)

from packed int32 words (uint32 bit patterns), ``lit [K, B, W]`` and
``inc [K, R, W]``, to ``clause [K, B, R]`` int32:

* :func:`packed_clause_eval` — ``csrc/packed_clause.cu:packed_clause_edge``,
  a GEMV-shaped kernel for edge batches (B <= 4; larger B runs in groups
  of 4 batch rows).  It replaces
  ``repro/kernels/packed_clause.py:packed_clause_eval``.  Bound by the
  bytes of the include bitplane it streams, and at the edge shapes by the
  latency of its one memory round trip: each lane issues all of its
  16-byte include loads and the literal words together, with no shared
  memory and no block barrier, so it takes any W; :func:`edge_geometry`
  gives the lanes per clause row and the launch.
* :func:`packed_clause_tile` — ``csrc/packed_clause.cu:packed_clause_tile``,
  a GEMM-shaped tile kernel for throughput batches: the violation counts
  are single-bit tensor-core products (``mma … .b1 .and.popc``).  It
  replaces ``repro/kernels/packed_clause.py:packed_clause_eval_mxu``.
  Bound by bytes at the serving shapes; the source note gives the design,
  :func:`tile_warps` the clause-tile height.

Each wrapper runs the plain version for CPU tensors, launches its kernel
for CUDA tensors, and raises for anything else: a CUDA tensor never
reaches the plain version.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref
from .clause_eval import sm_count

# Plain versions: the JAX package's oracles for the two Pallas kernels.
packed_clause_eval_plain = ref.packed_clause_eval_ref
packed_clause_tile_plain = ref.packed_clause_mxu_ref

EDGE_ROWS = 4             # csrc kEdgeRows: batch rows per block at most
EDGE_CHUNKS = 4           # csrc kEdgeChunks: 16-byte chunks a lane loads
EDGE_MAX_WARPS = 4        # csrc kEdgeMaxWarps
TILE_B = 32               # csrc kTileB: batch rows per tile block
MMA_ROWS = 16             # csrc kMmaRows: clause rows per warp (one m-tile)
MAX_WARPS = 4             # csrc kMaxWarps
BLOCKS_PER_SM = 2         # tile blocks an SM should hold at once
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2


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


def tile_warps(K: int, B: int, R: int, sms: int) -> int:
    """Warps of a tile block (16 clause rows each): the most, up to
    ``MAX_WARPS``, that still give ``BLOCKS_PER_SM`` blocks on each of
    ``sms`` SMs, else 1.  Pure: the CPU tests check it."""
    tiles = K * -(-B // TILE_B)
    for warps in (MAX_WARPS, 2):
        if tiles * -(-R // (MMA_ROWS * warps)) >= BLOCKS_PER_SM * sms:
            return warps
    return 1


def edge_geometry(B: int, R: int, W: int, sms: int,
                  lanes: Optional[int] = None, warps: Optional[int] = None):
    """Launch of the edge kernel: ``(lanes, rows_per_warp, warps, grid)``.

    ``lanes`` (a power of two) read one clause row: the fewest that leave
    each lane at most ``EDGE_CHUNKS`` of the row's ceil(W / 4) 16-byte
    chunks (32 at most; wider rows take passes), so a warp holds
    ``32 // lanes`` rows.  ``warps`` a block: the most, up to
    ``EDGE_MAX_WARPS``, that still give ``sms`` blocks over the groups of
    ``EDGE_ROWS`` batch rows, so a launch spreads over every SM in one
    wave.  ``grid`` = (clause blocks, batch groups).  ``lanes`` and
    ``warps``, when given, replace the computed ones (the autotuner's
    candidates); the grid follows them.  Pure: the CPU tests check it."""
    chunks = -(-W // 4)
    if lanes is None:
        lanes = 1
        while lanes < 32 and -(-chunks // lanes) > EDGE_CHUNKS:
            lanes *= 2
    rows_per_warp = 32 // lanes
    groups = -(-B // EDGE_ROWS)
    if warps is None:
        warps = next((w for w in (EDGE_MAX_WARPS, 2)
                      if groups * -(-R // (rows_per_warp * w)) >= sms), 1)
    return (lanes, rows_per_warp, warps,
            (-(-R // (rows_per_warp * warps)), groups))


def _launch(wrapper, entry: str, lit, inc, eval_mode, n_bits,
            extra=()) -> torch.Tensor:
    K, B, R, W, n_bits = _operands(lit, inc, n_bits)
    out = torch.empty((K, B, R), dtype=torch.int32, device=lit.device)
    if out.numel() == 0:
        return out
    lib, fn = _build.entry("packed_clause", entry,
                           _ARGTYPES + [ctypes.c_int] * len(extra)
                           + [ctypes.c_void_p])
    with torch.cuda.device(lit.device):
        stream = torch.cuda.current_stream(lit.device).cuda_stream
        status = fn(lit.data_ptr(), inc.data_ptr(), out.data_ptr(),
                    K, B, R, W, lit.stride(0), inc.stride(0), out.stride(0),
                    n_bits, int(bool(eval_mode)), *extra, stream)
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
                       n_bits: int | None = None,
                       geometry: Optional[dict] = None) -> torch.Tensor:
    """Edge-batch clause evaluation: lit [K, B, W], inc [K, R, W] ->
    clause [K, B, R] int32.  ``n_bits`` (default 32*W) masks include bits
    past the real literal count.  ``geometry`` ({"lanes", "warps"}, each
    optional) replaces :func:`edge_geometry`'s choice."""
    _, B, R, W, _ = _operands(lit, inc, n_bits)
    if _route(lit, inc) == "cpu":
        return packed_clause_eval_plain(lit, inc, eval_mode, n_bits)
    lanes, _, warps, (blocks, groups) = edge_geometry(
        B, R, W, sm_count(lit.device.index or 0), **_build.geometry_override(
            geometry, ("lanes", "warps"), "packed_clause_eval"))
    if groups > 65535:
        raise ValueError(f"B={B} batch rows exceed the grid's y limit")
    return _launch(packed_clause_eval, "dtm_packed_clause_edge", lit, inc,
                   eval_mode, n_bits, (lanes, warps, blocks))


def packed_clause_tile(lit: torch.Tensor, inc: torch.Tensor,
                       eval_mode: bool = False,
                       n_bits: int | None = None,
                       geometry: Optional[dict] = None) -> torch.Tensor:
    """Throughput-batch clause evaluation, same contract as
    :func:`packed_clause_eval`.  ``geometry`` ({"warps"}) replaces
    :func:`tile_warps`'s choice."""
    K, B, R, _, _ = _operands(lit, inc, n_bits)
    if _route(lit, inc) == "cpu":
        return packed_clause_tile_plain(lit, inc, eval_mode, n_bits)
    if -(-B // TILE_B) > 65535:
        raise ValueError(f"B={B} batch rows exceed the grid's y limit")
    warps = _build.geometry_override(geometry, ("warps",),
                                     "packed_clause_tile").get("warps") \
        or tile_warps(K, B, R, sm_count(lit.device.index or 0))
    return _launch(packed_clause_tile, "dtm_packed_clause_tile", lit, inc,
                   eval_mode, n_bits, (warps,))


packed_clause_eval.launches = 0
packed_clause_tile.launches = 0
