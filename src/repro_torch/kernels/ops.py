"""Kernel entry points for the engine, path selection and launch counts.

Every op takes either one program's operands (``[B, W]`` literals,
``[R, W]`` include words, ...) or a bank's, with a leading program axis
K; the kernels take K directly, so a bank is one launch per kernel.  On
CPU tensors each op runs its kernel's plain version; on CUDA tensors it
launches the kernel, or raises.

:func:`select_path` picks the clause kernel from the per-program batch:
the GEMV-shaped edge kernel (:data:`PATH_PACKED`) when B <= 4, else the
tile kernel (:data:`PATH_PACKED_MXU`).  The path names are the JAX
package's, so ``cache_report()["path_per_stage"]`` reads the same in both.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .class_sum import class_sum
from .packed_clause import packed_clause_eval, packed_clause_tile

PATH_PACKED = "packed_vpu"        # edge kernel: packed_clause_eval
PATH_PACKED_MXU = "mxu_popcount"  # tile kernel: packed_clause_tile
PATHS = (PATH_PACKED, PATH_PACKED_MXU)

# At and below this per-program batch the include bitplane is used by so
# few literal rows that the GEMV shape wins (the JAX package's threshold).
PACKED_MAX_BATCH = 4

_WRAPPERS = {"packed_clause_eval": packed_clause_eval,
             "packed_clause_tile": packed_clause_tile,
             "class_sum": class_sum}


def select_path(batch: int, force: Optional[str] = None) -> str:
    """Clause kernel for a per-program batch; ``force`` (one of
    :data:`PATHS`) overrides the choice."""
    if force is not None:
        if force not in PATHS:
            raise ValueError(f"kernel path {force!r} not recognised; use "
                             f"one of {PATHS}")
        return force
    return PATH_PACKED if batch <= PACKED_MAX_BATCH else PATH_PACKED_MXU


def _banked(fn, *args, **kw) -> torch.Tensor:
    """Run a K-axis kernel on one program's 2-D operands or a bank's 3-D."""
    if all(a.dim() == 2 for a in args):
        return fn(*(a.unsqueeze(0) for a in args), **kw)[0]
    return fn(*args, **kw)


def packed_clause_eval_op(packed_literals: torch.Tensor,
                          packed_include: torch.Tensor,
                          eval_mode: bool = False,
                          n_bits: Optional[int] = None) -> torch.Tensor:
    """Packed [(K,) B, W] × [(K,) R, W] -> clause [(K,) B, R] int32 through
    the edge kernel.  ``n_bits`` (the real literal count) masks include
    bits past it, as the JAX op does."""
    return _banked(packed_clause_eval, packed_literals, packed_include,
                   eval_mode=eval_mode, n_bits=n_bits)


def packed_clause_mxu_op(packed_literals: torch.Tensor,
                         packed_include: torch.Tensor,
                         eval_mode: bool = False,
                         n_bits: Optional[int] = None) -> torch.Tensor:
    """Same contract as :func:`packed_clause_eval_op`, through the tile
    kernel (the throughput path)."""
    return _banked(packed_clause_tile, packed_literals, packed_include,
                   eval_mode=eval_mode, n_bits=n_bits)


def class_sum_op(clauses: torch.Tensor, weights: torch.Tensor
                 ) -> torch.Tensor:
    """Clauses [(K,) B, R] × weights [(K,) H, R] -> sums [(K,) B, H] int32."""
    return _banked(class_sum, clauses, weights)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
