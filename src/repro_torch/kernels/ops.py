"""Kernel entry points for the engine, path selection and launch counts.

Every op takes either one program's operands (``[B, W]`` literals,
``[R, W]`` include words, ...) or a bank's, with a leading program axis
K; the kernels take K directly, so a bank is one launch per kernel.  On
CPU tensors each op runs its kernel's plain version; on CUDA tensors it
launches the kernel, or raises.

:func:`select_path` picks the clause datapath from the per-program batch:
the GEMV-shaped edge kernel (:data:`PATH_PACKED`) when B <= 4; above it,
the tile kernel (:data:`PATH_PACKED_MXU`) for inference and the fused
training-step kernel (:data:`PATH_FUSED`) for training.  A caller may
force any of :data:`PATHS`, the dense clause kernel (:data:`PATH_MXU`:
``clause_eval`` on unpacked int8 operands, and the unfused training front
half) among them.
:func:`select_ta_path` picks the TA-update datapath: the Alg-6 compacted
update (:data:`TA_COMPACT`, the sparse kernel over the active clause
groups) or the dense one (:data:`TA_DENSE`: skip off, program banks, or
the streamed random words of :data:`TA_PRNG_STREAM`, which have no
compacted kernel).  The names are the JAX package's, so
``cache_report()["path_per_stage"]`` reads the same in both.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import ref
from .class_sum import class_sum
from .clause_eval import clause_eval
from .fused_step import fused_step
from .packed_clause import packed_clause_eval, packed_clause_tile
from .ta_update import (GROUP, stream_rands, ta_update, ta_update_sparse,
                        ta_update_streamed)
from .tm_infer import tm_infer

PATH_MXU = "mxu"                  # dense kernel: clause_eval (int8 operands)
PATH_PACKED = "packed_vpu"        # edge kernel: packed_clause_eval
PATH_PACKED_MXU = "mxu_popcount"  # tile kernel: packed_clause_tile
PATH_FUSED = "fused"              # training front half: fused_step
PATHS = (PATH_MXU, PATH_PACKED, PATH_PACKED_MXU, PATH_FUSED)  # forceable

TA_DENSE = "dense"
TA_COMPACT = "compact"

TA_PRNG_INKERNEL = "inkernel"     # TA random words made in the kernel
TA_PRNG_STREAM = "stream"         # ... read from a pre-made [K, 2B, C, L]
TA_PRNGS = (TA_PRNG_INKERNEL, TA_PRNG_STREAM)

# At and below this per-program batch the include bitplane is used by so
# few literal rows that the GEMV shape wins (the JAX package's threshold).
PACKED_MAX_BATCH = 4

_WRAPPERS = {"packed_clause_eval": packed_clause_eval,
             "packed_clause_tile": packed_clause_tile,
             "class_sum": class_sum,
             "fused_step": fused_step,
             "ta_update": ta_update,
             "ta_update_sparse": ta_update_sparse,
             "clause_eval": clause_eval,
             "tm_infer": tm_infer,
             "ta_update_streamed": ta_update_streamed}


def select_path(batch: int, force: Optional[str] = None,
                training: bool = False) -> str:
    """Clause datapath for a per-program batch; ``force`` (one of
    :data:`PATHS`) overrides the choice at every batch.  A forced packed
    path makes the training front half run the packed stages on that
    clause kernel; a forced ``mxu`` runs the unfused dense front half.
    The engine maps a forced ``fused`` to ``mxu`` for its eval stages."""
    if force is not None:
        if force not in PATHS:
            raise ValueError(f"kernel path {force!r} not recognised; use "
                             f"one of {PATHS}")
        return force
    if batch <= PACKED_MAX_BATCH:
        return PATH_PACKED
    return PATH_FUSED if training else PATH_PACKED_MXU


def select_ta_path(lanes: int = 1, skip: bool = True,
                   ta_prng: str = TA_PRNG_INKERNEL) -> str:
    """TA-update datapath: compacted unless ``skip`` is off, the launch
    carries a bank of ``lanes`` > 1 programs (as in the JAX package,
    whose vmapped banks always take the dense update) or the random words
    are streamed (``ta_prng="stream"``: no compacted kernel reads them)."""
    if ta_prng not in TA_PRNGS:
        raise ValueError(f"TA prng provenance {ta_prng!r} not recognised; "
                         f"use one of {TA_PRNGS}")
    return (TA_COMPACT if skip and lanes == 1 and ta_prng == TA_PRNG_INKERNEL
            else TA_DENSE)


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


def clause_eval_op(literals: torch.Tensor, include: torch.Tensor,
                   eval_mode: bool = False) -> torch.Tensor:
    """Dense int8 {0,1} literals [(K,) B, L] × include [(K,) C, L] ->
    clause [(K,) B, C] int32 through the dense clause kernel."""
    return _banked(clause_eval, literals, include, eval_mode=eval_mode)


def tm_infer_op(literals: torch.Tensor, include: torch.Tensor,
                weights: torch.Tensor, eval_mode: bool = True
                ) -> torch.Tensor:
    """Fused inference in one launch: dense literals [(K,) B, L], include
    [(K,) C, L] and weights [(K,) H, C] -> unpinned class sums
    [(K,) B, H] int32."""
    return _banked(tm_infer, literals, include, weights, eval_mode=eval_mode)


def _front(fn, lits, *args, **kw):
    """Call a bank-form front-half function on one program (2-D ``lits``,
    operands without K) or a bank; outputs follow the input's form."""
    if lits.dim() == 3:
        return fn(lits, *args, **kw)
    out = fn(lits[None], *(torch.as_tensor(a)[None] for a in args), **kw)
    return tuple(o[0] for o in out)


def round_select_op(sums, cls, y_c: int, rand, weights, cl_mask, T,
                    w_frozen, rand_bits: int = 16) -> torch.Tensor:
    """Alg-3 integer-exact clause selection for one feedback round (the
    shared torch formulation on every device; leading K axis optional)."""
    return ref._round_select(sums, cls, y_c, rand, weights, cl_mask, T,
                             w_frozen, rand_bits)


def fused_step_op(packed_literals, packed_include, weights, labels,
                  neg_labels, rand, cl_mask, h_mask, T, w_frozen,
                  rand_bits: int = 16, n_bits: Optional[int] = None):
    """Training-step front half in ONE launch: packed literals
    [(K,) B, W], include [(K,) R, W], weights [(K,) H, R], labels and
    negated labels [(K,) B], random words [(K,) 2, B, R], masks, T and
    w_frozen -> (clause, sums, sel_lab, sel_neg), all int32."""
    return _front(fused_step, packed_literals, packed_include, weights,
                  labels, neg_labels, rand, cl_mask, h_mask, T, w_frozen,
                  rand_bits=rand_bits, n_bits=n_bits)


def _select_stages(cl, weights, labels, neg, rand, cl_mask, h_mask, T,
                   w_frozen, rand_bits):
    """The stages after a separate clause kernel: masking, the class-sum
    kernel, pinning and both Alg-3 rounds."""
    cl = cl * cl_mask[:, None, :]
    sums = class_sum(cl, weights)
    sums = torch.where(h_mask[:, None, :] > 0, sums,
                       torch.full_like(sums, ref.NEG_INF_SUM))
    sel_lab = round_select_op(sums, labels, 1, rand[:, 0], weights, cl_mask,
                              T, w_frozen, rand_bits)
    sel_neg = round_select_op(sums, neg, 0, rand[:, 1], weights, cl_mask, T,
                              w_frozen, rand_bits)
    return cl, sums, sel_lab, sel_neg


def _packed_step(lits, inc, weights, *rest, rand_bits=16, n_bits=None,
                 mxu=False):
    clause_fn = packed_clause_tile if mxu else packed_clause_eval
    return _select_stages(clause_fn(lits, inc, eval_mode=False,
                                    n_bits=n_bits), weights, *rest,
                          rand_bits=rand_bits)


def packed_step_op(packed_literals, packed_include, weights, labels,
                   neg_labels, rand, cl_mask, h_mask, T, w_frozen,
                   rand_bits: int = 16, n_bits: Optional[int] = None,
                   mxu: bool = False):
    """The front half of :func:`fused_step_op` as separate stages: the
    edge clause kernel (or, ``mxu``, the tile kernel), the class-sum
    kernel, pinning and the shared Alg-3 selection.  Same outputs."""
    return _front(_packed_step, packed_literals, packed_include, weights,
                  labels, neg_labels, rand, cl_mask, h_mask, T, w_frozen,
                  rand_bits=rand_bits, n_bits=n_bits, mxu=mxu)


def _unfused_step(lits, inc, weights, *rest, rand_bits=16):
    return _select_stages(clause_eval(lits, inc, eval_mode=False), weights,
                          *rest, rand_bits=rand_bits)


def unfused_step_op(literals, include, weights, labels, neg_labels, rand,
                    cl_mask, h_mask, T, w_frozen, rand_bits: int = 16):
    """The unfused front half (the fused kernel's baseline): the dense
    clause kernel on int8 {0,1} literals [(K,) B, L] and include
    [(K,) R, L], the class-sum kernel, pinning and the shared Alg-3
    selection.  The other operands and the outputs are those of
    :func:`fused_step_op`."""
    return _front(_unfused_step, literals, include, weights, labels,
                  neg_labels, rand, cl_mask, h_mask, T, w_frozen,
                  rand_bits=rand_bits)


def ta_update_op(ta, lits, cl, t1, t2, l_mask, seed, p_ta, boost, n_states,
                 row0=0, rand_bits: int = 16, prng: str = "counter",
                 lfsr_bits: int = 24, seed_refresh: bool = True,
                 stream: bool = False):
    """Dense batched TA update of K programs (``ta`` [K, C, L], packed
    ``lits`` [K, 2B, W], ``cl``/``t1``/``t2`` [K, 2B, C]) with in-kernel
    streams.  Returns ``(new_ta, new_inc)``, the include bitplane emitted
    by the same launch; new tensors, the inputs stay as they were.

    ``stream=True`` runs the streamed baseline: the same random words are
    made first as a [K, 2B, C, L] int32 tensor (``ref.ta_rand_stream``,
    keyed on the kernel's padded stride and ``row0``) and the update reads
    them from device memory.  The results are the same."""
    if not stream:
        return ta_update(ta, lits, cl, t1, t2, l_mask, seed, p_ta, boost,
                         n_states, row0, rand_bits=rand_bits, prng=prng,
                         lfsr_bits=lfsr_bits, seed_refresh=seed_refresh)
    K, C, L = ta.shape
    rands = stream_rands(K, lits.shape[1], C, L, seed, ta.device, row0,
                         rand_bits=rand_bits, prng=prng, lfsr_bits=lfsr_bits,
                         seed_refresh=seed_refresh)
    return ta_update_streamed(ta, lits, cl, t1, t2, l_mask, rands, p_ta,
                              boost, n_states)


def active_groups(t1: torch.Tensor, t2: torch.Tensor, group: int = GROUP):
    """The Alg-6 compaction on the device: clause groups of ``group`` rows
    that get Type I or II feedback from any batch row.  t1/t2 [K, 2B, C]
    -> (tile_idx int32 [K, G], the active groups first, in order; count
    int32 [K]).  No host read: cumsum and scatter."""
    K, _, C = t1.shape
    G = -(-C // group)
    rows = torch.zeros((K, G * group), dtype=torch.bool, device=t1.device)
    rows[:, :C] = ((t1 > 0) | (t2 > 0)).any(dim=1)
    grp = rows.reshape(K, G, group).any(dim=-1)
    count = grp.sum(dim=-1, dtype=torch.int32)
    pos = torch.cumsum(grp.to(torch.int64), dim=-1) - 1
    dest = torch.where(grp, pos, torch.full_like(pos, G))   # G: a spare slot
    src = torch.arange(G, dtype=torch.int32, device=t1.device).expand(K, G)
    idx = torch.zeros((K, G + 1), dtype=torch.int32, device=t1.device)
    return idx.scatter_(1, dest, src)[:, :G], count


def ta_update_compact_op(ta, lits, cl, t1, t2, l_mask, inc, seed, p_ta,
                         boost, n_states, row0=0, rand_bits: int = 16,
                         prng: str = "counter", lfsr_bits: int = 24,
                         seed_refresh: bool = True, inplace: bool = False):
    """Clause-skip TA update (Alg 6): the same states and include bitplane
    as :func:`ta_update_op`, but only the 128-row clause groups that get
    feedback are touched (``inc`` must be the include bitplane of ``ta``).
    The group list and its count are built on the device, and the kernel
    reads the count there.  Returns ``(new_ta, new_inc)``: with
    ``inplace``, ``ta`` and ``inc`` themselves, updated in place, so the
    skipped groups cost nothing; otherwise new tensors."""
    idx, count = active_groups(t1, t2)
    return ta_update_sparse(ta, lits, cl, t1, t2, l_mask, inc, idx, count,
                            seed, p_ta, boost, n_states, row0,
                            rand_bits=rand_bits, prng=prng,
                            lfsr_bits=lfsr_bits, seed_refresh=seed_refresh,
                            inplace=inplace)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
