"""Kernel entry points for the engine, path selection and launch counts.

Every op takes either one program's operands (``[B, W]`` literals,
``[R, W]`` include words, ...) or a bank's, with a leading program axis
K; the kernels take K directly, so a bank is one launch per kernel.  On
CPU tensors each op runs its kernel's plain version; on CUDA tensors it
launches the kernel, or raises.

:func:`select_path` picks the clause datapath in the JAX package's order
(``repro/kernels/ops.py:select_path``): a forced path first, then, when
the caller hands over its padded ``(L, R, H)`` shape, the plan of the
autotuner (:mod:`repro_torch.kernels.autotune`: ``off``, ``seed`` from
the card's cost model, or ``measure``), then the heuristics: the
GEMV-shaped edge kernel (:data:`PATH_PACKED`) when B <= 4; above it the
fused training-step kernel (:data:`PATH_FUSED`) for training and the
dense clause kernel (:data:`PATH_MXU`: ``clause_eval`` on unpacked int8
operands) for inference.  The tile kernel (:data:`PATH_PACKED_MXU`) is
what a plan picks for throughput batches, or a caller forces.  A caller
may force any of :data:`PATHS`, among them the plain datapath
(:data:`PATH_REF`: the JAX engine's ``ref`` branch, every clause,
class-sum and TA stage through its plain version on the engine's
device, :func:`ref_clause_op` and :func:`ref_step_op`), which nothing
picks by itself.  :func:`select_ta_path` picks the TA-update datapath:
the Alg-6 compacted update (:data:`TA_COMPACT`, the sparse kernel over
the active clause groups) or the dense one (:data:`TA_DENSE`: skip off,
program banks, or the streamed random words of :data:`TA_PRNG_STREAM`,
which have no compacted kernel); with a shape, a measured plan decides
between them.  The names are the JAX package's, so
``cache_report()["path_per_stage"]`` reads the same in both.
:func:`launch_counts` also counts the PRNG kernels that ``PRNG.bits``
launches: ``lfsr_bits`` (the lfsr cluster) and ``threefry_bits``, the
train step's two glue kernels, ``step_prologue`` and ``step_epilogue``
(:func:`step_prologue_op`, :func:`step_epilogue_op`), and the conv
step's TA stage, ``conv_ta_update`` (:func:`conv_ta_update_op`, two
kernels a call); a replayed CUDA graph adds the launches of its capture.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.booleanize import unpack_literals
from . import autotune as _autotune, ref
from .class_sum import class_sum
from .clause_eval import clause_eval
from .conv_ta import conv_ta_update, conv_ta_update_plain
from .fused_step import fused_step
from .lfsr import lfsr_bits
from .packed_clause import packed_clause_eval, packed_clause_tile
from .step_glue import (active_groups, step_epilogue, step_epilogue_plain,
                        step_prologue, step_prologue_plain,
                        weights_and_stats_plain)
from .ta_update import (GROUP, stream_rands, ta_update, ta_update_plain,
                        ta_update_sparse, ta_update_sparse_plain,
                        ta_update_streamed, ta_update_streamed_plain)
from .threefry import threefry_bits
from .tm_infer import tm_infer

PATH_MXU = "mxu"                  # dense kernel: clause_eval (int8 operands)
PATH_PACKED = "packed_vpu"        # edge kernel: packed_clause_eval
PATH_PACKED_MXU = "mxu_popcount"  # tile kernel: packed_clause_tile
PATH_FUSED = "fused"              # training front half: fused_step
PATH_REF = "ref"                  # plain versions only (forced, never picked)
PATHS = (PATH_MXU, PATH_PACKED, PATH_PACKED_MXU, PATH_FUSED,
         PATH_REF)                                            # forceable

TA_DENSE = "dense"
TA_COMPACT = "compact"

TA_PRNG_INKERNEL = "inkernel"     # TA random words made in the kernel
TA_PRNG_STREAM = "stream"         # ... read from a pre-made [K, 2B, C, L]
TA_PRNGS = (TA_PRNG_INKERNEL, TA_PRNG_STREAM)

# At and below this per-program batch the include bitplane is used by so
# few literal rows that the GEMV shape wins (the JAX package's threshold;
# the card's measured crossovers are in PERF.md).
PACKED_MAX_BATCH = 4

_WRAPPERS = {"packed_clause_eval": packed_clause_eval,
             "packed_clause_tile": packed_clause_tile,
             "class_sum": class_sum,
             "fused_step": fused_step,
             "ta_update": ta_update,
             "ta_update_sparse": ta_update_sparse,
             "clause_eval": clause_eval,
             "tm_infer": tm_infer,
             "ta_update_streamed": ta_update_streamed,
             "lfsr_bits": lfsr_bits,
             "threefry_bits": threefry_bits,
             "step_prologue": step_prologue,
             "step_epilogue": step_epilogue,
             "conv_ta_update": conv_ta_update}


def select_path(batch, force: Optional[str] = None, training: bool = False,
                lanes: int = 1, shape=None, autotune: str = "seed",
                cache=None, device=None) -> str:
    """Clause datapath for a per-program ``batch`` (None: unknown, the
    throughput default).  ``force`` (one of :data:`PATHS`) overrides the
    choice at every batch: a forced packed path makes the training front
    half run the packed stages on that clause kernel, a forced ``mxu``
    the unfused dense front half, a forced ``ref`` the plain stages; the
    engine maps ``fused`` to ``mxu`` for its eval stages.  Otherwise, with
    ``shape`` = the engine's padded ``(L, R, H)``, the ``autotune`` plan
    (``off`` | ``seed`` | ``measure``; ``cache``: its file; ``device``:
    where ``measure`` times) for the stage ``train`` or ``eval`` decides;
    without a plan the heuristics do.  ``lanes`` is the bank width of the
    launch: the edge-regime test stays on the per-program batch."""
    if force is not None:
        if force not in PATHS:
            raise ValueError(f"kernel path {force!r} not recognised; use "
                             f"one of {PATHS}")
        return force
    planned = _autotune.planned_path("train" if training else "eval",
                                     batch, shape, lanes, autotune, cache,
                                     device)
    if planned in PATHS:
        return planned
    if batch is not None and batch <= PACKED_MAX_BATCH:
        return PATH_PACKED
    return PATH_FUSED if training else PATH_MXU


def select_ta_path(lanes: int = 1, skip: bool = True,
                   ta_prng: str = TA_PRNG_INKERNEL, shape=None,
                   autotune: str = "seed", cache=None, device=None) -> str:
    """TA-update datapath: dense when ``skip`` is off, the launch carries
    a bank of ``lanes`` > 1 programs (as in the JAX package, whose vmapped
    banks always take the dense update) or the random words are streamed
    (``ta_prng="stream"``: no compacted kernel reads them).  Otherwise,
    with ``shape``, a plan of the stage ``ta`` decides (only ``measure``
    makes one), else the compacted update."""
    if ta_prng not in TA_PRNGS:
        raise ValueError(f"TA prng provenance {ta_prng!r} not recognised; "
                         f"use one of {TA_PRNGS}")
    _autotune.check_mode(autotune)
    if not skip or lanes > 1 or ta_prng != TA_PRNG_INKERNEL:
        return TA_DENSE
    planned = _autotune.planned_path("ta", None, shape, lanes, autotune,
                                     cache, device)
    return planned if planned in (TA_DENSE, TA_COMPACT) else TA_COMPACT


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


def ref_clause_op(packed_literals: torch.Tensor,
                  packed_include: torch.Tensor, l_mask: torch.Tensor,
                  n_bits: int, eval_mode: bool = False) -> torch.Tensor:
    """The JAX engine's ``ref`` clause stage, bank form only: literals
    [K, N, W] and include [K, R, W] unpacked to their ``n_bits`` literals
    on the device, the violation count of the negated real literals
    (``l_mask`` [K, n_bits]) against the include, fired iff zero; in eval
    mode a clause also needs an included real literal.  -> [K, N, R]
    int32, through the plain product (no kernel)."""
    real = l_mask[:, None, :] > 0
    lits = unpack_literals(packed_literals, n_bits)
    lits = torch.where(real, lits, torch.ones_like(lits))   # never violate
    inc = unpack_literals(packed_include, n_bits) * real
    return ref.clause_eval_viol_ref(lits, inc, eval_mode)


def ref_step_op(packed_literals, packed_include, weights, labels,
                neg_labels, rand, cl_mask, h_mask, T, w_frozen, n_bits: int,
                rand_bits: int = 16):
    """The JAX engine's ``ref`` training front half, bank form only:
    ``ref.fused_step_ref`` on the literals and include unpacked to their
    ``n_bits`` literals on the device.  The other operands and the outputs
    are those of :func:`fused_step_op`."""
    lits = unpack_literals(packed_literals, n_bits)
    inc = unpack_literals(packed_include, n_bits)
    return ref.fused_step_ref(lits, inc, weights, labels, neg_labels,
                              rand[:, 0], rand[:, 1], cl_mask, h_mask, T,
                              w_frozen, rand_bits)


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
                  rand_bits: int = 16, n_bits: Optional[int] = None,
                  geometry: Optional[dict] = None):
    """Training-step front half in ONE launch: packed literals
    [(K,) B, W], include [(K,) R, W], weights [(K,) H, R], labels and
    negated labels [(K,) B], random words [(K,) 2, B, R], masks, T and
    w_frozen -> (clause, sums, sel_lab, sel_neg), all int32.
    ``geometry`` ({"cluster"}) replaces the kernel's own cluster size
    (the engine passes none: the wrapper's call is then the one without
    it)."""
    kw = {} if geometry is None else {"geometry": geometry}
    return _front(fused_step, packed_literals, packed_include, weights,
                  labels, neg_labels, rand, cl_mask, h_mask, T, w_frozen,
                  rand_bits=rand_bits, n_bits=n_bits, **kw)


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
                 stream: bool = False, plain: bool = False):
    """Dense batched TA update of K programs (``ta`` [K, C, L], packed
    ``lits`` [K, 2B, W], ``cl``/``t1``/``t2`` [K, 2B, C]) with in-kernel
    streams.  Returns ``(new_ta, new_inc)``, the include bitplane emitted
    by the same launch; new tensors, the inputs stay as they were.

    ``stream=True`` runs the streamed baseline: the same random words are
    made first as a [K, 2B, C, L] int32 tensor (``ref.ta_rand_stream``,
    keyed on the kernel's padded stride and ``row0``) and the update reads
    them from device memory.  The results are the same.  ``plain`` runs
    the plain versions on any device (the ``ref`` path)."""
    if not stream:
        fn = ta_update_plain if plain else ta_update
        return fn(ta, lits, cl, t1, t2, l_mask, seed, p_ta, boost, n_states,
                  row0, rand_bits=rand_bits, prng=prng, lfsr_bits=lfsr_bits,
                  seed_refresh=seed_refresh)
    K, C, L = ta.shape
    rands = stream_rands(K, lits.shape[1], C, L, seed, ta.device, row0,
                         rand_bits=rand_bits, prng=prng, lfsr_bits=lfsr_bits,
                         seed_refresh=seed_refresh)
    fn = ta_update_streamed_plain if plain else ta_update_streamed
    return fn(ta, lits, cl, t1, t2, l_mask, rands, p_ta, boost, n_states)


def ta_update_compact_op(ta, lits, cl, t1, t2, l_mask, inc, seed, p_ta,
                         boost, n_states, row0=0, rand_bits: int = 16,
                         prng: str = "counter", lfsr_bits: int = 24,
                         seed_refresh: bool = True, inplace: bool = False,
                         plain: bool = False, groups=None):
    """Clause-skip TA update (Alg 6): the same states and include bitplane
    as :func:`ta_update_op`, but only the 128-row clause groups that get
    feedback are touched (``inc`` must be the include bitplane of ``ta``).
    The group list and its count are built on the device
    (:func:`active_groups`, or ``groups``: the ``(tile_idx, count)`` that
    :func:`step_epilogue_op` made), and the kernel reads the count there.
    Returns ``(new_ta, new_inc)``: with ``inplace``, ``ta`` and ``inc``
    themselves, updated in place, so the skipped groups cost nothing;
    otherwise new tensors.  ``plain`` runs the plain version on any device
    (the ``ref`` path; it reads the group count on the host)."""
    idx, count = active_groups(t1, t2) if groups is None else groups
    fn = ta_update_sparse_plain if plain else ta_update_sparse
    return fn(ta, lits, cl, t1, t2, l_mask, inc, idx, count, seed, p_ta,
              boost, n_states, row0, rand_bits=rand_bits, prng=prng,
              lfsr_bits=lfsr_bits, seed_refresh=seed_refresh, inplace=inplace)


def step_prologue_op(labels, c_rand, seed_bits, sel_rand, h_mask,
                     regression, rand_bits: int = 16, plain: bool = False):
    """The train step's glue between the draws and the front half, bank
    form (:func:`repro_torch.kernels.step_glue.step_prologue`: one launch
    on the card).  ``plain`` runs the plain version on any device (the
    ``ref`` and clause-sharded steps).  -> (labels, cls_lab, neg,
    ta_seed, sel_rand int32)."""
    fn = step_prologue_plain if plain else step_prologue
    return fn(labels, c_rand, seed_bits, sel_rand, h_mask, regression,
              rand_bits=rand_bits)


def step_epilogue_op(lits, cl, sums, sel_lab, sel_neg, sel_rand, labels,
                     cls_lab, neg, weights, cl_mask, w_frozen, w_clip, T,
                     regression, y: int = 128, rand_bits: int = 16,
                     inplace: bool = False, plain: bool = False,
                     vote_sum=None, gather=None):
    """The train step's glue between the front half and the TA update,
    bank form (:func:`repro_torch.kernels.step_glue.step_epilogue`: one
    launch on the card; ``inplace`` writes the weights over ``weights``
    there).  ``plain`` runs the plain version on any device (the ``ref``
    path and the clause-sharded step, whose collectives ``vote_sum`` and
    ``gather`` only the plain version takes).  -> (lit2, cl2, t1, t2,
    tile_idx, count, weights, stats [N_STATS, K])."""
    args = (lits, cl, sums, sel_lab, sel_neg, sel_rand, labels, cls_lab,
            neg, weights, cl_mask, w_frozen, w_clip, T, regression)
    if plain:
        return step_epilogue_plain(*args, y=y, rand_bits=rand_bits,
                                   vote_sum=vote_sum, gather=gather)
    if vote_sum is not None or gather is not None:
        raise ValueError("the collectives vote_sum and gather need "
                         "plain=True")
    return step_epilogue(*args, y=y, rand_bits=rand_bits, inplace=inplace)


def conv_ta_update_op(ta, inc, plits, cl_p, cl, sel_lab, sel_neg, weights,
                      labels, neg, patch_rand, ta_rand, l_mask, cl_mask, p_ta,
                      boost, n_states, row0: int = 0, plain: bool = False):
    """The conv train step's TA stage, bank form
    (:func:`repro_torch.kernels.conv_ta.conv_ta_update`: the patch pick
    and the TA update, two launches on the card).  ``plain`` runs the
    plain version on any device (the ``ref`` path).  -> (new_ta,
    new_inc)."""
    fn = conv_ta_update_plain if plain else conv_ta_update
    return fn(ta, inc, plits, cl_p, cl, sel_lab, sel_neg, weights, labels,
              neg, patch_rand, ta_rand, l_mask, cl_mask, p_ta, boost,
              n_states, row0=row0)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset, on the device:
    a CUDA graph's replays add the launches of its capture
    (:class:`repro_torch.core.graph.StepGraph`)."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set every wrapper's count (a graph restores them after capture)."""
    for name, fn in _WRAPPERS.items():
        fn.launches = counts[name]


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` × ``counts`` (per wrapper name) to the counts: the
    launches that ``times`` replays of a graph made."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n * times
