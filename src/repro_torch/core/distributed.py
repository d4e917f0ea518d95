"""Distributed TM training and the port's collectives, on
``torch.distributed``: the JAX package's ``core/distributed.py``.

The JAX package runs one controller over a device mesh and splits arrays
with ``shard_map``; the port runs one process per device (SPMD), every
process the same code, over a ``DeviceMesh``
(:mod:`repro_torch.launch.mesh`) whose ``get_group(axis)`` carries the
collectives.  The caller starts the process group; nothing here does.
Every rank is handed the same replicated inputs (state, literals,
labels) and returns the same result, which is what the JAX controller
returns.

* :func:`dp_train_step` — the batch split over one axis: each rank
  takes the feedback of its datapoints against the replicated state,
  and the integer TA/weight deltas are all-reduced (the TM's gradient
  all-reduce, integer; for a local batch <= 63 the TA deltas fit int8).
* :func:`pod_train_step` — CoTM clause rows over ``model`` and the batch
  over ``data`` (and ``pod``): only the [b, h] partial class sums cross
  ``model``, only the deltas cross the data axes; each rank's delta
  window is then gathered so every rank holds the new state.
* :func:`compact_rows_psum` — the Alg-6 wire compaction of a row-sparse
  delta all-reduce (exact dense fallback on overflow).

The collectives themselves are :mod:`repro_torch.core.collectives`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import feedback, threefry
from .collectives import Groups, all_sum, gather_dim
from .prng import M32, LFSRState, PRNG, _seed_lanes, indexed_bits
from .types import COALESCED, TMConfig, TMState, VANILLA


# ---------------------------------------------------------------------------
# Alg-6 wire compaction
# ---------------------------------------------------------------------------

def compact_rows_psum(d: torch.Tensor, groups: Groups, frac: float
                      ) -> torch.Tensor:
    """Alg-6 wire compaction of a row-sparse integer delta all-reduce.

    ``d`` [rows, ...] per-rank integer deltas, ``groups`` the process
    group(s) to reduce over, ``frac`` the capacity fraction.  The ranks
    first all-reduce the [rows] active-row bitmap; when the union of
    active rows fits ``k = max(1, rows * frac)``, only k rows cross the
    wire (gather, all-reduce, scatter), else the dense all-reduce runs:
    exact either way.  JAX's ``lax.cond`` is a Python branch on the
    union's size, read on the host from the reduced bitmap, so every rank
    takes the same branch and the collectives stay matched.  ``frac <=
    0`` (or a capacity that cannot beat dense) is the dense all-reduce."""
    rows = d.shape[0]
    k = max(1, int(rows * frac))
    if frac <= 0 or k >= rows:
        return all_sum(d, groups)
    nz = (d != 0).reshape(rows, -1).any(dim=1).to(torch.int32)
    act = all_sum(nz, groups) > 0
    n_act = int(act.sum())  # dtmlint: disable=DTM003 (the branch: every rank reads the same union)
    if n_act > k:
        return all_sum(d, groups)
    # the active rows first, in order, then row rows-1 (JAX's fill value)
    pos = torch.cumsum(act.to(torch.int64), dim=0) - 1
    dest = torch.where(act, pos, torch.full_like(pos, k))
    ridx = torch.full((k + 1,), rows - 1, dtype=torch.int64, device=d.device)
    ridx.scatter_(0, dest, torch.arange(rows, device=d.device))
    ridx = ridx[:k]
    g = all_sum(d.index_select(0, ridx), groups)
    # the filler rows are row rows-1's sum or zero: written as the real
    # rows only, so no index is written twice
    return torch.zeros_like(d).index_copy_(0, ridx[:n_act], g[:n_act])


# ---------------------------------------------------------------------------
# per-shard streams
# ---------------------------------------------------------------------------

def _shard_prng(cfg: TMConfig, seed: int, idx: int, device=None) -> PRNG:
    """An independent stream per shard: the master seed combined with the
    shard index, as the JAX package makes it (lfsr: ``seed ^ (idx +
    0x9E37)`` seeds a cluster of max(1024, 2·clauses) lanes; counter:
    ``seed ^ idx·0x85EBCA6B``; threefry: ``fold_in(PRNGKey(seed), idx)``)."""
    cfg_args = (cfg.lfsr_bits, cfg.rand_bits, cfg.seed_refresh)
    if cfg.prng_backend == "lfsr":
        n_lanes = max(1024, cfg.clauses * 2)
        base = torch.tensor((seed & M32) ^ ((idx + 0x9E37) & M32),
                            dtype=torch.int64, device=device)
        st = LFSRState(_seed_lanes(base, n_lanes, cfg.lfsr_bits), base,
                       torch.zeros((), dtype=torch.int64, device=device))
        return PRNG("lfsr", *cfg_args, st)
    if cfg.prng_backend == "counter":
        st = torch.tensor((seed & M32) ^ ((idx * 0x85EBCA6B) & M32),
                          dtype=torch.int64, device=device)
        return PRNG("counter", *cfg_args, st)
    if cfg.prng_backend == "threefry":
        return PRNG("threefry", *cfg_args,
                    threefry.fold_in(threefry.key(seed, device), idx))
    raise ValueError(f"prng_backend={cfg.prng_backend!r} not recognised; "
                     "use lfsr, counter, or threefry")


def _axis(mesh, axis: str):
    """(group, size, this rank's index) of one mesh axis."""
    return (mesh.get_group(axis), dist.get_world_size(mesh.get_group(axis)),
            mesh.get_local_rank(axis))


def dp_train_step(cfg: TMConfig, state: TMState, literals: torch.Tensor,
                  labels: torch.Tensor, mesh, seed: int, chunk: int = 4,
                  int8_wire: bool = True, axis: str = "data",
                  compact_frac: float = 0.0):
    """Data-parallel batched step over one mesh axis: rank i of ``axis``
    takes datapoints ``[i·b, (i+1)·b)`` of the replicated batch with the
    stream ``_shard_prng(cfg, seed, i)``; the deltas are summed over the
    axis (``int8_wire``: the TA deltas pass through int8, exact while
    2·b <= 127; ``compact_frac`` > 0: :func:`compact_rows_psum`) and
    applied.  Returns (state, :class:`~repro_torch.core.feedback.
    FeedbackStats`), the same on every rank."""
    group, nshards, idx = _axis(mesh, axis)
    B = literals.shape[0]
    if B % nshards:
        raise ValueError(f"batch {B} does not split over {nshards} "
                         f"'{axis}' shards")
    local_b = B // nshards
    rows = slice(idx * local_b, (idx + 1) * local_b)
    prng = _shard_prng(cfg, seed, idx, state.ta.device)
    st = TMState(state.ta, None if cfg.tm_type == VANILLA else state.weights)
    _, d_ta, d_w, d_sel, corr = feedback.batched_deltas(
        cfg, st, prng, literals[rows], labels[rows], chunk)
    if int8_wire and 2 * local_b <= 127:   # exact: |delta| <= 2·local_b
        d_ta = d_ta.to(torch.int8).to(torch.int32)
    d_ta = compact_rows_psum(d_ta, group, compact_frac)
    if d_w is not None:
        d_w = all_sum(d_w, group)
    d_sel = all_sum(d_sel, group)
    corr = all_sum(corr.reshape(1), group)[0]
    return feedback.apply_deltas(cfg, state, d_ta, d_w, d_sel, corr)


# ---------------------------------------------------------------------------
# pod-scale CoTM step: clause rows over 'model' x batch over 'data'
# ---------------------------------------------------------------------------

def pod_train_step(cfg: TMConfig, state: TMState, literals: torch.Tensor,
                   labels: torch.Tensor, mesh, seed: int,
                   compact_k: int = 0, compact_frac: float = 0.0):
    """Production-mesh CoTM step: TA rows (clauses) over ``model``, the
    batch over ``data`` (and ``pod``).  Two collective families: the
    [b, h] partial class sums over ``model`` and the integer TA/weight
    deltas over the data axes; clause eval, feedback and the deltas stay
    on the rank.  ``compact_k`` > 0: per round only the at most K
    selected clauses of a rank get TA-delta math
    (:func:`~repro_torch.core.feedback.compact_round_deltas`, exact while
    #selected <= K); ``compact_frac`` > 0: the TA-delta all-reduce rides
    :func:`compact_rows_psum`.  Every rank gets the replicated state and
    batch and returns the new state (each delta window gathered over
    ``model``) and ``{"selected", "correct"}``."""
    if cfg.tm_type != COALESCED:
        raise ValueError("pod_train_step trains the CoTM pool")
    names = tuple(mesh.mesh_dim_names)
    dp = [a for a in ("pod", "data") if a in names]
    m_group, n_model, midx = _axis(mesh, "model")
    sizes = {a: _axis(mesh, a)[1] for a in dp}
    n_data = 1
    for a in dp:
        n_data *= sizes[a]
    didx = mesh.get_local_rank(dp[0])
    if len(dp) > 1:
        didx = didx * sizes[dp[1]] + mesh.get_local_rank(dp[1])
    groups = [mesh.get_group(a) for a in dp]
    B, c = literals.shape[0], cfg.clauses
    if B % n_data or c % n_model:
        raise ValueError(f"batch {B} over {n_data} data shards, clauses "
                         f"{c} over {n_model} model shards")
    b_loc, c_loc = B // n_data, c // n_model
    cols = slice(midx * c_loc, (midx + 1) * c_loc)
    rows = slice(didx * b_loc, (didx + 1) * b_loc)
    ta, w = state.ta[cols], state.weights[:, cols]
    lit, lab = literals[rows], labels[rows].to(torch.int32)
    dev = ta.device

    include = ta >= cfg.include_threshold
    miss = 1 - lit.to(torch.int32)
    viol = (miss[:, None, :] * include[None].to(torch.int32)).sum(dim=-1)
    cl = (viol == 0).to(torch.int32)                          # [b, c_loc]
    part = (cl[:, None, :] * w[None]).sum(dim=-1, dtype=torch.int32)
    sums = all_sum(part, m_group)                             # global [b, h]
    correct = (torch.argmax(sums, dim=-1) == lab).sum(dtype=torch.int32)

    # the class draw agrees across the model shards of one datapoint;
    # the clause and TA streams are the rank's own
    c_prng, c_rand = _shard_prng(cfg, seed, didx, dev).bits((b_loc,))
    prng = _shard_prng(cfg, seed + 1, didx * n_model + midx + 17, dev)
    d_ta = torch.zeros((c_loc, cfg.literals), dtype=torch.int32, device=dev)
    d_w = torch.zeros((cfg.classes, c_loc), dtype=torch.int32, device=dev)
    d_sel = torch.zeros(c_loc, dtype=torch.int32, device=dev)
    local_rows = torch.arange(c_loc, device=dev)
    for b in range(b_loc):
        prng, sel_rand = prng.bits((2, c_loc))
        prng, round_keys = prng.bits((2,))     # seeds of the indexed streams
        neg = feedback.negated_class(cfg.classes, lab[b], c_rand[b])
        for r, (cls, y_c) in enumerate(((lab[b], 1), (neg, 0))):
            cls = cls.reshape(1).to(torch.int64)
            csum = sums[b].index_select(0, cls)[0]
            w_row = w.index_select(0, cls)[0]
            if compact_k <= 0:
                ta_rand = indexed_bits(
                    round_keys[r], local_rows, cfg.literals, cfg.rand_bits)
                d, dw, sel = feedback.round_deltas(
                    cfg, include, lit[b], cl[b], w_row, csum, y_c,
                    sel_rand[r], ta_rand)
                d_ta += d
            else:
                sel = feedback.select_clauses(cfg, csum, y_c, sel_rand[r])
                d_k, idx, dw = feedback.compact_round_deltas(
                    cfg, include, lit[b], cl[b], w_row, csum, y_c, sel,
                    round_keys[r], compact_k)
                d_ta.index_add_(0, idx, d_k)
            d_w.index_add_(0, cls, dw[None])
            d_sel += sel
    # the integer deltas summed over the batch shards; the [c_loc, 2f]
    # TA deltas optionally through the wire compaction
    d_ta = compact_rows_psum(d_ta, groups, compact_frac)
    d_w, d_sel = all_sum(d_w, groups), all_sum(d_sel, groups)
    correct = all_sum(correct.reshape(1), groups)[0]
    # every rank's window of the deltas, joined over 'model'
    d_ta = gather_dim(d_ta, m_group, 0)
    d_w = gather_dim(d_w, m_group, 1)
    d_sel = gather_dim(d_sel, m_group, 0)
    new_state = TMState(feedback.apply_ta_delta(cfg, state.ta, d_ta),
                        feedback.apply_w_delta(cfg, state.weights, d_w))
    return new_state, {"selected": d_sel.sum(dtype=torch.int32),
                       "correct": correct}
