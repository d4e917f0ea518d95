"""The legacy TM training feedback (paper §II-B, §IV-B, Algorithms 3-6), in
PyTorch: the JAX package's ``core/feedback.py`` bit for bit.

Class level   : target class and a random negated class, two rounds a
                datapoint.
Clause level  : the integer-exact update test
                ``rand · 2T < (T ∓ clip(csum)) · 2^rand_bits``.
Weight level  : CoTM ±1 nudges of the selected firing clauses (Alg 4).
TA level      : Type I (stochastic, sensitivity s) and Type II
                (deterministic) transitions (Alg 5), one random number for
                both branches.

Two modes: ``sequential`` (a datapoint at a time against the updated
state) and ``batched`` (every datapoint against one state, the integer
deltas summed then clipped; the unit that :mod:`repro_torch.core.
distributed` all-reduces across data shards).  Clause skip (Alg 6) is
the feedback compaction of :func:`compact_round_deltas` (gather the
selected rows, update, scatter-add; clause-indexed streams keep it exact)
and the group statistics.  The DTM engine (:mod:`repro_torch.core.dtm`)
is the hot path; this core draws its TA random numbers up front per
datapoint, as the JAX core does, so its runs reproduce the JAX package's.
JAX's ``lax.scan`` loops are plain loops here; its ``vmap`` over a chunk
of datapoints is one batched expression (:func:`_datapoint_deltas`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .clause import class_sums, vanilla_polarity
from .prng import PRNG, indexed_bits
from .types import COALESCED, TMConfig, TMState, VANILLA, ta_actions

# Width of a clause group of the skip statistics.
SKIP_GROUP = 32


@dataclasses.dataclass
class FeedbackStats:
    """Diagnostics of a train step (int32 0-d tensors)."""

    selected_clauses: torch.Tensor   # clauses that received feedback
    active_groups: torch.Tensor      # groups with any feedback (Alg 6 visits)
    total_groups: torch.Tensor       # groups overall
    correct: torch.Tensor            # batch accuracy numerator (pre-update)


def _i32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# class level (Alg 3)
# ---------------------------------------------------------------------------

def negated_class(h: int, target: torch.Tensor, c_rand: torch.Tensor
                  ) -> torch.Tensor:
    """A uniform class other than ``target`` (``c_rand % (h - 1)``)."""
    rn = (c_rand % (h - 1)).to(torch.int32)
    return torch.where(rn < target, rn, rn + 1)


def select_clauses(cfg: TMConfig, csum: torch.Tensor, y_c: int,
                   sel_rand: torch.Tensor) -> torch.Tensor:
    """Clause-update decision, integer-exact: P = (T - csum)/2T on a
    target round (``y_c`` = 1), (T + csum)/2T on a negated one; ``csum``
    broadcasts against ``sel_rand`` [..., clauses]."""
    T = cfg.T
    if T >= (1 << 13):
        raise ValueError(f"T={T} exceeds the int32 fixed-point compare")
    cs = torch.clamp(csum, -T, T).to(torch.int32)
    p_num = T - cs if y_c == 1 else T + cs                     # [0, 2T]
    lhs = sel_rand.to(torch.int32) * (2 * T)
    rhs = p_num << cfg.rand_bits
    return (lhs < rhs).to(torch.int32)


# ---------------------------------------------------------------------------
# clause and TA level for one feedback round against one clause block
# ---------------------------------------------------------------------------

def round_deltas(cfg: TMConfig, include: torch.Tensor,
                 literals: torch.Tensor, clause_out: torch.Tensor,
                 weight_row: Optional[torch.Tensor], csum: torch.Tensor,
                 y_c: int, sel_rand: torch.Tensor, ta_rand: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            torch.Tensor]:
    """Deltas of one feedback round, over any leading batch axes ``...``
    (none for one datapoint; JAX's ``vmap`` of the one-datapoint round):
    include [..., c, 2f] bool (or [c, 2f], shared), literals [..., 2f],
    clause_out [..., c], CoTM weight_row [..., c], the chosen class's sum
    csum [...], ``y_c`` (1 target, 0 negated), sel_rand [..., c],
    ta_rand [..., c, 2f] -> (ta_delta [..., c, 2f] int32 in {-1, 0, 1},
    w_delta [..., c] int32 or None, selected [..., c] int32)."""
    selected = select_clauses(cfg, csum[..., None], y_c, sel_rand)
    if cfg.tm_type == COALESCED:
        sign_pos = weight_row >= 0
    else:
        sign_pos = vanilla_polarity(cfg.clauses, include.device) > 0
    # Type I reinforces the supporting clauses on target rounds and the
    # opposing ones on negated rounds; Type II the converse
    is_t1 = sign_pos if y_c == 1 else ~sign_pos
    type1 = (selected == 1) & is_t1
    type2 = (selected == 1) & ~is_t1

    cl = clause_out.bool()[..., :, None]                       # [..., c, 1]
    lit = literals.bool()[..., None, :]                        # [..., 1, 2f]
    # Type I: stochastic with sensitivity s
    p_ta = int(round((1 << cfg.rand_bits) / cfg.s))
    low = ta_rand < p_ta
    cl_and_lit = cl & lit
    inc1 = cl_and_lit if cfg.boost_true_positive else cl_and_lit & ~low
    dec1 = ~cl_and_lit & low
    d_t1 = inc1.to(torch.int32) - dec1.to(torch.int32)   # disjoint
    # Type II: deterministic include of the 0-literals of firing clauses
    d_t2 = (cl & ~lit & ~include).to(torch.int32)
    ta_delta = (type1[..., :, None].to(torch.int32) * d_t1
                + type2[..., :, None].to(torch.int32) * d_t2)

    w_delta = None
    if cfg.tm_type == COALESCED:
        # Alg 4: selected and firing -> the weight moves to the round's sign
        w_delta = (selected * clause_out.bool().to(torch.int32)
                   * (1 if y_c == 1 else -1))
    return ta_delta, w_delta, selected


def compact_round_deltas(cfg: TMConfig, include, literals, clause_out,
                         weight_row, csum, y_c: int, sel, round_key,
                         compact_k: int):
    """Alg-6 feedback compaction of one CoTM round (gather, update,
    scatter): only the at most ``compact_k`` selected clause rows get
    TA-delta math and random numbers, drawn by clause index
    (:func:`repro_torch.core.prng.indexed_bits`), so the result equals
    the dense round whenever ``#selected <= compact_k``.  Returns
    ``(d_ta_k [k, 2f] int32, idx [k] int64 — the gathered rows,
    d_w [c] int32)``."""
    if cfg.tm_type != COALESCED:
        raise ValueError("compaction is defined on the CoTM pool")
    c = sel.shape[0]
    order = sel.to(torch.int64) * (1 << 16) + torch.arange(
        c, device=sel.device)
    idx = torch.topk(order, compact_k).indices        # lax.top_k's order
    sel_k = sel.index_select(0, idx)                  # 1 real, 0 filler
    ta_rand = indexed_bits(round_key, idx, cfg.literals, cfg.rand_bits)
    # force the re-selection of exactly the gathered rows
    forced = torch.where(sel_k == 1, 0, (1 << cfg.rand_bits) - 1)
    d_ta_k, d_w_k, _ = round_deltas(
        cfg, include.index_select(0, idx), literals,
        clause_out.index_select(0, idx), weight_row.index_select(0, idx),
        csum, y_c, forced, ta_rand)
    d_ta_k = d_ta_k * sel_k[:, None]
    d_w = torch.zeros(c, dtype=torch.int32, device=sel.device)
    d_w.index_add_(0, idx, d_w_k * sel_k)
    return d_ta_k, idx, d_w


# ---------------------------------------------------------------------------
# state application
# ---------------------------------------------------------------------------

def apply_ta_delta(cfg: TMConfig, ta: torch.Tensor, delta: torch.Tensor
                   ) -> torch.Tensor:
    return torch.clamp(ta.to(torch.int32) + delta, 0,
                       cfg.n_states - 1).to(ta.dtype)


def apply_w_delta(cfg: TMConfig, w: torch.Tensor, delta: torch.Tensor
                  ) -> torch.Tensor:
    c = cfg.weight_clip
    return torch.clamp(w + delta, -c, c).to(torch.int32)


def _group_stats(selected_rows: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg 6 accounting: the SKIP_GROUP-wide clause groups with feedback,
    and the groups overall."""
    n = selected_rows.shape[0]
    s = torch.nn.functional.pad(selected_rows, (0, (-n) % SKIP_GROUP))
    g = s.reshape(-1, SKIP_GROUP).amax(dim=-1)
    return (g.sum(dtype=torch.int32),
            _i32(g.shape[0], selected_rows.device))


# ---------------------------------------------------------------------------
# per-datapoint feedback (two rounds), shared by both modes
# ---------------------------------------------------------------------------

def _datapoint_deltas(cfg: TMConfig, include, weights, literals, clause_out,
                      sums, label, c_rand, sel_rand2, ta_rand2):
    """Both rounds of n datapoints at once (JAX ``vmap``s its one-datapoint
    function over a chunk): literals [n, 2f], clause_out CoTM [n, c],
    Vanilla [n, h*c] (row-major class blocks), sums [n, h], label [n],
    c_rand [n], sel_rand2 [n, 2, c], ta_rand2 [n, 2, c, 2f].  Returns the
    deltas summed over the n datapoints: (ta_delta [rows, 2f], w_delta
    [h, c] or None, selected_rows [rows]).  Each is a sum of independent
    int32 terms, so it equals JAX's per-datapoint sum exactly."""
    h, c = cfg.classes, cfg.clauses
    dev = include.device
    neg = negated_class(h, label, c_rand)
    rows = include.shape[0]
    ta_delta = torch.zeros((rows, cfg.literals), dtype=torch.int32,
                           device=dev)
    w_delta = (None if cfg.tm_type == VANILLA
               else torch.zeros((h, c), dtype=torch.int32, device=dev))
    selected_rows = torch.zeros(rows, dtype=torch.int32, device=dev)
    for r, (cls, y_c) in enumerate(((label, 1), (neg, 0))):
        cls = cls.to(torch.int64)                                  # [n]
        csum = sums.gather(1, cls[:, None])[:, 0]                  # [n]
        if cfg.tm_type == COALESCED:
            d_ta, d_w, sel = round_deltas(
                cfg, include, literals, clause_out,
                weights.index_select(0, cls), csum, y_c,
                sel_rand2[:, r], ta_rand2[:, r])
            ta_delta += d_ta.sum(dim=0, dtype=torch.int32)
            selected_rows += sel.sum(dim=0, dtype=torch.int32)
            w_delta.index_add_(0, cls, d_w)
        else:
            # each datapoint's class block: rows cls·c + [0, c)
            blk = cls[:, None] * c + torch.arange(c, device=dev)   # [n, c]
            d_ta, _, sel = round_deltas(
                cfg, include[blk], literals, clause_out.gather(1, blk),
                None, csum, y_c, sel_rand2[:, r], ta_rand2[:, r])
            ta_delta.index_add_(0, blk.reshape(-1),
                                d_ta.reshape(-1, cfg.literals))
            selected_rows.index_add_(0, blk.reshape(-1), sel.reshape(-1))
    return ta_delta, w_delta, selected_rows


# ---------------------------------------------------------------------------
# public train steps
# ---------------------------------------------------------------------------

def _draw_round_rands(cfg: TMConfig, prng: PRNG, batch: int):
    """Random numbers of ``batch`` datapoints (two rounds each)."""
    c = cfg.clauses
    prng, c_rand = prng.bits((batch,))
    prng, sel_rand = prng.bits((batch, 2, c))
    prng, ta_rand = prng.bits((batch, 2, c, cfg.literals))
    return prng, c_rand, sel_rand, ta_rand


def train_step(cfg: TMConfig, state: TMState, prng: PRNG,
               batch: Tuple[torch.Tensor, torch.Tensor],
               mode: str = "batched", chunk: int = 8
               ) -> Tuple[TMState, PRNG, FeedbackStats]:
    """One step on ``batch`` = (literals [B, 2f] {0,1}, labels [B]):
    ``batched`` (deltas against one state, summed, then clipped; the
    random numbers drawn ``chunk`` datapoints at a time) or
    ``sequential``.  Returns (state, PRNG, stats)."""
    literals, labels = batch
    if mode == "sequential":
        return _train_sequential(cfg, state, prng, literals, labels)
    if mode != "batched":
        raise ValueError(f"mode={mode!r}; use batched or sequential")
    return _train_batched(cfg, state, prng, literals, labels, chunk)


def batched_deltas(cfg: TMConfig, state: TMState, prng: PRNG,
                   literals: torch.Tensor, labels: torch.Tensor, chunk: int):
    """The batched-mode integer deltas, not applied: the unit
    :mod:`repro_torch.core.distributed` sums across data shards.  Returns
    (prng, d_ta [rows, 2f] int32, d_w [h, c] int32 or None, d_sel [rows],
    correct)."""
    B = literals.shape[0]
    if B % chunk:
        raise ValueError(f"batch {B} is not a multiple of chunk {chunk}")
    sums, clause_out = class_sums(cfg, state, literals, eval_mode=False)
    if cfg.tm_type == VANILLA:
        clause_out = clause_out.reshape(B, -1)                # [B, h*c]
    include = ta_actions(cfg, state.ta)
    labels = labels.to(torch.int32)
    correct = (torch.argmax(sums, dim=-1) == labels).sum(dtype=torch.int32)
    dev = state.ta.device
    rows = state.ta.shape[0]
    acc_ta = torch.zeros((rows, cfg.literals), dtype=torch.int32, device=dev)
    acc_w = (None if cfg.tm_type == VANILLA else
             torch.zeros((cfg.classes, cfg.clauses), dtype=torch.int32,
                         device=dev))
    acc_sel = torch.zeros(rows, dtype=torch.int32, device=dev)
    for c0 in range(0, B, chunk):          # JAX's lax.scan over chunks
        prng, c_rand, sel_rand, ta_rand = _draw_round_rands(cfg, prng, chunk)
        b = slice(c0, c0 + chunk)
        d_ta, d_w, sel = _datapoint_deltas(
            cfg, include, state.weights, literals[b], clause_out[b],
            sums[b], labels[b], c_rand, sel_rand, ta_rand)
        acc_ta += d_ta
        if acc_w is not None:
            acc_w += d_w
        acc_sel += sel
    return prng, acc_ta, acc_w, acc_sel, correct


def apply_deltas(cfg: TMConfig, state: TMState, acc_ta, acc_w, acc_sel,
                 preds_correct) -> Tuple[TMState, FeedbackStats]:
    new_ta = apply_ta_delta(cfg, state.ta, acc_ta)
    new_w = (state.weights if cfg.tm_type == VANILLA
             else apply_w_delta(cfg, state.weights, acc_w))
    active, total = _group_stats((acc_sel > 0).to(torch.int32))
    stats = FeedbackStats(acc_sel.sum(dtype=torch.int32), active, total,
                          _i32(preds_correct, acc_sel.device))
    return TMState(new_ta, new_w), stats


def _train_batched(cfg, state, prng, literals, labels, chunk):
    prng, acc_ta, acc_w, acc_sel, correct = batched_deltas(
        cfg, state, prng, literals, labels, chunk)
    new_state, stats = apply_deltas(cfg, state, acc_ta, acc_w, acc_sel,
                                    correct)
    return new_state, prng, stats


def _train_sequential(cfg, state, prng, literals, labels):
    """One datapoint at a time, each against the state the last one
    left."""
    dev = state.ta.device
    nsel, nact, ntot, ncorr = (_i32(0, dev) for _ in range(4))
    labels = labels.to(torch.int32)
    for b in range(literals.shape[0]):
        lit, lab = literals[b], labels[b]
        sums, clause_out = class_sums(cfg, state, lit[None], eval_mode=False)
        include = ta_actions(cfg, state.ta)
        sums, clause_out = sums[0], clause_out.reshape(-1)
        ncorr = ncorr + (torch.argmax(sums) == lab).to(torch.int32)
        prng, c_rand, sel_rand, ta_rand = _draw_round_rands(cfg, prng, 1)
        d_ta, d_w, sel = _datapoint_deltas(
            cfg, include, state.weights, lit[None], clause_out[None],
            sums[None], lab[None], c_rand, sel_rand, ta_rand)
        new_w = (state.weights if cfg.tm_type == VANILLA
                 else apply_w_delta(cfg, state.weights, d_w))
        state = TMState(apply_ta_delta(cfg, state.ta, d_ta), new_w)
        a, t = _group_stats((sel > 0).to(torch.int32))
        nsel = nsel + sel.sum(dtype=torch.int32)
        nact, ntot = nact + a, ntot + t
    return state, prng, FeedbackStats(nsel, nact, ntot, ncorr)
