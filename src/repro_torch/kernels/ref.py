"""Plain PyTorch oracles for every kernel (bit-exact, integer).

Each function mirrors the JAX package's ``repro/kernels/ref.py``
counterpart, and the CPU tests hold the two equal.  Every function here
also takes optional leading batch dimensions (the program axis K of a
bank), so the same oracle serves one program and a stacked bank.  Packed
words are int32 tensors holding uint32 bit patterns (see
:mod:`repro_torch.core.booleanize`).  They run on any device: the CUDA
kernels are held against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.booleanize import pack_literals, words_from_u32
from repro_torch.core.prng import (M32, _TAPS as LFSR_TAPS, _splitmix32,
                                   _xorshift32, lfsr_step)

NEG_INF_SUM = -(1 << 24)   # remainder class sums are pinned to this value


def clause_eval_ref(literals: torch.Tensor, include: torch.Tensor,
                    eval_mode: bool = False) -> torch.Tensor:
    """literals [..., B, L] {0,1}, include [..., C, L] {0,1} ->
    clause [..., B, C] int32."""
    lit = literals.bool().unsqueeze(-2)
    inc = include.bool().unsqueeze(-3)
    fired = (~inc | lit).all(dim=-1)
    if eval_mode:
        fired &= include.bool().any(dim=-1).unsqueeze(-2)
    return fired.to(torch.int32)


def clause_eval_viol_ref(literals: torch.Tensor, include: torch.Tensor,
                         eval_mode: bool = False) -> torch.Tensor:
    """:func:`clause_eval_ref` in the violation-count form,
    ``viol[b, c] = Σ_l (1 − lit[b, l]) · inc[c, l]``, fired iff
    ``viol == 0`` (and, in eval mode, row c has an include).  It holds
    [B, L] and [C, L] operands, never the [B, C, L] broadcast.

    The product runs in float32 because PyTorch has no integer matmul on
    the card.  It is exact: every term is 0 or 1, and the count is below
    2^24 (checked)."""
    n = literals.shape[-1]
    if n >= (1 << 24):
        raise ValueError(f"{n} literals exceed float32's exact integer range")
    neg = (literals == 0).to(torch.float32)
    inc = (include != 0).to(torch.float32)
    fired = torch.matmul(neg, inc.transpose(-1, -2)) == 0
    if eval_mode:
        fired &= (include != 0).any(dim=-1).unsqueeze(-2)
    return fired.to(torch.int32)


def pack_bitplane(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} [..., n] -> packed words [..., ceil(n/32)], little-endian."""
    return pack_literals(bits)


def pack_include(ta: torch.Tensor, n_states) -> torch.Tensor:
    """TA states [..., C, L] -> packed include bitplane [..., C, ceil(L/32)].
    The include action is ``ta >= n_states/2``; ``n_states`` is a scalar
    or one value per leading index ([...])."""
    j = torch.as_tensor(n_states, dtype=torch.int32, device=ta.device) >> 1
    return pack_bitplane(ta.to(torch.int32) >= j[..., None, None])


def tail_mask_words(packed: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Zero all bits at positions >= n_bits in a packed [..., W] bitplane.

    Zero include words never veto a clause, so masking the include side
    makes garbage tail bits harmless in both the firing and the nonempty
    checks."""
    W = packed.shape[-1]
    if not 0 < n_bits <= 32 * W:
        raise ValueError(f"n_bits={n_bits} outside (0, {32 * W}]")
    pos = torch.arange(W, dtype=torch.int64, device=packed.device) * 32
    keep = (n_bits - torch.clamp(pos, max=n_bits)).clamp(0, 32)
    mask = words_from_u32((torch.ones_like(keep) << keep) - 1)
    return packed & mask


def packed_clause_eval_ref(packed_literals: torch.Tensor,
                           packed_include: torch.Tensor,
                           eval_mode: bool = False,
                           n_bits: int | None = None) -> torch.Tensor:
    """Packed [..., B, W] × [..., C, W] -> clause [..., B, C] int32:
    a clause fires iff OR_w(inc & ~lit) == 0, and in eval mode only when
    its include row is nonempty.  ``n_bits`` (the real literal count)
    masks garbage tail bits in the include words first."""
    if n_bits is not None:
        packed_include = tail_mask_words(packed_include, n_bits)
    lit = packed_literals.unsqueeze(-2)
    inc = packed_include.unsqueeze(-3)
    fired = ((inc & ~lit) == 0).all(dim=-1)
    if eval_mode:
        fired &= (packed_include != 0).any(dim=-1).unsqueeze(-2)
    return fired.to(torch.int32)


def unpack_bitplanes_i8(packed: torch.Tensor) -> torch.Tensor:
    """Words [..., W] -> int8 {0,1} [..., W*32] (inverse of pack_bitplane)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.to(torch.int8).reshape(*packed.shape[:-1], -1)


def packed_clause_mxu_ref(packed_literals: torch.Tensor,
                          packed_include: torch.Tensor,
                          eval_mode: bool = False,
                          n_bits: int | None = None) -> torch.Tensor:
    """Popcount-as-matmul recast of :func:`packed_clause_eval_ref`: the
    violation-count form (:func:`clause_eval_viol_ref`) on the unpacked
    bitplanes."""
    if n_bits is not None:
        packed_include = tail_mask_words(packed_include, n_bits)
    return clause_eval_viol_ref(unpack_bitplanes_i8(packed_literals),
                                unpack_bitplanes_i8(packed_include),
                                eval_mode)


def class_sum_ref(clauses: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """clauses [..., B, C], weights [..., H, C] -> [..., B, H] int32,
    summed in integers."""
    prod = clauses.to(torch.int32).unsqueeze(-2) * \
        weights.to(torch.int32).unsqueeze(-3)
    return prod.sum(dim=-1, dtype=torch.int32)


def tm_infer_ref(literals: torch.Tensor, include: torch.Tensor,
                 weights: torch.Tensor, eval_mode: bool = True
                 ) -> torch.Tensor:
    """Fused inference oracle: literals [..., B, L], include [..., C, L],
    weights [..., H, C] -> unpinned class sums [..., B, H] int32."""
    return class_sum_ref(clause_eval_ref(literals, include, eval_mode),
                         weights)


# ---------------------------------------------------------------------------
# training-step front half (fused_step / packed_step oracles)
# ---------------------------------------------------------------------------

def _bcast(v, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """A per-program scalar (Python number, 0-d or [K] tensor) as a tensor
    on ``like``'s device, shaped to broadcast over two trailing axes."""
    return torch.as_tensor(v, device=like.device).to(dtype)[..., None, None]


def _round_select(sums, cls, y_c: int, rand, weights, cl_mask, T, w_frozen,
                  rand_bits: int) -> torch.Tensor:
    """Alg 3 integer-exact clause selection for one feedback round.

    sums [..., B, H], cls [..., B], rand [..., B, R] (< 2^rand_bits),
    weights [..., H, R], cl_mask [..., R], T and w_frozen [...] ->
    sel [..., B, R] int32.  int32 arithmetic, as in the reference."""
    T = _bcast(T, sums)
    csum = torch.gather(sums, -1, cls.long()[..., None])          # [.., B, 1]
    cs = torch.maximum(torch.minimum(csum, T), -T)
    p_num = T - cs if y_c == 1 else T + cs
    lhs = rand.to(torch.int32) * (2 * T)
    sel = lhs < (p_num << rand_bits)
    idx = cls.long()[..., None].expand(*cls.shape, weights.shape[-1])
    w_r = torch.gather(weights, -2, idx)                          # [.., B, R]
    frozen = _bcast(w_frozen, sums) > 0
    elig = (w_r != 0) | ~frozen
    return (sel & (cl_mask[..., None, :] > 0) & elig).to(torch.int32)


def _select_both(clause, weights, labels, neg_labels, rand_lab, rand_neg,
                 cl_mask, h_mask, T, w_frozen, rand_bits):
    """Class sums, Fig-6d pinning and both Alg-3 rounds of a clause
    matrix; the shared tail of every front-half oracle."""
    sums = class_sum_ref(clause, weights)
    sums = torch.where(h_mask[..., None, :] > 0, sums,
                       torch.full_like(sums, NEG_INF_SUM))
    sel_lab = _round_select(sums, labels, 1, rand_lab, weights, cl_mask, T,
                            w_frozen, rand_bits)
    sel_neg = _round_select(sums, neg_labels, 0, rand_neg, weights, cl_mask,
                            T, w_frozen, rand_bits)
    return clause, sums, sel_lab, sel_neg


def fused_step_ref(literals, include, weights, labels, neg_labels, rand_lab,
                   rand_neg, cl_mask, h_mask, T, w_frozen,
                   rand_bits: int = 16):
    """Training-step front half on dense {0,1} literals [..., B, L] and
    include [..., R, L]: training-mode clause eval (empty clauses fire)
    → class sums → pinning → Alg-3 selection for the target and negated
    rounds.  Returns (clause, sums, sel_lab, sel_neg), all int32."""
    clause = clause_eval_ref(literals, include) * cl_mask[..., None, :]
    return _select_both(clause, weights, labels, neg_labels, rand_lab,
                        rand_neg, cl_mask, h_mask, T, w_frozen, rand_bits)


def packed_step_ref(packed_literals, packed_include, weights, labels,
                    neg_labels, rand_lab, rand_neg, cl_mask, h_mask, T,
                    w_frozen, rand_bits: int = 16, n_bits: int | None = None,
                    mxu: bool = False):
    """:func:`fused_step_ref` on packed words [..., B, W] / [..., R, W];
    ``mxu`` evaluates clauses through the popcount recast instead."""
    eval_fn = packed_clause_mxu_ref if mxu else packed_clause_eval_ref
    clause = eval_fn(packed_literals, packed_include, eval_mode=False,
                     n_bits=n_bits) * cl_mask[..., None, :]
    return _select_both(clause, weights, labels, neg_labels, rand_lab,
                        rand_neg, cl_mask, h_mask, T, w_frozen, rand_bits)


# ---------------------------------------------------------------------------
# TA update (ta_update oracle: the in-kernel random streams, reproduced)
# ---------------------------------------------------------------------------
# uint32 values are held in int64 tensors and masked to 32 bits.

def _lfsr_seed(master, key, lfsr_bits: int):
    """Per-element lane seed: splitmix32(master ^ key), masked to the LFSR
    width and forced nonzero (a Galois LFSR locks up at 0)."""
    s = _splitmix32(master ^ key) & ((1 << lfsr_bits) - 1)
    return torch.where(s == 0, torch.ones_like(s), s)


_lfsr_advance = lfsr_step


def _lfsr_emit(lanes, lfsr_bits: int, rand_bits: int):
    """L-bit register -> rand_bits-wide comparator word (zero-extended
    when L < rand_bits, high bits truncated else)."""
    if lfsr_bits < rand_bits:
        lanes = (lanes << (rand_bits - lfsr_bits)) & M32
    elif lfsr_bits > rand_bits:
        lanes = lanes >> (lfsr_bits - rand_bits)
    return lanes & ((1 << rand_bits) - 1)


def stream_keys(C: int, L: int, xt: int = 256, row_idx=None, device=None
                ) -> torch.Tensor:
    """Per-element stream keys [..., C, L]: row * stride + col (uint32),
    stride = L rounded up to whole ``xt`` tiles.  ``row_idx`` [..., C]
    overrides the global row numbers (compaction, row offsets)."""
    stride = ((L + xt - 1) // xt) * xt
    if row_idx is None:
        row_idx = torch.arange(C, dtype=torch.int64, device=device)
    rows = torch.as_tensor(row_idx, device=device).to(torch.int64) & M32
    col = torch.arange(L, dtype=torch.int64, device=rows.device)
    return (rows[..., :, None] * stride + col) & M32


def stream_start(seed, key, prng: str, lfsr_bits: int):
    """Initial per-element stream state.  ``counter``: splitmix32(seed ^
    key) xorshift chains.  ``lfsr``: lanes seeded from (seed, key), the
    master (= seed) and the cycle count, which starts at 0 on every call
    and is therefore a plain integer."""
    seed = torch.as_tensor(seed, device=key.device).to(torch.int64) & M32
    seed = seed[..., None, None]
    if prng == "counter":
        return (_splitmix32(seed ^ key),)
    if prng != "lfsr":
        raise ValueError(f"unknown TA prng mode {prng!r}")
    return (_lfsr_seed(seed, key, lfsr_bits), seed, 0)


def stream_advance(st, key, prng: str, lfsr_bits: int, seed_refresh: bool,
                   rand_bits: int):
    """Advance one cycle and emit rand_bits-wide words (the lfsr mode
    mirrors the cluster: shift every lane; when 2^L − 1 cycles have
    passed, xorshift the master and reseed every lane from its key)."""
    if prng == "counter":
        state, = st
        state = _xorshift32(state)
        return (state,), state >> (32 - rand_bits)
    lanes, master, cycles = st
    lanes = _lfsr_advance(lanes, lfsr_bits)
    cycles += 1
    if seed_refresh and cycles >= (1 << lfsr_bits) - 1:
        master = _xorshift32(master)
        lanes = _lfsr_seed(master, key, lfsr_bits)
        cycles = 0
    return (lanes, master, cycles), _lfsr_emit(lanes, lfsr_bits, rand_bits)


def ta_rand_stream(seed, batch: int, C: int, L: int, rand_bits: int = 16,
                   prng: str = "counter", lfsr_bits: int = 24,
                   seed_refresh: bool = True, xt: int = 256, row_idx=None,
                   device=None) -> torch.Tensor:
    """The TA-update random stream as a tensor [..., batch, C, L]: the
    numbers the in-kernel generator consumes, one row per batch row, as
    int32 tensors holding their uint32 bit patterns.  Each row is written
    into one preallocated tensor as it is made (4 bytes per number)."""
    key = stream_keys(C, L, xt, row_idx, device)
    st = stream_start(seed, key, prng, lfsr_bits)
    lead = torch.broadcast_shapes(st[0].shape, key.shape)[:-2]
    out = torch.empty((*lead, batch, C, L), dtype=torch.int32,
                      device=key.device)
    for b in range(batch):
        st, rand = stream_advance(st, key, prng, lfsr_bits, seed_refresh,
                                  rand_bits)
        out[..., b, :, :] = words_from_u32(rand)
    return out


def _ta_delta_step(rand, lit_b, cl_b, t1_b, t2_b, include, p_ta, boost):
    """One batch row's Alg-5 TA delta [..., C, L] from its random words.
    rand [..., C, L], lit_b [..., L], cl/t1/t2_b [..., C], include
    [..., C, L] bool, p_ta (uint32 value) and boost [...]."""
    low = rand < p_ta
    clb = (cl_b > 0)[..., :, None]
    litb = (lit_b > 0)[..., None, :]
    cl_and_lit = clb & litb
    inc1 = torch.where(boost, cl_and_lit, cl_and_lit & ~low)
    d1 = inc1.to(torch.int32) - (~cl_and_lit & low).to(torch.int32)
    inc2 = (clb & ~litb & ~include).to(torch.int32)
    zero = torch.zeros_like(d1)
    return (torch.where((t1_b > 0)[..., :, None], d1, zero)
            + torch.where((t2_b > 0)[..., :, None], inc2, zero))


def ta_update_ref(ta, literals, clause_out, type1, type2, l_mask, seed,
                  p_ta, rand_bits: int = 16, boost=True, n_states=256,
                  xt: int = 256, row_idx=None, prng: str = "counter",
                  lfsr_bits: int = 24, seed_refresh: bool = True,
                  rands=None) -> torch.Tensor:
    """Bit-exact oracle of the TA-update kernels.

    ta [..., C, L] (any int dtype), literals [..., B, L] {0,1},
    clause_out/type1/type2 [..., B, C], l_mask [..., L]; ``seed`` and
    ``p_ta`` are uint32 values (``p_ta`` may come as its int32 bits),
    ``boost``/``n_states`` per program.  The stream of element (r, c) is
    keyed on ``row * stride + c`` with stride = L rounded up to ``xt``
    (``row_idx`` [..., C] overrides the row numbers); one stream step per
    batch row, whether or not the row gives feedback.  ``rands``
    ([..., B, C, L]) consumes pre-made randoms instead.  Returns int32
    [..., C, L]: clip(ta + Σ_b delta_b · l_mask, 0, n_states − 1)."""
    C, L = ta.shape[-2:]
    dev = ta.device
    n_states = _bcast(n_states, ta)
    p = _bcast(p_ta, ta, torch.int64) & M32
    boost = _bcast(boost, ta, torch.bool)
    ta32 = ta.to(torch.int32)
    include = ta32 >= (n_states >> 1)
    delta = torch.zeros(ta32.shape, dtype=torch.int32, device=dev)
    if rands is None:
        key = stream_keys(C, L, xt, row_idx, dev)
        st = stream_start(seed, key, prng, lfsr_bits)
    for b in range(literals.shape[-2]):
        if rands is None:
            st, rand = stream_advance(st, key, prng, lfsr_bits, seed_refresh,
                                      rand_bits)
        else:
            rand = rands[..., b, :, :].to(torch.int64) & M32
        delta = delta + _ta_delta_step(
            rand, literals[..., b, :], clause_out[..., b, :],
            type1[..., b, :], type2[..., b, :], include, p, boost)
    delta = delta * l_mask.to(torch.int32)[..., None, :]
    return torch.minimum(torch.clamp(ta32 + delta, min=0), n_states - 1)
