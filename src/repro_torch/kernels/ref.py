"""Plain PyTorch oracles for the inference kernels (bit-exact, integer).

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
    """Popcount-as-matmul recast of :func:`packed_clause_eval_ref`:
    ``viol[b, c] = Σ_l inc[c, l]·(1 − lit[b, l])``, fired iff viol == 0.

    The product runs in float32 because PyTorch has no integer matmul on
    the card.  It is exact: every term is 0 or 1, and the count is below
    2^24 (checked)."""
    if n_bits is not None:
        packed_include = tail_mask_words(packed_include, n_bits)
    n = 32 * packed_include.shape[-1]
    if n >= (1 << 24):
        raise ValueError(f"{n} literals exceed float32's exact integer range")
    lit = unpack_bitplanes_i8(packed_literals).to(torch.float32)
    inc = unpack_bitplanes_i8(packed_include).to(torch.float32)
    viol = torch.matmul(1.0 - lit, inc.transpose(-1, -2))
    fired = viol == 0
    if eval_mode:
        fired &= (packed_include != 0).any(dim=-1).unsqueeze(-2)
    return fired.to(torch.int32)


def class_sum_ref(clauses: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """clauses [..., B, C], weights [..., H, C] -> [..., B, H] int32,
    summed in integers."""
    prod = clauses.to(torch.int32).unsqueeze(-2) * \
        weights.to(torch.int32).unsqueeze(-3)
    return prod.sum(dim=-1, dtype=torch.int32)
