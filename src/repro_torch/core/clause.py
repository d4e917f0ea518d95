"""Clause and class-sum computation of the legacy training core (the
paper's Eq 1-3), in PyTorch.

The JAX package's evaluation paths, on dense {0,1} literals ``[B, 2f]``
and a bool include matrix ``[C, 2f]``:

* :func:`clause_outputs_matmul` — the violation count
  ``include @ (1 - literals)`` as an integer product; a clause fires iff
  no included literal is violated.
* :func:`clause_outputs_logical` — Eq (1), ``∧_i (L_i ∨ ¬TA_i)``, the
  oracle.
* :func:`clause_outputs_mxu_kernel` and :func:`clause_outputs_packed` —
  the kernels (``compute_backend="pallas"`` in the JAX package): the
  dense clause kernel (``clause_eval``) on int8 operands, and the edge
  kernel (``packed_clause_eval``) on literals and include packed 32 to a
  word; on CPU tensors their plain versions.
  :func:`clause_outputs_pallas` picks one by the batch, as
  :func:`repro_torch.kernels.ops.select_path` does.

Empty-clause convention: in training an all-exclude clause outputs 1, in
evaluation 0.
"""
from __future__ import annotations

import torch

from .booleanize import pack_literals
from .types import TMConfig, TMState, VANILLA, ta_actions


def clause_outputs_logical(cfg: TMConfig, include: torch.Tensor,
                           literals: torch.Tensor, eval_mode: bool
                           ) -> torch.Tensor:
    """Oracle: include [C, 2f] bool, literals [B, 2f] {0,1} -> clause
    outputs [B, C] int32."""
    lit = literals.bool()[:, None, :]
    inc = include.bool()[None, :, :]
    fired = (~inc | lit).all(dim=-1)
    if eval_mode:
        fired = fired & include.bool().any(dim=-1)[None, :]
    return fired.to(torch.int32)


def clause_outputs_matmul(cfg: TMConfig, include: torch.Tensor,
                          literals: torch.Tensor, eval_mode: bool
                          ) -> torch.Tensor:
    """violations[b, c] = Σ_l include[c, l]·(1 - literal[b, l]) as an
    exact integer sum (the JAX package's MXU recast)."""
    inc = include.to(torch.int32)
    miss = (1 - literals.to(torch.int32))
    viol = (miss[:, None, :] * inc[None, :, :]).sum(dim=-1)       # [B, C]
    fired = viol == 0
    if eval_mode:
        fired = fired & include.bool().any(dim=-1)[None, :]
    return fired.to(torch.int32)


def vanilla_polarity(clauses_per_class: int, device=None) -> torch.Tensor:
    """+1 for even-indexed clauses, -1 for odd."""
    idx = torch.arange(clauses_per_class, device=device)
    return torch.where(idx % 2 == 0, 1, -1).to(torch.int32)


def clause_outputs_mxu_kernel(cfg: TMConfig, include: torch.Tensor,
                              literals: torch.Tensor, eval_mode: bool
                              ) -> torch.Tensor:
    """The dense clause kernel (``clause_eval``) on int8 operands."""
    from repro_torch.kernels import ops as kops
    return kops.clause_eval_op(literals.to(torch.int8),
                               include.to(torch.int8), eval_mode=eval_mode)


def clause_outputs_packed(cfg: TMConfig, include: torch.Tensor,
                          literals: torch.Tensor, eval_mode: bool
                          ) -> torch.Tensor:
    """The edge kernel (``packed_clause_eval``) on literals and include
    packed 32 to a word; ``n_bits`` = 2f masks the tail of the last word."""
    from repro_torch.kernels import ops as kops
    return kops.packed_clause_eval_op(
        pack_literals(literals.to(torch.int8)),
        pack_literals(include.to(torch.int8)), eval_mode=eval_mode,
        n_bits=int(literals.shape[-1]))


def clause_fn_for_path(path: str):
    """A :func:`repro_torch.kernels.ops.select_path` decision -> the
    clause function: the edge kernel, the plain product (``ref``) or the
    dense kernel (every other path)."""
    from repro_torch.kernels import ops as kops
    if path == kops.PATH_PACKED:
        return clause_outputs_packed
    if path == kops.PATH_REF:
        return clause_outputs_matmul
    return clause_outputs_mxu_kernel


def clause_outputs_pallas(cfg: TMConfig, include: torch.Tensor,
                          literals: torch.Tensor, eval_mode: bool
                          ) -> torch.Tensor:
    """The kernel path by the batch (the JAX dispatcher without a plan):
    the edge kernel at B <= 4, the dense kernel above."""
    from repro_torch.kernels import ops as kops
    path = kops.select_path(literals.shape[0], autotune="off")
    return clause_fn_for_path(path)(cfg, include, literals, eval_mode)


def weighted_sums(clause_out: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """CoTM class sums: clause outputs [B, C] x weights [H, C] -> [B, H]
    int32, an exact integer sum (no int32 matmul on the card)."""
    return (clause_out[:, None, :].to(torch.int64)
            * weights[None].to(torch.int64)).sum(dim=-1).to(torch.int32)


def class_sums(cfg: TMConfig, state: TMState, literals: torch.Tensor,
               eval_mode: bool, clause_fn=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(class sums [B, h] int32, clause outputs): Vanilla [B, h, c], CoTM
    [B, c].  ``compute_backend="pallas"`` runs the kernels."""
    if clause_fn is None:
        clause_fn = (clause_outputs_pallas if cfg.compute_backend == "pallas"
                     else clause_outputs_matmul)
    include = ta_actions(cfg, state.ta)
    out = clause_fn(cfg, include, literals, eval_mode)             # [B, rows]
    if cfg.tm_type == VANILLA:
        out = out.reshape(out.shape[0], cfg.classes, cfg.clauses)
        pol = vanilla_polarity(cfg.clauses, out.device)
        return (out * pol).sum(dim=-1, dtype=torch.int32), out
    return weighted_sums(out, state.weights), out


def predict(cfg: TMConfig, state: TMState, literals: torch.Tensor
            ) -> torch.Tensor:
    """argmax over the class sums."""
    sums, _ = class_sums(cfg, state, literals, eval_mode=True)
    return torch.argmax(sums, dim=-1)
