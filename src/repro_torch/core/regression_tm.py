"""Regression Tsetlin Machine (Abeyrathna et al., arXiv:1905.04206) on the
legacy training core, in PyTorch: the JAX package's ``core/
regression_tm.py`` bit for bit.

Every clause votes positively; the prediction is the clipped vote count
over ``T``, mapped onto [0, 1].  Feedback is error-driven: under the
target, Type I goes to random clauses with probability (target − pred)/2T;
over it, Type II with (pred − target)/2T, the integer compare of Alg 3
with the error in place of the class-sum margin.  The engine's
``TMSpec.regression`` (a program flag on the DTM engine) is the hot path;
this module is the standalone reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .clause import clause_outputs_matmul
from .device import Device, resolve_device
from .prng import PRNG
from .types import COALESCED, TMConfig, TMState, init_state, ta_actions


@dataclasses.dataclass(frozen=True)
class RegressionTMConfig:
    features: int = 32
    clauses: int = 128
    T: int = 128                  # vote budget == output resolution
    s: float = 3.0
    ta_bits: int = 8
    rand_bits: int = 16
    prng_backend: str = "counter"
    boost_true_positive: bool = True

    def tm_config(self) -> TMConfig:
        return TMConfig(tm_type=COALESCED, features=self.features,
                        clauses=self.clauses, classes=2, T=min(self.T, 8191),
                        s=self.s, ta_bits=self.ta_bits,
                        rand_bits=self.rand_bits,
                        prng_backend=self.prng_backend,
                        boost_true_positive=self.boost_true_positive)


def init(cfg: RegressionTMConfig, key, device: Device = None
         ) -> Tuple[TMState, PRNG]:
    """TA states from the threefry ``key`` (weights dropped: the votes are
    unweighted) and the PRNG of seed 1, on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    tm = cfg.tm_config()
    state = init_state(tm, key, device=dev)
    return TMState(state.ta, None), PRNG.create(tm, 1, device=dev)


def _votes(cfg: RegressionTMConfig, state: TMState, literals: torch.Tensor,
           eval_mode: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    tm = cfg.tm_config()
    include = ta_actions(tm, state.ta)
    cl = clause_outputs_matmul(tm, include, literals, eval_mode)
    return torch.clamp(cl.sum(dim=-1, dtype=torch.int32), 0, cfg.T), cl


def predict(cfg: RegressionTMConfig, state: TMState, literals: torch.Tensor,
            eval_mode: bool = True) -> torch.Tensor:
    """literals [B, 2f] -> prediction in [0, 1] float32 (votes / T)."""
    votes, _ = _votes(cfg, state, literals, eval_mode)
    return votes.to(torch.float32) / cfg.T


def train_step(cfg: RegressionTMConfig, state: TMState, prng: PRNG,
               literals: torch.Tensor, targets) -> Tuple[TMState, PRNG, dict]:
    """One batched-delta step; ``targets`` [B] in [0, 1].  Returns (state,
    PRNG, {"mae": float32 0-d})."""
    tm = cfg.tm_config()
    B = literals.shape[0]
    dev = state.ta.device
    include = ta_actions(tm, state.ta)
    votes, cl = _votes(cfg, state, literals, eval_mode=False)       # [B]
    targets = torch.as_tensor(targets, device=dev).to(torch.float32)
    tgt = torch.round(targets * cfg.T).to(torch.int32)   # half to even
    err = tgt - votes                                               # [B]

    prng, sel_rand = prng.bits((B, tm.clauses))
    prng, ta_rand = prng.bits((B, tm.clauses, tm.literals))

    # P(update clause) = |err| / 2T, in int32 as the JAX compare
    lhs = sel_rand.to(torch.int32) * (2 * cfg.T)
    rhs = err.abs()[:, None] << cfg.rand_bits
    sel = lhs < rhs                                                 # [B, C]
    t1 = sel & (err > 0)[:, None]                                   # grow
    t2 = sel & (err < 0)[:, None]                                   # prune

    p_ta = int(round((1 << cfg.rand_bits) / cfg.s))
    low = ta_rand < p_ta
    clb = cl.bool()[:, :, None]                                     # [B,C,1]
    litb = literals.bool()[:, None, :]                              # [B,1,2f]
    cl_and_lit = clb & litb
    inc1 = cl_and_lit if cfg.boost_true_positive else cl_and_lit & ~low
    dec1 = ~cl_and_lit & low
    d1 = inc1.to(torch.int32) - dec1.to(torch.int32)
    inc2 = (clb & ~litb & ~include[None]).to(torch.int32)
    delta = (t1[:, :, None] * d1 + t2[:, :, None] * inc2).sum(
        dim=0, dtype=torch.int32)
    new_ta = torch.clamp(state.ta.to(torch.int32) + delta, 0,
                         tm.n_states - 1).to(state.ta.dtype)
    mae = err.abs().to(torch.float32).mean() / cfg.T
    return TMState(new_ta, None), prng, {"mae": mae}
