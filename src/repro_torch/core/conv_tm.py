"""Convolutional Tsetlin Machine (Granmo et al., arXiv:1905.09688) on the
legacy training core, in PyTorch: the JAX package's ``core/conv_tm.py``
bit for bit.

A clause evaluates on every K×K patch of the Booleanised image (literals
= patch bits + thermometer-coded patch position) and fires iff ANY patch
matches.  In training each firing clause takes ONE matching patch, whose
literals drive the Type I/II feedback; non-firing clauses take the
patch-independent 1/s decrements.  The engine's ``TMSpec.conv`` is the
hot path; this module is the standalone reference.

Where JAX scans the datapoints of a step (``lax.scan`` of ``per_point``),
this module computes every datapoint's two rounds at once and sums them:
a datapoint reads only the step's inputs and the pre-step weights and
include matrix, and only adds into the deltas, so the integer sums are
the same in any order.  Integer products are broadcast products and sums
(the card has no int32 matmul).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .clause import weighted_sums
from .device import Device, resolve_device
from .feedback import negated_class, select_clauses
from .prng import PRNG
from .types import COALESCED, TMConfig, TMState, init_state, ta_actions


@dataclasses.dataclass(frozen=True)
class ConvTMConfig:
    """Conv geometry on top of the TMConfig hyper-parameters."""

    img_h: int = 8
    img_w: int = 8
    patch: int = 3
    clauses: int = 64
    classes: int = 4
    T: int = 16
    s: float = 4.0
    ta_bits: int = 8
    weight_bits: int = 12
    rand_bits: int = 16
    prng_backend: str = "counter"
    boost_true_positive: bool = True

    @property
    def n_patches(self) -> int:
        return (self.img_h - self.patch + 1) * (self.img_w - self.patch + 1)

    @property
    def pos_bits(self) -> int:
        # thermometer-coded row + col upper-left position
        return (self.img_h - self.patch) + (self.img_w - self.patch)

    @property
    def patch_features(self) -> int:
        return self.patch * self.patch + self.pos_bits

    @property
    def literals(self) -> int:
        return 2 * self.patch_features

    def tm_config(self) -> TMConfig:
        return TMConfig(tm_type=COALESCED, features=self.patch_features,
                        clauses=self.clauses, classes=self.classes,
                        T=self.T, s=self.s, ta_bits=self.ta_bits,
                        weight_bits=self.weight_bits,
                        rand_bits=self.rand_bits,
                        prng_backend=self.prng_backend,
                        boost_true_positive=self.boost_true_positive)


def extract_patch_literals(cfg: ConvTMConfig, images) -> torch.Tensor:
    """images [B, H, W] {0,1} -> patch literals int8 [B, P, 2f_patch]."""
    images = torch.as_tensor(images)
    B, dev = images.shape[0], images.device
    k = cfg.patch
    oh, ow = cfg.img_h - k + 1, cfg.img_w - k + 1
    patches = torch.stack([images[:, di:di + oh, dj:dj + ow]
                           for di in range(k) for dj in range(k)],
                          dim=-1).reshape(B, oh * ow, k * k)
    # thermometer position bits: bit r set iff the patch row > r, cols alike
    pi = torch.arange(oh, device=dev).repeat_interleave(ow)        # [P]
    pj = torch.arange(ow, device=dev).repeat(oh)
    rt = pi[:, None] > torch.arange(oh - 1, device=dev)[None, :]
    ct = pj[:, None] > torch.arange(ow - 1, device=dev)[None, :]
    pos = torch.cat([rt, ct], dim=-1).to(torch.int8)[None].expand(B, -1, -1)
    feats = torch.cat([patches.to(torch.int8), pos], dim=-1)
    return torch.cat([feats, 1 - feats], dim=-1)


def conv_clause_outputs(cfg: ConvTMConfig, include: torch.Tensor,
                        plits: torch.Tensor, eval_mode: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """include [C, 2f], patch literals [B, P, 2f] -> (clause outputs
    [B, C], per-patch fired [B, P, C]), int32."""
    inc = include.to(torch.int32)
    miss = 1 - plits.to(torch.int32)
    viol = (miss[:, :, None, :] * inc[None, None]).sum(dim=-1)   # [B, P, C]
    fired = viol == 0
    if eval_mode:
        fired = fired & include.bool().any(dim=-1)[None, None, :]
    return fired.any(dim=1).to(torch.int32), fired.to(torch.int32)


def infer(cfg: ConvTMConfig, state: TMState, images, eval_mode: bool = True):
    """(class sums [B, H], clause outputs [B, C], fired [B, P, C], patch
    literals [B, P, 2f])."""
    tm = cfg.tm_config()
    plits = extract_patch_literals(
        cfg, torch.as_tensor(images, device=state.ta.device))
    include = ta_actions(tm, state.ta)
    cl, fired = conv_clause_outputs(cfg, include, plits, eval_mode)
    return weighted_sums(cl, state.weights), cl, fired, plits


def predict(cfg: ConvTMConfig, state: TMState, images) -> torch.Tensor:
    sums, *_ = infer(cfg, state, images, eval_mode=True)
    return torch.argmax(sums, dim=-1)


def pick_patches(fired: torch.Tensor, patch_rand: torch.Tensor
                 ) -> torch.Tensor:
    """The feedback patch per (datapoint, clause), JAX's perturbed argmax:
    fired [B, P, C], patch_rand [B, C] -> patch index [B, C] int64.  The
    noise is the same for every patch of a (datapoint, clause), so the
    first fired patch wins, and patch 0 where none fired."""
    noise = (patch_rand[:, None, :] % 997).to(torch.int32)
    score = fired * 1000 + noise % 997                            # [B, P, C]
    return torch.argmax(score.transpose(1, 2), dim=-1)


def train_step(cfg: ConvTMConfig, state: TMState, prng: PRNG, images,
               labels) -> Tuple[TMState, PRNG, dict]:
    """Batched-delta conv step (two class-update rounds a datapoint).
    Returns (state, PRNG, {"correct": int32 0-d})."""
    tm = cfg.tm_config()
    dev = state.ta.device
    labels = torch.as_tensor(labels, device=dev).to(torch.int32)
    B = labels.shape[0]
    sums, cl, fired, plits = infer(cfg, state, images, eval_mode=False)
    include = ta_actions(tm, state.ta)
    correct = (torch.argmax(sums, dim=-1) == labels).sum(dtype=torch.int32)

    prng, c_rand = prng.bits((B,))
    prng, patch_rand = prng.bits((B, cfg.clauses))
    prng, sel_rand = prng.bits((B, 2, cfg.clauses))
    prng, ta_rand = prng.bits((B, 2, cfg.clauses, cfg.literals))

    patch_idx = pick_patches(fired, patch_rand)                   # [B, C]
    sel_lits = torch.gather(
        plits, 1, patch_idx[:, :, None].expand(-1, -1, cfg.literals))
    clb = cl.bool()[:, :, None]                                   # [B, C, 1]
    litb = sel_lits.bool()                                        # [B, C, 2f]
    cl_and_lit = clb & litb
    inc2 = (clb & ~litb & ~include[None]).to(torch.int32)
    p_ta = int(round((1 << cfg.rand_bits) / cfg.s))
    neg = negated_class(cfg.classes, labels, c_rand)
    d_ta = torch.zeros_like(state.ta, dtype=torch.int32)
    d_w = torch.zeros_like(state.weights)
    for r, (cls, y_c) in enumerate(((labels, 1), (neg, 0))):
        cls = cls.to(torch.int64)
        csum = sums.gather(1, cls[:, None])                       # [B, 1]
        sel = select_clauses(tm, csum, y_c, sel_rand[:, r])       # [B, C]
        sign_pos = state.weights.index_select(0, cls) >= 0
        is_t1 = sign_pos if y_c == 1 else ~sign_pos
        t1 = ((sel == 1) & is_t1).to(torch.int32)
        t2 = ((sel == 1) & ~is_t1).to(torch.int32)
        low = ta_rand[:, r] < p_ta
        inc1 = cl_and_lit if cfg.boost_true_positive else cl_and_lit & ~low
        d1 = inc1.to(torch.int32) - (~cl_and_lit & low).to(torch.int32)
        d_ta += (t1[:, :, None] * d1 + t2[:, :, None] * inc2).sum(
            dim=0, dtype=torch.int32)
        d_w.index_add_(0, cls, sel * cl * (1 if y_c == 1 else -1))
    new_ta = torch.clamp(state.ta.to(torch.int32) + d_ta, 0,
                         tm.n_states - 1).to(state.ta.dtype)
    wc = tm.weight_clip
    new_w = torch.clamp(state.weights + d_w, -wc, wc)
    return TMState(new_ta, new_w), prng, {"correct": correct}


def init(cfg: ConvTMConfig, key, device: Device = None
         ) -> Tuple[TMState, PRNG]:
    """State from the threefry ``key`` and the PRNG of seed 1, on
    ``device`` (default CUDA)."""
    dev = resolve_device(device)
    tm = cfg.tm_config()
    return init_state(tm, key, device=dev), PRNG.create(tm, 1, device=dev)
