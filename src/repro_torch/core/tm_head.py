"""TM readout head over backbone features, in PyTorch: the JAX package's
``core/tm_head.py`` bit for bit.

Pooled backbone features are Booleanised with a thermometer code and a
Coalesced TM learns the classification on the legacy training core, the
backbone acting as a frozen feature extractor.  The engine's
``TMSpec.head`` is the hot path; this module is the standalone reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import feedback, threefry
from .booleanize import Booleanizer, fit_thermometer, to_literals
from .clause import predict
from .device import Device, resolve_device
from .prng import PRNG
from .types import COALESCED, TMConfig, TMState, init_state


@dataclasses.dataclass
class TMHead:
    """CoTM classifier over booleanised pooled features."""

    cfg: TMConfig
    booleanizer: Booleanizer
    state: TMState
    prng: PRNG

    @staticmethod
    def create(feature_dim: int, classes: int, calib: np.ndarray,
               therm_bits: int = 4, clauses: int = 128, T: int = 64,
               s: float = 5.0, seed: int = 0, device: Device = None
               ) -> "TMHead":
        """A head whose state and threefry PRNG a seed gives as in the JAX
        package (``PRNGKey(seed)`` and ``seed + 1``), on ``device``
        (default CUDA)."""
        dev = resolve_device(device)
        booleanizer = fit_thermometer(calib, bits=therm_bits)
        cfg = TMConfig(tm_type=COALESCED, features=feature_dim * therm_bits,
                       clauses=clauses, classes=classes, T=T, s=s,
                       prng_backend="threefry")
        state = init_state(cfg, threefry.key(seed, dev), device=dev)
        return TMHead(cfg, booleanizer, state,
                      PRNG.create(cfg, seed + 1, device=dev))

    def _literals(self, pooled) -> torch.Tensor:
        """pooled features [B, D] float -> literals [B, 2·D·bits] int8."""
        pooled = torch.as_tensor(pooled, device=self.state.ta.device)
        return to_literals(self.booleanizer(pooled))

    def train_batch(self, pooled, labels) -> feedback.FeedbackStats:
        labels = torch.as_tensor(labels, device=self.state.ta.device)
        self.state, self.prng, stats = feedback.train_step(
            self.cfg, self.state, self.prng,
            (self._literals(pooled), labels), "batched", 4)
        return stats

    def predict(self, pooled) -> torch.Tensor:
        return predict(self.cfg, self.state, self._literals(pooled))


def pool_backbone_features(hidden: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Mean-pool final hidden states [B, S, D] -> [B, D] (mask-aware)."""
    if mask is None:
        return hidden.mean(dim=1)
    m = mask.to(hidden.dtype)[..., None]
    return (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
