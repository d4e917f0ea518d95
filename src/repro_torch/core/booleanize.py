"""Booleanization and the packed literal layout.

Raw features become Boolean features by thresholding (one or more
quantile cuts per feature), and Boolean literals are packed 32 to a word,
little-endian within the word: bit ``j`` of word ``w`` is literal
``32*w + j``.

Word storage: the JAX package keeps packed words as ``uint32``.  Torch's
``uint32`` supports few operations, so the port keeps the SAME 32 bits in
``torch.int32`` tensors.  Bitwise AND/OR/NOT are identical on both types;
``(w >> j) & 1`` extracts bit ``j`` correctly although ``>>`` on int32 is
arithmetic (the sign copies only land above bit 0 after the mask).
Convert to and from numpy with ``.numpy().view(np.uint32)`` and
``np.asarray(a, np.uint32).view(np.int32)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_SHIFTS = tuple(range(32))


def words_from_u32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor holding the same 32 bits."""
    values = values.to(torch.int64)
    return torch.where(values >= (1 << 31), values - (1 << 32),
                       values).to(torch.int32)


def pack_literals(literals: torch.Tensor) -> torch.Tensor:
    """{0,1} [..., n] -> packed int32 words [..., ceil(n/32)].

    Tail bits of the last word (positions >= n) are zero.  Packed in int64
    and wrapped, because bit 31 overflows an int32 sum."""
    *lead, n = literals.shape
    pad = (-n) % 32
    bits = torch.nn.functional.pad(literals.to(torch.int64), (0, pad))
    bits = bits.reshape(*lead, (n + pad) // 32, 32)
    weights = torch.tensor([1 << s for s in _SHIFTS], dtype=torch.int64,
                           device=literals.device)
    return words_from_u32((bits * weights).sum(dim=-1))


def unpack_literals(packed: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_literals`: words [..., W] -> {0,1} int8
    [..., n_bits] (n_bits <= 32*W; tail bits are dropped)."""
    *lead, W = packed.shape
    if n_bits > 32 * W:
        raise ValueError(f"n_bits={n_bits} exceeds 32*W={32 * W}")
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(*lead, 32 * W)[..., :n_bits].to(torch.int8)


@dataclasses.dataclass(frozen=True)
class Booleanizer:
    """Fitted booleanizer: thresholds[f_raw, k] applied as raw >= cut."""

    thresholds: np.ndarray  # [f_raw, k] float32

    @property
    def n_bool_features(self) -> int:
        return int(self.thresholds.shape[0] * self.thresholds.shape[1])

    def __call__(self, raw) -> torch.Tensor:
        """raw [..., f_raw] -> Boolean features [..., f_raw*k] (0/1 int8).

        The compare runs in float32, as the JAX package's does, so a value
        near a cut lands on the same side in both packages."""
        raw = torch.as_tensor(raw).to(torch.float32)
        cuts = torch.as_tensor(np.asarray(self.thresholds, np.float32),
                               device=raw.device)
        bits = (raw[..., :, None] >= cuts).to(torch.int8)
        return bits.reshape(*raw.shape[:-1], -1)


def fit_thermometer(calib: np.ndarray, bits: int = 1) -> Booleanizer:
    """Quantile thermometer cuts from a calibration array [n, f_raw]."""
    qs = np.linspace(0.0, 1.0, bits + 2)[1:-1]
    cuts = np.quantile(calib, qs, axis=0).T.astype(np.float32)
    return Booleanizer(thresholds=np.ascontiguousarray(cuts))
